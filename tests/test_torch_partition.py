"""repro_torch.graphs.partition against the JAX package's
repro.graphs.partition on the same inputs: both are numpy, so every
output must be the same array (hypothesis over n, the shard count and
dst arrays drawn from a seed)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.graphs import partition as jpart  # noqa: E402
from repro_torch.graphs import partition as tpart  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = dict(n=st.integers(0, 600), shards=st.integers(1, 8),
             seed=st.integers(0, 2**31 - 1))


def _dst(n, seed):
    """A skewed dst array over ``n`` vertices (power-law-ish, as the
    balanced layout is built for)."""
    rng = np.random.default_rng(seed)
    if n == 0:
        return np.zeros(0, np.int32)
    m = int(rng.integers(0, 4 * n + 1))
    return (n * rng.random(m) ** 3).astype(np.int32)


def _same_layout(a, b):
    assert (a.n, a.shards, a.block, a.n_pad, a.bounds, a.is_equal) == (
        b.n, b.shards, b.block, b.n_pad, b.bounds, b.is_equal)
    np.testing.assert_array_equal(a.starts, b.starts)
    assert a.starts.dtype == b.starts.dtype
    np.testing.assert_array_equal(a.sizes, b.sizes)
    np.testing.assert_array_equal(a.source_cols(), b.source_cols())
    np.testing.assert_array_equal(a.padded_cols(), b.padded_cols())
    u = np.arange(a.n)
    for f in ("block_of", "local_id", "padded_col"):
        np.testing.assert_array_equal(getattr(a, f)(u), getattr(b, f)(u))


@settings(max_examples=60, deadline=None)
@given(**CASES)
def test_vertex_partitions_match_jax(n, shards, seed):
    dst = _dst(n, seed)
    _same_layout(tpart.vertex_partition(n, shards),
                 jpart.vertex_partition(n, shards))
    _same_layout(tpart.balanced_vertex_partition(n, shards, dst=dst),
                 jpart.balanced_vertex_partition(n, shards, dst=dst))
    w = np.random.default_rng(seed).random(n) + 0.5
    _same_layout(tpart.balanced_vertex_partition(n, shards, weights=w),
                 jpart.balanced_vertex_partition(n, shards, weights=w))
    for spec in (None, "equal", "balanced"):
        _same_layout(tpart.resolve_partition(spec, n, shards, dst=dst),
                     jpart.resolve_partition(spec, n, shards, dst=dst))


@settings(max_examples=60, deadline=None)
@given(**CASES)
def test_edge_slabs_and_balance_reports_match_jax(n, shards, seed):
    dst = _dst(max(n, 1), seed)
    n = max(n, 1)
    src = np.random.default_rng(seed + 1).integers(0, n, dst.shape[0])
    for balanced in (False, True):
        tp = (tpart.balanced_vertex_partition(n, shards, dst=dst)
              if balanced else None)
        jp = (jpart.balanced_vertex_partition(n, shards, dst=dst)
              if balanced else None)
        got = tpart.partition_edges_by_dst(src, dst, n, shards, tp)
        want = jpart.partition_edges_by_dst(src, dst, n, shards, jp)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert got[2] == want[2]
        assert (tpart.balance_report(dst, n, shards, tp)
                == jpart.balance_report(dst, n, shards, jp))


def test_partition_errors_match_jax():
    part = tpart.vertex_partition(10, 2)
    assert tpart.resolve_partition(part, 10, 2) is part
    for mod in (tpart, jpart):
        with pytest.raises(ValueError, match="partition is for"):
            mod.resolve_partition(mod.vertex_partition(10, 2), 10, 3)
        with pytest.raises(ValueError, match="unknown partition spec"):
            mod.resolve_partition("zigzag", 10, 2)
        with pytest.raises(ValueError, match="weights must be shape"):
            mod.balanced_vertex_partition(10, 2, weights=np.ones(3))
        with pytest.raises(ValueError, match="2 shards, expected 3"):
            mod.partition_edges_by_dst([0], [1], 10, 3,
                                       mod.vertex_partition(10, 2))


def test_partition_module_imports_no_repro():
    """The port keeps its own copy: importing it loads neither JAX nor
    the JAX package."""
    probe = ("import json, sys; import repro_torch.graphs.partition, "
             "repro_torch.graphs; print(json.dumps(sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
             "'repro'))))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    import repro_torch.graphs as tgraphs
    for name in ("VertexPartition", "balance_report",
                 "balanced_vertex_partition", "partition_edges_by_dst",
                 "resolve_partition", "vertex_partition"):
        assert getattr(tgraphs, name) is getattr(tpart, name)
