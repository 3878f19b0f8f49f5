"""The streaming slice on the card against the same cells on the CPU,
bitwise (integer work and f32 compares throughout: there is no
tolerance): the stores' counter shares (`_row_contrib`: the
``coverage_matvec``, ``packed_count`` and ``token_count`` kernels) at
capacities a policy clamps to non-powers-of-two and over sparse dead-row
masks; kill, replace and compact on every store kind; the bitmap and
packed writes through ``arena_commit``; the packed ->
compressed ladder; the LT walk (positional coins through the
``uniform_draw`` kernel, stable coins); a stream's deltas and refresh;
and IMServer with its async worker.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package (from the repo root, with
``PYTHONPATH=src``: ``python -m pytest -q -m cuda
tests/test_torch_stream_cuda.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.core import sampler  # noqa: E402
from repro_torch.core.engine import IMMConfig  # noqa: E402
from repro_torch.core.store import StorePressurePolicy, make_store  # noqa
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels import coverage_matvec as cov  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packed_count as pcm  # noqa: E402
from repro_torch.launch.serve import IMServer  # noqa: E402
from repro_torch.stream import StreamEngine, random_delta  # noqa: E402

pytestmark = pytest.mark.cuda

KINDS = ("bitmap", "indices", "packed", "compressed")
KERNEL = {"bitmap": "coverage_matvec", "packed": "packed_count",
          "compressed": "token_count"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(seed, B, n, density):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((B, n)) < density).astype(np.uint8))


def _pair(kind, n, cap, seed, density=0.05, batch=256):
    """The same rows in a cuda and a cpu store under a ``max_rows`` cap."""
    out = []
    for dev in ("cuda", "cpu"):
        st = make_store(kind, n, device=dev,
                        policy=StorePressurePolicy(max_rows=cap))
        for i in range(0, cap, batch):
            st.add_batch(_rows(seed + i, min(batch, cap - i), n, density))
        out.append(st)
    return out


@functools.lru_cache(maxsize=4)
def _ragged_pair(kind, cap):
    """`_pair` for the count cells (which only read the stores)."""
    return _pair(kind, 4099 if cap > 3001 else 20_011, cap, seed=cap)


def _same_state(a, b):
    sa, sb = a.state(), b.state()
    for k in sa:
        assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k


def _masks(cap, seed):
    rng = np.random.default_rng(seed)
    last = np.zeros(cap, bool)
    last[-1] = True
    return {"none": np.zeros(cap, bool), "last": last,
            "sparse": rng.random(cap) < 0.002,
            "some": rng.random(cap) < 0.1, "all": np.ones(cap, bool)}


@pytest.mark.parametrize("kind", ["bitmap", "packed", "compressed"])
@pytest.mark.parametrize("cap", [40, 1013, 3001, 16_383])
@pytest.mark.parametrize("mask", ["none", "last", "sparse", "some", "all"])
def test_row_contrib_kernels_at_ragged_capacities(cuda, kind, cap, mask):
    dev, host = _ragged_pair(kind, cap)
    n = dev.n
    assert dev.capacity == cap
    m = _masks(cap, cap)[mask]
    ops.reset_launches()
    got = dev._row_contrib(torch.from_numpy(m).to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()[KERNEL[kind]] == 1
    assert got.dtype == torch.int32
    mc = torch.from_numpy(m).to(cuda)
    plain = {"bitmap": lambda: cov.coverage_matvec_plain(mc, dev.R).to(
                 torch.int32),
             "packed": lambda: pcm.packed_count_plain(dev.R, mc, n),
             "compressed": lambda: pcm.token_count_plain(dev.R, mc, n)}
    assert torch.equal(got, plain[kind]())
    assert torch.equal(got.cpu(), host._row_contrib(torch.from_numpy(m)))


@pytest.mark.parametrize("kind", KINDS)
def test_kill_replace_compact_cuda_equals_cpu(cuda, kind):
    dev, host = _pair(kind, 3000, 1013, seed=1, batch=128)
    rng = np.random.default_rng(2)
    for _ in range(2):
        dead = rng.random(1013) < 0.2
        assert dev.kill_rows(dead) == host.kill_rows(dead)
        _same_state(dev, host)
        slots = np.flatnonzero(dead)[:37]
        idx = np.concatenate([slots, np.full(64 - slots.size, -1)])
        fresh = _rows(3, 64, 3000, 0.1)
        dev.replace_rows(idx, fresh.to(cuda))
        host.replace_rows(idx, fresh)
        _same_state(dev, host)
        assert np.array_equal(dev.compact(), host.compact())
        _same_state(dev, host)
        dev.add_batch(_rows(4, 100, 3000, 0.05).to(cuda))
        host.add_batch(_rows(4, 100, 3000, 0.05))
        _same_state(dev, host)


@pytest.mark.parametrize("kind", ["bitmap", "packed"])
@pytest.mark.parametrize("padded", [False, True])
def test_writes_launch_arena_commit(cuda, kind, padded):
    """``add_batch`` and ``replace_rows`` (with -1 targets between the
    real ones) on a bitmap or packed store on the card: one
    ``arena_commit`` launch each, whether the rows arrive as the samplers
    emit them (bool over a padded stride) or unpadded (copied into a
    padded block first); the store equals the cpu store."""
    n = 3001
    dev = make_store(kind, n)
    host = make_store(kind, n, device="cpu")
    name = "arena_commit" if kind == "bitmap" else "arena_commit_packed"

    def on_card(r):
        if not padded:
            return r.to(cuda)
        block = torch.zeros((r.shape[0], ops.padded_width(n)),
                            dtype=torch.bool, device=cuda)[:, :n]
        block.copy_(r)
        return block
    rows, fresh = _rows(5, 100, n, 0.05), _rows(6, 4, n, 0.2)
    ops.reset_launches()
    dev.add_batch(on_card(rows))
    host.add_batch(rows)
    dead = np.zeros(dev.capacity, bool)
    dead[[3, 50, 99]] = True
    assert dev.kill_rows(dead) == host.kill_rows(dead) == 3
    idx = np.asarray([50, -1, 3, -1])
    dev.replace_rows(idx, on_card(fresh))
    host.replace_rows(idx, fresh)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == 2
    _same_state(dev, host)


def test_ladder_morph_on_the_card(cuda):
    n = 20_000
    out = []
    for d in ("cuda", "cpu"):
        st = make_store("packed", n, device=d, policy=StorePressurePolicy(
            max_bytes=300 * 2500, ladder=("compressed",)))
        for s in range(3):
            st.add_batch(_rows(10 + s, 128, n, 0.0005))
        out.append(st)
    assert out[0].representation == "compressed"
    _same_state(*out)


@pytest.mark.parametrize("stable", [False, True])
def test_lt_walk_cuda_equals_cpu(cuda, stable):
    g = generators.rmat_graph(20_000, 160_000, seed=1)
    name = "LT/walk+stable" if stable else "LT/walk"
    cfg = IMMConfig(batch=256)
    ops.reset_launches()
    dev = sampler.get_sampler(name)(g.to(cuda), cfg)(prng.PRNGKey(3))
    launches = ops.launch_counts().get("uniform_draw", 0)
    assert launches == 0 if stable else launches > 0
    host = sampler.get_sampler(name)(g, cfg)(prng.PRNGKey(3))
    for a, b in zip(dev, host):
        assert torch.equal(a.cpu(), b)
    if stable:
        pos = np.asarray([0, 17, 255], np.int32)
        s = sampler.get_sampler(name)
        a = s(g.to(cuda), cfg)(prng.PRNGKey(3), positions=pos)[0]
        assert torch.equal(a.cpu(), host[0][torch.from_numpy(pos).long()])


@pytest.mark.parametrize("kind", ["packed", "bitmap"])
def test_stream_cuda_equals_cpu(cuda, kind):
    g = generators.rmat_graph(4096, 32_768, seed=5)
    cfg = IMMConfig(k=10, batch=256, seed=2, store=kind,
                    sampler="LT/walk+stable")
    streams = [StreamEngine(g, cfg, device=d) for d in ("cuda", "cpu")]
    for s in streams:
        s.extend(2048)
    rngs = [np.random.default_rng(9) for _ in streams]
    for _ in range(3):
        stale = [s.apply_delta(random_delta(s.graph, r, inserts=32,
                                            deletes=32, reweights=32,
                                            max_dst_indeg=8))
                 for s, r in zip(streams, rngs)]
        assert stale[0] == stale[1]
        _same_state(streams[0].store, streams[1].store)
        assert [s.refresh(256) for s in streams][0] == streams[1].stale
    for s in streams:
        s.refresh()
    _same_state(streams[0].store, streams[1].store)
    a, b = (s.select(10) for s in streams)
    assert list(a.seeds) == list(b.seeds)


def test_imserver_async_worker_on_the_card(cuda):
    g = generators.rmat_graph(4096, 32_768, seed=6)
    cfg = IMMConfig(k=8, batch=256, seed=4, store="packed",
                    sampler="LT/walk+stable")
    answers = []
    for async_refresh in (False, True):
        s = StreamEngine(g, cfg, device="cuda")
        s.extend(2048)
        rng = np.random.default_rng(3)
        with IMServer(s, refresh_budget=128,
                      async_refresh=async_refresh) as server:
            probe = server.select(8).seeds
            for _ in range(3):
                server.apply_delta(random_delta(s.graph, rng, inserts=16,
                                                deletes=16, reweights=16))
                t = [server.submit(probe) for _ in range(3)]
                got = server.flush()
                assert got[t[0]] == got[t[1]] == got[t[2]]
            assert server.drain(timeout=120.0)
            answers.append((server.influence(probe),
                            s.store.counter.cpu(), list(s.select(8).seeds)))
    (a, ca, sa), (b, cb, sb) = answers
    assert a == b and torch.equal(ca, cb) and sa == sb
