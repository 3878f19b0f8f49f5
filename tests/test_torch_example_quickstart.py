"""``examples_torch/quickstart.py`` against ``examples/quickstart.py`` on
the CPU.

The graph (R-MAT, n 2,000) takes the dense sampler on both sides, whose
contract is "equal, or near-ties" (`repro_torch.core.ties`): the two
examples print the same lines (timings aside), and their results agree
exactly (seeds, influence, coverage, theta, representation, the
baseline's); should they differ, every row on which the two samplers
differ is traced and classified as a near-tie instead.
"""
import runpy

import pytest

torch = pytest.importorskip("torch")

from _examples import (  # noqa: E402,F401
    ROOT, dense_near_ties, masked, one_thread, port_example,
    same_or_near_ties,
)


def _classify(batches):
    from repro.graphs import rmat_graph as jrmat
    from repro_torch.graphs import rmat_graph

    return dense_near_ties(jrmat(n=2_000, m=16_000, seed=0),
                           rmat_graph(n=2_000, m=16_000, seed=0), "IC",
                           seed=0, batch=256, theta=256 * batches)


def test_quickstart_matches_the_reference(capsys):
    ref = runpy.run_path(f"{ROOT}/examples/quickstart.py")
    jax_lines = masked(capsys.readouterr().out)
    got = port_example("quickstart").main(["--device", "cpu"])
    port_lines = masked(capsys.readouterr().out)
    assert len(port_lines) == 5
    same_or_near_ties(jax_lines, port_lines,
                      lambda: _classify(got["theta"] // 256))
    if port_lines != jax_lines:
        return
    res, base = ref["result"], ref["baseline"]
    assert got["seeds"] == [int(v) for v in res.seeds]
    assert got["influence"] == float(res.influence)
    assert got["covered_frac"] == float(res.covered_frac)
    assert (got["theta"], got["representation"]) == (res.theta,
                                                     res.representation)
    assert got["representation"] == "bitmap"
    assert got["baseline_seeds"] == [int(v) for v in base.seeds]
    assert got["baseline_influence"] == float(base.influence)
    assert got["baseline_theta"] == base.theta


def test_quickstart_first_batch_agrees_up_to_near_ties():
    """The classifier the dense contract falls back on, run on the
    example's first batch: no row differs but by a near-tie."""
    rep = _classify(1)
    assert rep["faults"] == []
    assert rep["ties"] == rep["cells"]
