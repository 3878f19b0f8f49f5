"""``examples_torch/streaming_campaign.py`` against
``examples/streaming_campaign.py`` on the CPU.

The evolving network (R-MAT, n 768, WC weights) takes the stable dense
sampler on both sides, whose contract is "equal, or near-ties"
(`repro_torch.core.ties`): the two examples print the same lines
(timings aside: every tick's stale rows, epoch, sigmas and influence,
the cross-check, the bounded replay) and the values the port returns
equal the reference's exactly (the final campaign, the bounded stream's
capacity, theta, seeds and both sigmas, read from the reference's
engines through recording subclasses).  Should the lines differ, every
row on which the two samplers differ in the initial store is traced and
classified as a near-tie instead.
"""
import pytest

torch = pytest.importorskip("torch")

from _examples import (  # noqa: E402,F401
    dense_near_ties, jax_example, masked, one_thread, port_example,
    same_or_near_ties,
)


def _classify():
    from repro.graphs import rmat_graph as jrmat
    from repro_torch.graphs import rmat_graph

    return dense_near_ties(jrmat(768, 768 * 8, seed=0, weighted_ic="wc"),
                           rmat_graph(768, 768 * 8, seed=0,
                                      weighted_ic="wc"),
                           "IC", seed=0, batch=256, theta=2048, stable=True)


def test_streaming_campaign_matches_the_reference(capsys):
    ref = jax_example("streaming_campaign")
    streams = []

    class Recording(ref.StreamEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            streams.append(self)

    ref.StreamEngine = Recording
    ref.main([])
    jax_lines = masked(capsys.readouterr().out)
    got = port_example("streaming_campaign").main(["--device", "cpu"])
    port_lines = masked(capsys.readouterr().out)
    assert len(port_lines) == 12 and len(got["ticks"]) == 6
    same_or_near_ties(jax_lines, port_lines, _classify)
    if port_lines != jax_lines:
        return
    stream, bounded = streams
    assert got["sampler"] == stream.cfg.sampler == "IC/dense+stable"
    assert [t["epoch"] for t in got["ticks"]] == list(range(1, 7))
    assert got["identical_to_fresh"] is True
    assert got["campaign"] == [int(v) for v in stream.select(10).seeds]
    b = got["bounded"]
    sb = bounded.select(10)
    assert (b["capacity"], b["theta"]) == (bounded.store.capacity,
                                           bounded.theta)
    assert b["capacity"] <= b["cap"] == 1024
    assert b["seeds"] == [int(v) for v in sb.seeds]
    assert [b["sigma"], b["sigma_unbounded"]] == stream.influences(
        [sb.seeds, got["campaign"]]).tolist()
