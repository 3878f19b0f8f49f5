"""``examples_torch/multi_tenant_campaign.py`` against
``examples/multi_tenant_campaign.py`` on the CPU.

The example's refresh worker is a thread, so some of what it prints
depends on when that thread runs, in the reference as in the port, and
changes from run to run: brand-b's sigma at each tick (served before or
after its repair), the cache's hit rate and the count of entries an
epoch advance invalidated.  Those are held only to the example's own
invariant, checked inside it: three queries of one seed set give one
value, cached or recomputed.  Everything else is fixed by the
reference, and compared exactly: each tick's stale rows and brand-b's
epoch, brand-a's sigma and its cache hits, the what-if sigma, the
engine share, the flood (admitted, rejected, cap), ``drained`` and the
refresh's rows and steps, brand-a's backlog.

The tenants' graphs (R-MAT, n 512) take the dense sampler; its contract
is "equal, or near-ties" (`repro_torch.core.ties`): should a fixed value
differ, every row on which the two samplers differ in brand-a's store
is traced and classified as a near-tie instead.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from _examples import (  # noqa: E402,F401
    dense_near_ties, jax_example, masked, one_thread, port_example,
    same_or_near_ties,
)

TICK = re.compile(
    r"  tick (\d+): (\d+) ops -> +(\d+) stale; brand-a sigma +([\d.]+) "
    r"\(cached (\d)/3\), brand-b sigma +[\d.]+ @epoch (\d+), "
    r"whatif +([\d.]+)$")
FLOOD = re.compile(r"flood of 100: (\d+) admitted \(cap (\d+)\), first of "
                   r"(\d+) rejections raised AdmissionError$")
STATS = re.compile(r"drained=(\w+); cache hit rate [\d.]+ \(\d+ entries "
                   r"invalidated by epoch advances\); refresh granted (\d+) "
                   r"rows over (\d+) steps, all to brand-b \(brand-a "
                   r"backlog stayed (\d+)\)$")


def _fixed(lines) -> list:
    """The values the reference fixes, parsed from the printed lines."""
    out = [lines[1]]                                   # the engine share
    for line in lines[2:]:
        for pat in (TICK, FLOOD, STATS):
            m = pat.match(line)
            if m:
                out.append(m.groups())
                break
        else:
            raise AssertionError(f"unexpected line {line!r}")
    return out


def _classify():
    from repro.graphs import rmat_graph as jrmat
    from repro_torch.graphs import rmat_graph

    return dense_near_ties(jrmat(512, 512 * 8, seed=0, weighted_ic="wc"),
                           rmat_graph(512, 512 * 8, seed=0,
                                      weighted_ic="wc"),
                           "IC", seed=0, batch=256, theta=1024)


def test_multi_tenant_campaign_matches_the_reference(capsys):
    jax_example("multi_tenant_campaign").main([])
    jax_lines = masked(capsys.readouterr().out)
    got = port_example("multi_tenant_campaign").main(["--device", "cpu"])
    port_lines = masked(capsys.readouterr().out)
    assert len(port_lines) == 8 and len(got["ticks"]) == 4
    want = _fixed(jax_lines)
    same_or_near_ties(want, _fixed(port_lines), _classify)
    if _fixed(port_lines) != want:
        return
    assert got["shared_engine"] is True
    ticks = [(str(i), str(t["ops"]), str(t["stale"]),
              f"{t['sigma_a']:.1f}", str(t["cached_a"]), str(t["epoch_b"]),
              f"{t['sigma_whatif']:.1f}")
             for i, t in enumerate(got["ticks"])]
    assert ticks == want[1:5]
    assert (str(got["admitted"]), str(got["max_pending"]),
            str(got["rejected"])) == want[5]
    assert (str(got["drained"]), str(got["rows_granted"]),
            str(got["refresh_steps"]), str(got["backlog_a"])) == want[6]
    assert got["drained"] is True
    assert got["rows_granted"] == sum(t["stale"] for t in got["ticks"])
