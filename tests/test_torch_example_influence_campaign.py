"""``examples_torch/influence_campaign.py`` against
``examples/influence_campaign.py`` on the CPU.

The com-YouTube replica (n 4,539) takes the sparse sampler under IC and
the walk under LT, whose contract is bitwise: the two examples print the
same lines (timings aside), and every value the port returns equals the
reference's exactly: theta, representation, each k's seeds and
influence, both what-if sigmas, the Monte-Carlo estimate and the
snapshot's restore.  The reference's engines are read through a
recording subclass of its `InfluenceEngine`.
"""
import pytest

torch = pytest.importorskip("torch")

from _examples import (  # noqa: E402,F401
    jax_example, masked, one_thread, port_example,
)


def test_influence_campaign_matches_the_reference(capsys):
    ref = jax_example("influence_campaign")
    engines = []

    class Recording(ref.InfluenceEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    ref.InfluenceEngine = Recording
    ref.main([])
    jax_lines = masked(capsys.readouterr().out)
    got = port_example("influence_campaign").main(["--device", "cpu"])
    port_lines = masked(capsys.readouterr().out)
    assert port_lines == jax_lines

    ic, ic_restored, lt = engines
    assert (got["n"], got["m"]) == (ic.graph.n, ic.graph.m)
    for model, eng in (("IC", ic), ("LT", lt)):
        rec = got["models"][model]
        assert rec["sampler"] == {"IC": "IC/sparse", "LT": "LT/walk"}[model]
        assert rec["sampler"] == eng.sampler_name
        assert (rec["theta"], rec["representation"]) == (
            eng.theta, "bitmap")
        for k, sel in rec["sweep"].items():
            want = eng.select(k)
            assert sel["seeds"] == [int(v) for v in want.seeds]
            assert sel["influence"] == float(want.influence)
        top = eng.select(max(rec["sweep"]))
        hubs = rec["whatif"]["hub_ids"]
        assert hubs == [int(v) for v in
                        ref.np.argsort(ref.np.asarray(eng.store.counter))
                        [-len(hubs):]]
        assert [rec["whatif"]["greedy"], rec["whatif"]["hubs"]] == (
            eng.influences([top.seeds, hubs]).tolist())
    mc = ref.simulate_ic(ic.graph, ic.select(20).seeds, n_trials=20)
    assert got["models"]["IC"]["monte_carlo"]["nodes"] == float(mc)
    assert got["models"]["IC"]["restore"] == {"theta": ic_restored.theta,
                                              "identical": True}

