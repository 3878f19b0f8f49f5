"""End-to-end influence-maximization campaign on the InfluenceEngine.

Plans a viral campaign on a YouTube-scale synthetic network the way a real
campaign tool would: sample the RRR store ONCE per diffusion model, then
answer a whole sweep of questions from it —

  * budget sweep: best seed sets for several campaign sizes k
    (``engine.select(k)``, no re-sampling between queries);
  * what-if queries: sigma(S) for hand-picked candidate seed sets
    (``engine.influences``), batched through one fused membership kernel;
  * resumability: snapshot the sampled store, restore it in a fresh
    engine, and keep querying (``engine.snapshot``/``restore``);

and finally Monte-Carlo-validates the IC influence estimate by simulating
the diffusion forward from the chosen seeds.

``--mesh N`` (or ``auto``) runs the whole campaign against a mesh-sharded
RRR store (paper C1) — same answers, theta partitioned across the cards;
``RxC`` tiles the store over theta and vertices, clipped to the cards
there are (on one card ``2x2`` is a 1x1 mesh, still the tiled path);
on a single card ``auto`` is one shard.

    PYTHONPATH=src python examples_torch/influence_campaign.py \\
        [--mesh auto] [--device cpu]
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs.imm_snap import (
    CAMPAIGN_KS, make_im_mesh, mesh_engine_kwargs,
)
from repro_torch.core import IMMConfig, InfluenceEngine
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs.datasets import scaled_snap


def simulate_ic(graph, seeds, n_trials: int = 50, seed: int = 1):
    """Forward Monte-Carlo IC simulation (independent check of sigma(S))."""
    rng = np.random.default_rng(seed)
    src = graph.edge_src.cpu().numpy()
    dst = graph.edge_dst.cpu().numpy()
    prob = graph.in_prob.cpu().numpy()
    total = 0
    for _ in range(n_trials):
        live = rng.random(graph.m) < prob
        active = np.zeros(graph.n, bool)
        active[list(seeds)] = True
        while True:
            # forward edges whose src is active & live
            mask = live & active[src] & ~active[dst]
            nxt = np.unique(dst[mask])
            if nxt.size == 0:
                break
            active[nxt] = True
        total += active.sum()
    return total / n_trials


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default=None,
                    help="RRR store mesh: int or 'auto' (1D theta "
                         "sharding), 'RxC' e.g. '2x4' (2D theta x "
                         "vertex), or omit for single-device")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_im_mesh(args.mesh, device=dev)

    def clock() -> float:
        synchronize(dev)
        return time.perf_counter()

    print("building YouTube-scale synthetic network (replica)...")
    g = scaled_snap("com-YouTube", 0.004)
    print(f"  n={g.n:,} m={g.m:,}")
    out = {"n": g.n, "m": g.m, "shards": None, "models": {}}
    if mesh is not None:
        out["shards"] = mesh.devices.size
        print(f"  RRR store sharded over {mesh.devices.size} device(s)")

    ks = [k for k in CAMPAIGN_KS if k <= 20]
    for model in ("IC", "LT"):
        engine = InfluenceEngine(
            g, IMMConfig(k=max(ks), eps=0.5, model=model, max_theta=8192),
            **mesh_engine_kwargs(mesh), device=dev)
        t0 = clock()
        res = engine.run()
        t_solve = clock() - t0
        rec = out["models"][model] = {
            "sampler": engine.sampler_name, "theta": int(res.theta),
            "representation": res.representation, "solve_s": t_solve,
            "sweep": {}}
        print(f"\n[{model}] solved in {t_solve:.1f}s  theta={res.theta}  "
              f"rep={res.representation}")

        # --- budget sweep: every k answered from the same sampled store ---
        t0 = clock()
        for k in ks:
            sel = engine.select(k)
            seeds = [int(v) for v in sel.seeds]
            rec["sweep"][k] = {"influence": float(sel.influence),
                               "seeds": seeds}
            print(f"  k={k:>3}: influence={sel.influence:8.0f}  "
                  f"seeds={seeds[:6]}")
        rec["sweep_s"] = clock() - t0
        print(f"  (budget sweep over {len(ks)} campaign sizes: "
              f"{rec['sweep_s']:.2f}s, zero extra sampling)")

        # --- what-if: compare the solver's picks against naive candidates ---
        top = engine.select(ks[-1])
        degree_hubs = np.argsort(engine.store.counter.cpu().numpy())[-ks[-1]:]
        sigma_opt, sigma_hub = engine.influences(
            [top.seeds, degree_hubs]).tolist()
        rec["whatif"] = {"greedy": sigma_opt, "hubs": sigma_hub,
                         "hub_ids": [int(v) for v in degree_hubs]}
        print(f"  what-if: greedy seeds -> {sigma_opt:.0f}, "
              f"top-counter hubs -> {sigma_hub:.0f}")

        if model == "IC":
            mc = float(simulate_ic(g, top.seeds, n_trials=20))
            gap = abs(mc - top.influence) / max(mc, 1) * 100
            rec["monte_carlo"] = {"nodes": mc, "gap_pct": gap}
            print(f"  Monte-Carlo validation: {mc:.0f} nodes "
                  f"({gap:.1f}% gap)")

        # --- resumability: a fresh engine picks up the sampled store ---
        if model == "IC":
            with tempfile.TemporaryDirectory() as ckpt_dir:
                engine.snapshot(ckpt_dir)
                engine2 = InfluenceEngine(
                    g, IMMConfig(k=max(ks), model=model, max_theta=8192),
                    mesh=mesh, device=dev)
                engine2.restore(ckpt_dir)
                sel2 = engine2.select(ks[0])
                same = list(sel2.seeds) == list(engine.select(ks[0]).seeds)
                rec["restore"] = {"theta": int(engine2.theta),
                                  "identical": bool(same)}
                print(f"  snapshot/restore: restored theta={engine2.theta}, "
                      f"select(k={ks[0]}) identical: {same}")
    return out


if __name__ == "__main__":
    main()
