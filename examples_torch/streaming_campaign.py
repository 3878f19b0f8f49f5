"""Viral campaign on an *evolving* network — the StreamEngine scenario.

A campaign team plans seed sets on a social graph that keeps changing
under them: fringe follow edges appear and disappear every tick, edge
strengths drift.  The static workflow (examples_torch/influence_campaign.py)
would re-sample the whole RRR store per change; here the `StreamEngine`
keeps the store resident and repairs only what each delta actually
staled:

  * tick loop: apply a `GraphDelta`, serve top-k + what-if queries
    immediately from the surviving rows (epoch-tagged answers), then
    `refresh` — stale rows re-sample with their original keys, so after
    the repair the store is *identical* to a fresh engine's;
  * bounded memory: the same stream under a `StorePressurePolicy` row
    cap, evicting oldest rows instead of growing — the indefinite-stream
    deployment mode;
  * the final tick cross-checks the streamed store against a from-scratch
    engine on the final graph (the equivalence invariant, live).

    PYTHONPATH=src python examples_torch/streaming_campaign.py \\
        [--ticks 6] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.engine import IMMConfig, InfluenceEngine
from repro_torch.core.store import StorePressurePolicy
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs import rmat_graph
from repro_torch.stream import StreamEngine, random_delta


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--n", type=int, default=768)
    ap.add_argument("--theta", type=int, default=2048)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def clock() -> float:
        synchronize(dev)
        return time.perf_counter()

    print(f"building evolving network (n={args.n})...")
    g = rmat_graph(args.n, args.n * 8, seed=0, weighted_ic="wc")
    cfg = IMMConfig(k=args.k, batch=256, max_theta=1 << 20, seed=0)
    stream = StreamEngine(g, cfg, device=dev)
    t0 = clock()
    stream.extend(args.theta)
    out = {"n": args.n, "theta": int(stream.theta),
           "sampler": stream.cfg.sampler, "extend_s": clock() - t0,
           "ticks": []}
    print(f"  resident store: theta={stream.theta} "
          f"(sampled in {out['extend_s']:.1f}s, "
          f"sampler={stream.cfg.sampler})")

    rng = np.random.default_rng(1)
    campaign = stream.select(args.k).seeds
    for tick in range(args.ticks):
        delta = random_delta(stream.graph, rng, inserts=4, deletes=4,
                             reweights=4, max_dst_indeg=8)
        t0 = clock()
        stale = stream.apply_delta(delta)
        # serve immediately from the survivors (degraded-fidelity answers
        # are tagged with their staleness backlog)...
        sel = stream.select(args.k)
        sigma_old = stream.influence(campaign)
        # ...then repair exactly the stale rows
        stream.refresh()
        sigma_new = stream.influence(campaign)
        dt = clock() - t0
        out["ticks"].append({
            "ops": len(delta), "stale": int(stale), "epoch": int(sel.epoch),
            "sigma_old": float(sigma_old), "sigma_new": float(sigma_new),
            "influence": float(sel.influence),
            "seeds": [int(v) for v in sel.seeds], "s": dt})
        print(f"  tick {tick}: {len(delta)} edge ops -> {stale:4d} stale "
              f"rows, epoch {sel.epoch}, sigma(campaign) "
              f"{sigma_old:7.1f} -> {sigma_new:7.1f} repaired, "
              f"select(k) influence {sel.influence:7.1f}  [{dt:.2f}s]")
        campaign = stream.select(args.k).seeds

    print("cross-checking against a from-scratch engine on the final "
          "graph...")
    fresh = InfluenceEngine(stream.graph, stream.cfg, device=dev)
    fresh.extend(stream.theta)
    same = bool(np.array_equal(fresh.select(args.k).seeds, campaign))
    out["campaign"] = [int(v) for v in campaign]
    out["identical_to_fresh"] = same
    print(f"  seed-for-seed identical: {same}")

    cap = args.theta // 2
    print(f"replaying under a max_rows={cap} memory cap...")
    bounded = StreamEngine(g, cfg, policy=StorePressurePolicy(max_rows=cap),
                           device=dev)
    bounded.extend(args.theta)
    rng = np.random.default_rng(1)
    for _ in range(args.ticks):
        bounded.apply_delta(random_delta(
            bounded.graph, rng, inserts=4, deletes=4, reweights=4,
            max_dst_indeg=8))
        bounded.refresh()
    assert bounded.store.capacity <= cap
    sb = bounded.select(args.k)
    sigma_b, sigma_u = stream.influences(
        [sb.seeds, campaign]).tolist()
    quality = sigma_b / max(sigma_u, 1e-9) * 100
    out["bounded"] = {"cap": cap, "capacity": int(bounded.store.capacity),
                      "theta": int(bounded.theta),
                      "seeds": [int(v) for v in sb.seeds],
                      "sigma": sigma_b, "sigma_unbounded": sigma_u,
                      "quality_pct": quality}
    print(f"  arena capped at {bounded.store.capacity} rows "
          f"(theta {bounded.theta}); seed quality "
          f"{quality:.1f}% of the unbounded stream's")
    return out


if __name__ == "__main__":
    main()
