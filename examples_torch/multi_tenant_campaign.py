"""Two campaigns, one serving tier — the IMServe multi-tenant scenario.

A brand team runs a *static* influence campaign (fixed network, heavy
dashboard traffic re-asking the same seed sets) while a second team runs
a *streaming* campaign on an evolving network (follow edges churn every
tick).  Instead of one server per team, both register as tenants of a
single `IMServe` tier and get the shared-deployment behaviours:

  * **admission control** — a dashboard flood past the tenant's
    ``max_pending`` cap is rejected at the door, not queued into
    everyone's latency;
  * **DRR fairness** — the flooding tenant cannot starve the other:
    every scheduling round serves each backlogged tenant its weighted
    share, as one fused sigma(S) kernel call;
  * **epoch-keyed result cache** — repeated dashboard queries hit the
    ``(tenant, epoch, frozenset(S))`` cache and return bitwise-identical
    answers for free; the streaming tenant's entries die the moment its
    served epoch advances past a delta;
  * **SLO-aware refresh** — one global repair budget flows to the tenant
    whose graph actually changed (the static tenant never has backlog);
  * **engine pools** — a third what-if tenant plans against the *same*
    network as the static campaign via ``share_engine_with``: no second
    store is sampled, but its admission queue, fairness share, and cache
    namespace stay its own.

    PYTHONPATH=src python examples_torch/multi_tenant_campaign.py \\
        [--ticks 4] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.engine import IMMConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs import rmat_graph
from repro_torch.serve import AdmissionError, IMServe, TenantSpec
from repro_torch.stream import random_delta


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--theta", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"registering tenants (n={args.n}, theta={args.theta})...")
    cfg = IMMConfig(k=args.k, batch=256, max_theta=1 << 20, seed=0)
    t0 = time.perf_counter()
    tier = IMServe(quantum=8, refresh_budget=256, device=dev)
    tier.register(TenantSpec(
        "brand-a", graph=rmat_graph(args.n, args.n * 8, seed=0,
                                    weighted_ic="wc"),
        cfg=cfg, theta=args.theta, weight=1.0, max_pending=32))
    tier.register(TenantSpec(
        "brand-b", graph=rmat_graph(args.n, args.n * 8, seed=1,
                                    weighted_ic="wc"),
        cfg=cfg, theta=args.theta, streaming=True, weight=2.0))
    # what-if analysts share brand-a's engine slot: same store, own
    # admission queue / fairness share / cache namespace
    tier.register(TenantSpec("whatif-a", share_engine_with="brand-a",
                             weight=0.5))
    synchronize(dev)
    shared = (tier.tenants["whatif-a"].engine
              is tier.tenants["brand-a"].engine)
    out = {"register_s": time.perf_counter() - t0, "shared_engine": shared,
           "ticks": []}
    print(f"  3 tenants up in {out['register_s']:.1f}s "
          f"(whatif-a shares brand-a's engine: {shared})")

    rng = np.random.default_rng(2)
    camp_a = np.asarray(tier.select("brand-a", args.k).seeds)
    camp_b = np.asarray(tier.select("brand-b", args.k).seeds)
    out["camp_a"] = [int(v) for v in camp_a]
    out["camp_b"] = [int(v) for v in camp_b]

    with tier:
        tier.start_refresh_worker()
        for tick in range(args.ticks):
            # brand-b's network churns; its epoch advances mid-traffic
            delta = random_delta(tier.tenants["brand-b"].graph, rng,
                                 inserts=4, deletes=4, reweights=4,
                                 max_dst_indeg=8)
            stale = tier.apply_delta("brand-b", delta)

            # brand-a's dashboard re-asks the same seed set (cache food),
            # brand-b asks post-delta, whatif-a probes a variation
            ta = [tier.submit("brand-a", camp_a) for _ in range(3)]
            tb = tier.submit("brand-b", camp_b)
            tw = tier.submit("whatif-a", camp_a[: args.k // 2])
            tier.flush()
            ra = [tier.result(t) for t in ta]
            rb, rw = tier.result(tb), tier.result(tw)
            assert len({r.value for r in ra}) == 1   # hits == recompute
            cached = sum(r.cached for r in ra)
            out["ticks"].append({
                "ops": len(delta), "stale": int(stale),
                "sigma_a": float(ra[0].value), "cached_a": int(cached),
                "sigma_b": float(rb.value), "epoch_b": int(rb.epoch),
                "sigma_whatif": float(rw.value)})
            print(f"  tick {tick}: {len(delta)} ops -> {stale:3d} stale; "
                  f"brand-a sigma {ra[0].value:7.1f} "
                  f"(cached {cached}/3), "
                  f"brand-b sigma {rb.value:7.1f} @epoch {rb.epoch}, "
                  f"whatif {rw.value:6.1f}")
        drained = tier.drain(timeout=60.0)

    # admission control: a dashboard flood bounces off brand-a's cap
    admitted = rejected = 0
    try:
        for _ in range(100):
            tier.submit("brand-a", camp_a)
            admitted += 1
    except AdmissionError:
        rejected = 100 - admitted
    tier.flush()
    cap = tier.tenants["brand-a"].spec.max_pending
    print(f"flood of 100: {admitted} admitted (cap "
          f"{cap}), first of "
          f"{rejected} rejections raised AdmissionError")

    s = tier.stats()
    print(f"drained={drained}; cache hit rate "
          f"{s['cache']['hit_rate']:.2f} "
          f"({s['cache']['invalidations']} entries invalidated by epoch "
          f"advances); refresh granted {s['refresh']['rows_granted']} "
          f"rows over {s['refresh']['steps']} steps, all to brand-b "
          f"(brand-a backlog stayed "
          f"{s['tenants']['brand-a']['backlog']})")
    out.update(
        admitted=admitted, rejected=rejected, max_pending=cap,
        drained=bool(drained), hit_rate=float(s["cache"]["hit_rate"]),
        invalidations=int(s["cache"]["invalidations"]),
        rows_granted=int(s["refresh"]["rows_granted"]),
        refresh_steps=int(s["refresh"]["steps"]),
        backlog_a=int(s["tenants"]["brand-a"]["backlog"]))
    return out


if __name__ == "__main__":
    main()
