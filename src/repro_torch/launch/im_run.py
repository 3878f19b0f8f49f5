"""IMM end to end from the command line, on the port's InfluenceEngine
(``repro.launch.im_run``).

    PYTHONPATH=src python -m repro_torch.launch.im_run --graph com-Amazon \
        --scale 1.0 --k 50

Runs Algorithm 1 on a synthetic SNAP stand-in and prints one JSON line:
the reference's keys plus ``"device"``.  Runs on ``cuda`` unless
``--device cpu`` is given.  ``--select-k`` answers extra queries from the
same store; ``--store packed|compressed`` keeps the RRR sets in an IMPack
arena, ``--store indices`` as C4 index lists, and ``"arena_bytes"``
reports the arena's device bytes.  ``--snapshot-dir`` resumes from the
engine snapshot there when one exists and saves one at the end (the
reference's checkpoint format: either package resumes the other's).
``--model IC|WC|GT|LT``, ``--backend dense|sparse|pallas|walk`` and
``--sampler`` (e.g. ``"IC/pallas+stable"``, ``"LT/walk"``) pick the
sampler; graphs with n <= 4096 take the dense backend by default and LT
the walk, as in the reference.  ``--mesh`` takes an int or ``auto`` (1D
theta sharding) or ``RxC`` (theta x vertex), clipped to the devices
there are (`repro_torch.configs.imm_snap.make_im_mesh`: the CUDA cards,
or the host with ``--device cpu``); the JSON line gives the mesh's
``mesh_shards`` and ``vertex_shards``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import obs
from repro_torch.configs.imm_snap import (
    IMM_EXPERIMENTS, make_im_mesh, mesh_engine_kwargs,
)
from repro_torch.core.engine import IMMConfig, InfluenceEngine, resolve_device
from repro_torch.device import synchronize
from repro_torch.graphs.datasets import scaled_snap, synthetic_snap


def run(graph: str, *, scale: float = None, model: str = "IC", k: int = 50,
        eps: float = 0.5, baseline: bool = False, seed: int = 0,
        max_theta: int = 1 << 14, select_ks=(), snapshot_dir: str = None,
        mesh=None, backend: str = None, sampler: str = None,
        store: str = "auto", metrics_out: str = None, trace_out: str = None,
        device: str = "cuda", log=print):
    dev = resolve_device(device)
    if metrics_out or trace_out:
        obs.enable()
    exp = IMM_EXPERIMENTS[graph]
    scale = exp.bench_scale if scale is None else scale
    t0 = time.time()
    g = scaled_snap(graph, scale, seed=seed) if scale < 1.0 else \
        synthetic_snap(graph, seed=seed)
    t_graph = time.time() - t0

    cfg = IMMConfig(
        k=k, eps=eps, model=model, backend=backend, sampler=sampler,
        max_theta=max_theta, seed=seed, store=store,
        selection_method="decrement" if baseline else "rebuild",
        adaptive_representation=not baseline,
    )
    mesh = make_im_mesh(mesh, device=dev)
    kw = mesh_engine_kwargs(mesh)
    engine = InfluenceEngine(g, cfg, device=None if kw else dev, **kw)
    if snapshot_dir:
        engine.restore(snapshot_dir)       # resume if a snapshot exists
    t0 = time.time()
    res = engine.run()
    synchronize(dev)
    t_imm = time.time() - t0

    t0 = time.time()
    queries = {
        int(q): {"influence": engine.select(int(q)).influence,
                 "seeds": [int(s) for s in engine.select(int(q)).seeds[:10]]}
        for q in select_ks
    }
    t_queries = time.time() - t0

    if snapshot_dir:
        engine.snapshot(snapshot_dir)

    out = {
        "graph": graph, "scale": scale, "n": g.n, "m": g.m, "model": model,
        "sampler": engine.sampler_name,
        "k": k, "mode": "ripples-style" if baseline else "efficientimm",
        "mesh_shards": None if mesh is None else int(
            getattr(engine.store, "D", 1)),
        "vertex_shards": None if mesh is None else int(
            getattr(engine.store, "Dv", 1)),
        "influence": res.influence, "covered_frac": res.covered_frac,
        "theta": res.theta, "representation": res.representation,
        "store": engine.store.representation,
        "arena_bytes": engine.store.arena_bytes,
        "graph_s": round(t_graph, 3), "imm_s": round(t_imm, 3),
        "seeds": [int(s) for s in res.seeds[:10]],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if queries:
        out["queries"] = queries
        out["queries_s"] = round(t_queries, 3)
    if metrics_out:
        out["metrics_out"] = obs.write_metrics(metrics_out)
    if trace_out:
        out["trace_out"] = obs.write_trace(trace_out)
    log(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="com-Amazon",
                    choices=sorted(IMM_EXPERIMENTS))
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--model", default="IC", choices=("IC", "WC", "GT", "LT"))
    ap.add_argument("--backend", default=None,
                    choices=("dense", "sparse", "pallas", "walk"))
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--max-theta", type=int, default=1 << 14)
    ap.add_argument("--select-k", type=int, action="append", default=[])
    ap.add_argument("--snapshot-dir", default=None,
                    help="resume from / persist the engine store here")
    ap.add_argument("--store", default="auto",
                    choices=("auto", "bitmap", "indices", "packed",
                             "compressed", "sharded"))
    ap.add_argument("--mesh", default=None,
                    help="RRR store mesh: an int or 'auto' (1D theta "
                         "sharding), 'RxC' e.g. '2x4' (2D theta x vertex "
                         "sharding), or omit for single-device")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default) or 'cpu' (the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    run(args.graph, scale=args.scale, model=args.model, k=args.k,
        eps=args.eps, baseline=args.baseline, max_theta=args.max_theta,
        select_ks=args.select_k, snapshot_dir=args.snapshot_dir,
        mesh=args.mesh, backend=args.backend, sampler=args.sampler,
        store=args.store, metrics_out=args.metrics_out,
        trace_out=args.trace_out, device=args.device)


if __name__ == "__main__":
    main()
