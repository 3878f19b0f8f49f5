"""IMM experiment configs for the paper's 8 SNAP graphs (Table I / III),
as in ``repro.configs.imm_snap``: the graph stats with the paper's
hyper-parameters (k=50, eps=0.5), the benchmark shrink factor, the
dry-run, sampler-matrix and serving cells, and the mesh helpers.

``make_im_mesh`` maps a ``--mesh`` flag value — an int/"auto" (1D theta
sharding) or ``"RxC"`` (2D theta x vertex) — onto a `repro_torch.mesh.Mesh`
over ``THETA_AXIS``/``VERTEX_AXIS``, clipped to the devices available as
the reference clips to ``jax.device_count()``: the distinct CUDA cards,
or the one host device with ``device="cpu"``.  ``mesh_engine_kwargs``
turns a mesh back into the engine's ``mesh``/``theta_axes``/
``vertex_axis`` keywords.  A mesh that repeats a device (2x2 on one
card) is built on purpose with `repro_torch.mesh.Mesh`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import IMMConfig
from repro_torch.device import resolve_device
from repro_torch.graphs.datasets import SNAP_STATS
from repro_torch.mesh import Mesh

# the mesh axis the RRR-set theta dimension shards over: the ShardedStore,
# the sampler's batch placement and sharded selection key off this name
THETA_AXIS = "data"
# the mesh axis the vertex dimension shards over on 2D meshes
VERTEX_AXIS = "vertex"


def _available(device) -> list:
    """The devices a flag may spread over: every CUDA card, or the one
    host device for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_theta_mesh(shards=None, *, axis: str = THETA_AXIS, device=None):
    """Resolve a ``--mesh`` flag into a theta-sharding mesh (or None):
    ``None``/``0`` -> no mesh, ``"auto"`` -> one theta shard per
    available device, an int -> that many, clipped to the available
    count; a built `Mesh` passes through."""
    if shards in (None, 0, "0", "none"):
        return None
    if isinstance(shards, Mesh):
        return shards
    avail = _available(device)
    n = len(avail) if shards == "auto" else min(int(shards), len(avail))
    return Mesh(avail[:n], (axis,))


def make_im_mesh(spec=None, *, theta_axis: str = THETA_AXIS,
                 vertex_axis: str = VERTEX_AXIS, device=None):
    """Resolve a ``--mesh`` flag into a 1D *or* 2D influence mesh: what
    `make_theta_mesh` takes, plus ``"RxC"`` (R theta shards x C vertex
    shards) and an ``(R, C)`` tuple.  2D shapes clip to the available
    device count as the reference's do: the theta axis first, the
    vertex axis shrinks first, down to 1x1 on one device (still the
    tiled code path, same results)."""
    if spec in (None, 0, "0", "none"):
        return None
    if isinstance(spec, Mesh):
        return spec
    if isinstance(spec, str) and "x" in spec.lower():
        dt, dv = (int(p) for p in spec.lower().split("x", 1))
    elif isinstance(spec, (tuple, list)):
        dt, dv = int(spec[0]), int(spec[1])
    else:
        return make_theta_mesh(spec, axis=theta_axis, device=device)
    if dt < 1 or dv < 1:
        raise ValueError(f"mesh shape {dt}x{dv} must be >= 1x1")
    avail = _available(device)
    dt = max(min(dt, len(avail)), 1)            # theta sharding survives...
    dv = max(min(dv, len(avail) // dt), 1)      # ...the vertex axis shrinks
    return Mesh([avail[t * dv:(t + 1) * dv] for t in range(dt)],
                (theta_axis, vertex_axis))


def mesh_engine_kwargs(mesh) -> dict:
    """`InfluenceEngine` keyword arguments for a mesh from
    `make_im_mesh`: ``{}`` for None, otherwise ``mesh`` + ``theta_axes``
    (every axis that is not ``VERTEX_AXIS``), plus ``vertex_axis`` when
    the mesh carries ``VERTEX_AXIS``."""
    if mesh is None:
        return {}
    names = tuple(mesh.axis_names)
    kw = {"mesh": mesh,
          "theta_axes": tuple(a for a in names if a != VERTEX_AXIS)}
    if VERTEX_AXIS in names:
        kw["vertex_axis"] = VERTEX_AXIS
    return kw


# seed-set sizes an influence campaign sweeps against one sampled store
CAMPAIGN_KS = (5, 10, 20, 50)


@dataclasses.dataclass(frozen=True)
class IMMExperiment:
    graph: str
    n: int
    m: int
    directed: bool
    cfg_ic: IMMConfig
    cfg_lt: IMMConfig
    cfg_wc: IMMConfig
    cfg_gt: IMMConfig
    bench_scale: float        # benchmark shrink factor
    campaign_ks: tuple = CAMPAIGN_KS


def _mk(graph: str, bench_scale: float) -> IMMExperiment:
    n, m, directed = SNAP_STATS[graph]
    return IMMExperiment(
        graph=graph, n=n, m=m, directed=directed,
        cfg_ic=IMMConfig(k=50, eps=0.5, model="IC"),
        cfg_lt=IMMConfig(k=50, eps=0.5, model="LT"),
        cfg_wc=IMMConfig(k=50, eps=0.5, model="WC"),
        cfg_gt=IMMConfig(k=50, eps=0.5, model="GT"),
        bench_scale=bench_scale,
    )


IMM_EXPERIMENTS = {
    "com-Amazon":  _mk("com-Amazon", 0.01),
    "com-YouTube": _mk("com-YouTube", 0.004),
    "com-DBLP":    _mk("com-DBLP", 0.01),
    "com-LJ":      _mk("com-LJ", 0.001),
    "soc-Pokec":   _mk("soc-Pokec", 0.002),
    "as-Skitter":  _mk("as-Skitter", 0.002),
    "web-Google":  _mk("web-Google", 0.004),
    "Twitter7":    _mk("Twitter7", 0.0001),
}


# Sharded-IMM dry-run cells: (theta, n) selection problems at production
# scale (the reference's table, kept for its consumers).
IMM_DRYRUN_CELLS = {
    "imm_select_youtube_ic": {
        "n": 1_134_890, "theta": 16_384, "k": 50, "model": "IC",
        "note": "dense bitmap selection, com-YouTube scale"},
    "imm_select_lj_ic": {
        "n": 3_997_962, "theta": 8_192, "k": 50, "model": "IC",
        "note": "dense bitmap selection, com-LJ scale"},
    "imm_sample_google_ic": {
        "n": 875_713, "m": 5_105_039, "batch": 4_096, "bfs_steps": 16,
        "model": "IC", "note": "sparse frontier sampling, web-Google scale"},
}


# Sampler-matrix benchmark cells: the model x backend grid on one
# synthetic graph per size class; ``tiny`` is the smoke shape.
SAMPLER_MATRIX_CELLS = {
    "tiny":    {"n": 192, "m": 1024, "theta": 256, "batch": 128},
    "default": {"n": 1024, "m": 8192, "theta": 4096, "batch": 256},
}
SAMPLER_MATRIX_BACKENDS = ("dense", "sparse", "pallas")


# Multi-query serving cells: one resident engine store answering batched
# sigma(S) queries; ``queries`` is the coalesced batch width, ``l_pad``
# the padded seed-set length.
IM_SERVE_CELLS = {
    "imm_serve_youtube_ic": {
        "n": 1_134_890, "theta": 16_384, "queries": 256, "l_pad": 64,
        "model": "IC", "note": "batched influence queries, com-YouTube scale"},
    "imm_serve_amazon_ic": {
        "n": 334_863, "theta": 16_384, "queries": 1_024, "l_pad": 16,
        "model": "IC", "note": "high-QPS small-set queries, com-Amazon scale"},
}
