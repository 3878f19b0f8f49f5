"""Each family's cell step (``repro_torch.launch.steps``) at smoke width,
held to the reference's step (``repro.launch.steps``) jitted with its
shardings on a 1x1 ``jax.make_mesh`` of the one CPU device.

Both packages build the cell from the arch's ``smoke_config`` (an LM's
under its full config's name, which the policy tables key on) and a small
`ShapeDef`, through their ``_build_*_cell``; the registries are not
edited.  Inputs are numpy draws from a seed, parameters go through the
converters.  Tolerances: LM 1e-4 in float32 (tokens equal; one bf16 ulp
for a bf16 cache, bf16 moments and the gradient norm of a microbatched
step, whose gradients are accumulated in bf16); GNN
``1e-4 * (1 + |ref|)``; FM ``4e-6`` times a logit's magnitude (``|b| +
sum |w| + (sum |v|)^2``, the bound of its f32 rounding, `PERF.md` §6), the
FM serving cell on a 2x2 mesh bitwise its 1x1 run; IMM exact.  A train
cell takes two steps; the port's step updates its state in place, the
reference's returns a new one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from _gnn_ref import close, close_trees  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe_sharded as j_moe_sharded  # noqa: E402
from repro.models.transformer import init_lm as j_init_lm  # noqa: E402
from repro.models.recsys.fm import init_fm as j_init_fm  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    fm_params_from_jax, gnn_params_from_jax, lm_params_from_jax,
)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe_sharded  # noqa: E402
from repro_torch.models.gnn import graphcast  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

LM_TOL = 1e-4
GNN_TOL = 1e-4
FM_TOL = 4e-6
#: one bf16 ulp, relative: a bf16 cache, or a norm of gradients that a
#: microbatched step accumulates in bf16
BF16_TOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_thread_and_moe_mesh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = (moe_sharded.MESH, j_moe_sharded.MESH)
    yield
    moe_sharded.MESH, j_moe_sharded.MESH = saved
    torch.set_num_threads(threads)


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _mesh(shape=(1, 1)):
    return Mesh([["cpu"] * shape[1]] * shape[0], ("data", "model"))


def _smoke(package_get_arch, arch_id, shape_name, dims):
    arch = package_get_arch(arch_id)
    cfg = arch.smoke_config
    if arch.family == "lm":
        cfg = dataclasses.replace(cfg, name=arch.config.name)
    return (dataclasses.replace(arch, config=cfg),
            dataclasses.replace(arch.shape(shape_name), dims=dims))


def _cells(arch_id, shape_name, dims, mesh_shape=(1, 1)):
    """``(port cell, reference cell, jax mesh)`` at smoke width."""
    family = get_arch(arch_id).family
    build = {"lm": "_build_lm_cell", "gnn": "_build_gnn_cell",
             "recsys": "_build_fm_cell"}[family]
    jmesh = _jmesh()
    ref = getattr(jsteps, build)(*_smoke(jget_arch, arch_id, shape_name,
                                         dims), jmesh)
    cell = getattr(steps, build)(*_smoke(get_arch, arch_id, shape_name,
                                         dims), _mesh(mesh_shape))
    return cell, ref, jmesh


def _ref_step(ref, jmesh):
    with jax.set_mesh(jmesh):
        f = jax.jit(ref.step_fn, in_shardings=ref.in_shardings,
                    out_shardings=ref.out_shardings)

    def run(*args):
        with jax.set_mesh(jmesh):
            return jax.tree.map(np.asarray, f(*args))
    return run


def _t(tree):
    """A numpy tree as host tensors (dicts, lists and tuples kept)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _train_both(cell, ref, jmesh, jstate, port_params, batch, tol,
                opt_cfg, norm_tol=None):
    """Two steps of each; the state and metrics after each held to the
    reference's."""
    run = _ref_step(ref, jmesh)
    state = {"params": port_params, "opt": adamw_init(port_params, opt_cfg)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    pbatch = _t(batch)
    losses = []
    for _ in range(2):
        jstate, jmetrics = run(jstate, jbatch)
        state, metrics = cell.step_fn(state, pbatch)
        close(metrics["loss"], jmetrics["loss"], tol)
        close(metrics["grad_norm"], jmetrics["grad_norm"], norm_tol or tol)
        close_trees(state["params"], jstate["params"], tol)
        mu_bf16 = opt_cfg.moment_dtype == "bfloat16"
        close_trees(state["opt"]["mu"], jstate["opt"]["mu"],
                    BF16_TOL if mu_bf16 else tol)
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[0] != losses[1]


# -------------------------------------------------------------- LM cells --

def _lm_params(arch_id, cell_cfg, seed=0):
    jp = _np(jax.jit(j_init_lm, static_argnums=1)(
        jax.random.PRNGKey(seed), cell_cfg))
    return jp, lm_params_from_jax(jp, device="cpu")


def _ref_cfg(ref):
    """The reference cell's config, as its step closes over it."""
    for c in ref.step_fn.__closure__ or ():
        v = c.cell_contents
        if dataclasses.is_dataclass(v) and hasattr(v, "n_layers"):
            return v
    raise AssertionError("no config in the reference step's closure")


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch_id,B,mbs", [
    ("qwen1.5-0.5b", 4, 1),              # dense, one microbatch
    ("grok-1-314b", 2, 2),               # MoE tpe on the mesh, "auto" = B
    ("moonshot-v1-16b-a3b", 8, 8),       # MoE ep on the mesh, 8 slices
])
def test_lm_train_step_matches_jax(arch_id, B, mbs):
    cell, ref, jmesh = _cells(arch_id, "train_4k",
                              {"seq_len": 16, "global_batch": B})
    assert cell.note == ref.note == (
        f"policy={steps.sh.LM_POLICY[arch_id]} microbatches={mbs}")
    cfg = _ref_cfg(ref)
    jp, tp = _lm_params(arch_id, cfg)
    # the MoE cells keep bf16 moments, as the reference's cells do
    moments = "bfloat16" if cfg.n_experts else "float32"
    toks = _tokens(cfg, B, 16)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": j_adamw_init(jax.tree.map(jnp.asarray, jp),
                                  JAdamW(moment_dtype=moments))}
    _train_both(cell, ref, jmesh, jstate, tp,
                {"tokens": toks, "labels": labels}, LM_TOL,
                AdamWConfig(moment_dtype=moments),
                norm_tol=BF16_TOL if mbs > 1 else None)


def test_lm_train_microbatches_2_on_a_dense_model_matches_jax():
    """`make_lm_train_step`'s bf16 accumulation over two slices, dense."""
    from repro.launch.steps import make_lm_train_step as j_make
    cfg_j = dataclasses.replace(jget_arch("qwen1.5-0.5b").smoke_config)
    cfg_t = dataclasses.replace(get_arch("qwen1.5-0.5b").smoke_config)
    jp, tp = _lm_params("qwen1.5-0.5b", cfg_j, seed=3)
    toks = _tokens(cfg_j, 4, 16, seed=4)
    labels = np.concatenate([toks[:, 1:], -np.ones((4, 1), np.int32)], 1)
    jstep = jax.jit(j_make(cfg_j, JAdamW(), 2))
    step = steps.make_lm_train_step(cfg_t, AdamWConfig(), 2)
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": j_adamw_init(jax.tree.map(jnp.asarray, jp), JAdamW())}
    state = {"params": tp, "opt": adamw_init(tp, AdamWConfig())}
    batch = {"tokens": toks, "labels": labels}
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    state, m = step(state, _t(batch))
    close(m["loss"], np.asarray(jm["loss"]), LM_TOL)
    close(m["grad_norm"], np.asarray(jm["grad_norm"]), BF16_TOL)
    close_trees(state["params"], _np(jstate["params"]), LM_TOL)


@pytest.mark.parametrize("arch_id,S,B", [
    ("qwen1.5-0.5b", 16, 2),             # dense whole-sequence prefill
    ("grok-1-314b", 4096, 1),            # chunked prefill, two chunks
])
def test_lm_prefill_step_matches_jax(arch_id, S, B):
    cell, ref, jmesh = _cells(arch_id, "prefill_32k",
                              {"seq_len": S, "global_batch": B})
    assert cell.note == ref.note
    cfg = _ref_cfg(ref)
    jp, tp = _lm_params(arch_id, cfg)
    toks = _tokens(cfg, B, S)
    jlogits, jcache = _ref_step(ref, jmesh)(jax.tree.map(jnp.asarray, jp),
                                            jnp.asarray(toks))
    logits, cache = cell.step_fn(tp, torch.from_numpy(toks))
    close(logits, jlogits, LM_TOL)
    kv_tol = BF16_TOL if cache["k"].dtype == torch.bfloat16 else LM_TOL
    close(cache["k"], jcache["k"], kv_tol)
    close(cache["v"], jcache["v"], kv_tol)
    assert int(cache["len"]) == int(jcache["len"]) == S


@pytest.mark.parametrize("arch_id", ["h2o-danube-3-4b", "minicpm-2b"])
def test_lm_decode_step_matches_jax(arch_id):
    S, B = 24, 2
    cell, ref, jmesh = _cells(arch_id, "decode_32k",
                              {"seq_len": S, "global_batch": B})
    cfg = _ref_cfg(ref)
    cache_len = cfg.window if cfg.window > 0 else S
    assert tuple(cell.input_specs[1]["k"].shape)[3] == cache_len
    jp, tp = _lm_params(arch_id, cfg)
    rng = np.random.default_rng(2)
    kv = (cfg.n_layers, B, cfg.n_kv_heads, cache_len, cfg.head_dim)
    k = rng.normal(size=kv).astype(jnp.bfloat16)
    v = rng.normal(size=kv).astype(jnp.bfloat16)
    toks = _tokens(cfg, B, 1, seed=3)
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v),
              "len": jnp.int32(S - 1)}
    jnext, jc = _ref_step(ref, jmesh)(jax.tree.map(jnp.asarray, jp), jcache,
                                      jnp.asarray(toks))
    cache = {"k": _t(k), "v": _t(v), "len": torch.tensor(S - 1)}
    nxt, c = cell.step_fn(tp, cache, torch.from_numpy(toks))
    assert np.array_equal(nxt.numpy(), jnext)
    close(c["k"], jc["k"], LM_TOL)
    close(c["v"], jc["v"], LM_TOL)
    assert int(c["len"]) == int(jc["len"]) == S


# ------------------------------------------------------------- GNN cells --

def _gnn_init(arch_id, cfg, seed=0):
    import repro.models.gnn as jg
    init = {"graphcast": jg.graphcast.init_graphcast,
            "equiformer-v2": jg.equiformer.init_equiformer,
            "egnn": jg.egnn.init_egnn,
            "graphsage-reddit": jg.graphsage.init_sage}[arch_id]
    jp = _np(jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))
    return jp, gnn_params_from_jax(jp, device="cpu")


def _gnn_state(arch_id, ref):
    cfg = _ref_cfg(ref)
    jp, tp = _gnn_init(arch_id, cfg)
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": j_adamw_init(jax.tree.map(jnp.asarray, jp), JAdamW())}
    return cfg, jstate, tp


GRAPH = {"n_nodes": 24, "n_edges": 64, "d_feat": 8, "n_classes": 5}


@pytest.mark.parametrize("arch_id,shape_name,dims", [
    ("graphsage-reddit", "minibatch_lg",
     {"batch_nodes": 4, "fanout": (3, 2), "d_feat": 12, "n_classes": 5}),
    ("graphsage-reddit", "full_graph_sm", GRAPH),
    ("egnn", "molecule", {"n_nodes": 6, "n_edges": 10, "batch": 3}),
    ("equiformer-v2", "full_graph_sm", GRAPH),
    # over 100,000 edges: the edge-chunked scan, four chunks
    ("equiformer-v2", "full_graph_sm", dict(GRAPH, n_nodes=256,
                                            n_edges=100_004)),
])
def test_gnn_train_step_matches_jax(arch_id, shape_name, dims):
    cell, ref, jmesh = _cells(arch_id, shape_name, dims)
    assert cell.note == ref.note
    chunked = cell.note.endswith("edge-chunked scan")
    assert chunked == (dims.get("n_edges", 0) > 100_000)
    if chunked:
        assert tuple(cell.input_specs[1][2].shape) == (4, 25_001)
    cfg, jstate, tp = _gnn_state(arch_id, ref)
    rng = np.random.default_rng(5)
    batch = []
    for spec in ref.input_specs[1]:
        if spec.dtype == jnp.int32:
            hi = (cfg.n_classes if spec.ndim == 1 and spec.shape[0] in (
                dims.get("batch_nodes"), dims.get("n_nodes")) and
                arch_id == "graphsage-reddit" else ref.input_specs[1][0]
                .shape[0])
            batch.append(rng.integers(0, hi, spec.shape).astype(np.int32))
        else:
            batch.append(rng.normal(size=spec.shape).astype(np.float32))
    _train_both(cell, ref, jmesh, jstate, tp, tuple(batch), GNN_TOL,
                AdamWConfig())


#: a shape whose graph has over 1 M edges: the large cells' config
BIG = {"n_nodes": 1_000, "n_edges": 2_000_000, "fanout": (15, 10),
       "d_feat": 8, "n_classes": 5}


@pytest.mark.parametrize("arch_id,batch_nodes", [
    ("graphcast", 4),          # 664 nodes, 660 edges
    ("equiformer-v2", 640),    # 106,240 nodes, 105,600 edges: 4 chunks
])
def test_gnn_bf16_cell_matches_jax(arch_id, batch_nodes):
    """The config that the large graphs' cells take (over 1 M edges in
    the shape): bf16 latents, with GraphCast's remat group of four layers
    (dst-partitioned) and Equiformer's channel axis and edge-chunked scan,
    at smoke width.  The sampled edges go into distinct nodes, so that no
    bf16 sum adds two messages (`tests/test_torch_gnn.py`'s
    `test_graphcast_bf16_latents_match_jax` says why); two steps, each's
    loss, gradient norm and parameters within ``BF16_TOL * (1 + |ref|)``
    of the reference's."""
    from _gnn_ref import BF16_TOL

    dims = dict(BIG, batch_nodes=batch_nodes)

    def smoke(package_get_arch):
        arch = package_get_arch(arch_id)
        cfg = arch.smoke_config
        if arch_id == "graphcast":
            cfg = dataclasses.replace(cfg, n_layers=4)
        return (dataclasses.replace(arch, config=cfg),
                dataclasses.replace(arch.shape("minibatch_lg"), dims=dims))

    jmesh = _jmesh()
    ref = jsteps._build_gnn_cell(*smoke(jget_arch), jmesh)
    cell = steps._build_gnn_cell(*smoke(get_arch), _mesh())
    assert cell.note == ref.note
    cfg, jstate, tp = _gnn_state(arch_id, ref)
    assert cfg.dtype == "bfloat16"
    assert getattr(cfg, "remat_group", 4) == 4
    assert getattr(cfg, "channel_axis", "model") == "model"
    specs = ref.input_specs[1]
    n = specs[0].shape[0]
    e_shape = specs[2].shape
    e = int(np.prod(e_shape))
    rng = np.random.default_rng(7)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.permutation(n)[:e].astype(np.int32)
    if arch_id == "graphcast":
        ef = rng.normal(size=(e, cfg.d_edge_in)).astype(np.float32)
        nf = rng.normal(size=(n, dims["d_feat"])).astype(np.float32)
        batch = (nf, ef, src, dst, nf)
    else:
        assert cell.note.endswith("edge-chunked scan") and len(e_shape) == 2
        batch = (rng.normal(size=specs[0].shape).astype(np.float32),
                 rng.normal(size=(n, 3)).astype(np.float32),
                 src.reshape(e_shape), dst.reshape(e_shape),
                 rng.normal(size=specs[4].shape).astype(np.float32))
    _train_both(cell, ref, jmesh, jstate, tp, batch, BF16_TOL,
                AdamWConfig())


def _graphcast_batch(cell, n, e, F, d_edge, n_dp, n_tp, seed=6):
    """A graph balanced over ``n_dp`` dst blocks, in the layout a cell on
    an ``n_dp x n_tp`` mesh reads, and the same logical graph."""
    gen = torch.Generator().manual_seed(seed)
    src, dst = steps.graphcast_edges(gen, n, e, n_dp)
    rng = np.random.default_rng(seed)
    nf = rng.normal(size=(n, F)).astype(np.float32)
    ef = rng.normal(size=(e, d_edge)).astype(np.float32)
    tg = rng.normal(size=(n, F)).astype(np.float32)
    pef, pes, ped = graphcast.partition_edges(
        src, dst, torch.from_numpy(ef), n, n_dp, n_tp)
    logical = (nf, ef, src.numpy().astype(np.int32),
               dst.numpy().astype(np.int32), tg)
    laid = (torch.from_numpy(nf), pef, pes.to(torch.int32),
            ped.to(torch.int32), torch.from_numpy(tg))
    return logical, laid


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_graphcast_dst_partitioned_train_step_matches_jax(mesh_shape):
    """The port's cell on a 1x1 and a 2x2 mesh of the host, the edges laid
    out by dst block for each, against the reference's 1x1 cell."""
    cell, ref, jmesh = _cells("graphcast", "full_graph_sm", GRAPH,
                              mesh_shape)
    cfg, jstate, tp = _gnn_state("graphcast", ref)
    n, e = ref.input_specs[1][0].shape[0], ref.input_specs[1][2].shape[0]
    logical, laid = _graphcast_batch(cell, n, e, GRAPH["d_feat"],
                                     cfg.d_edge_in, *mesh_shape)
    run = _ref_step(ref, jmesh)
    state = {"params": tp, "opt": adamw_init(tp, AdamWConfig())}
    jb = jax.tree.map(jnp.asarray, logical)
    for _ in range(2):
        jstate, jm = run(jstate, jb)
        state, m = cell.step_fn(state, laid)
        close(m["loss"], jm["loss"], GNN_TOL)
        close(m["grad_norm"], jm["grad_norm"], GNN_TOL)
        close_trees(state["params"], jstate["params"], GNN_TOL)


# -------------------------------------------------------------- FM cells --

def _fm_inputs(cfg, seed=0):
    jp = _np(jax.jit(j_init_fm, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    jp = {"v": jp["v"],
          "w": (rng.normal(size=jp["w"].shape) * 0.01).astype(np.float32),
          "b": np.float32(rng.normal() * 0.1)}
    return jp, fm_params_from_jax(jp, device="cpu")


def _fm_mag(p, rows):
    v, w = np.abs(p["v"]).astype(np.float64), np.abs(p["w"])
    return (abs(float(p["b"])) + w[rows].sum(-1)
            + (v[rows].sum(-2) ** 2).sum(-1))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_fm_serve_step_matches_jax(mesh_shape):
    B = 8
    cell, ref, jmesh = _cells("fm", "serve_p99", {"batch": B}, mesh_shape)
    cfg = get_arch("fm").smoke_config
    jp, tp = _fm_inputs(cfg)
    idx = np.random.default_rng(3).integers(
        0, cfg.vocab_per_field, (B, cfg.n_sparse)).astype(np.int32)
    want = _ref_step(ref, jmesh)(jp["v"], jp["w"], jp["b"], idx)
    got = cell.step_fn(tp["v"], tp["w"], tp["b"], torch.from_numpy(idx))
    rows = idx + cfg.field_offsets().numpy()[None, :].astype(np.int32)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= FM_TOL * _fm_mag(jp, rows)).all()
    one, _, _ = _cells("fm", "serve_p99", {"batch": B})
    base = one.step_fn(tp["v"], tp["w"], tp["b"], torch.from_numpy(idx))
    assert torch.equal(got, base)        # each row on one tile: bitwise


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_fm_retrieval_step_matches_jax(mesh_shape):
    C = 16
    cell, ref, jmesh = _cells("fm", "retrieval_cand",
                              {"batch": 1, "n_candidates": C}, mesh_shape)
    cfg = get_arch("fm").smoke_config
    jp, tp = _fm_inputs(cfg, seed=2)
    rng = np.random.default_rng(4)
    user = rng.integers(0, cfg.vocab_per_field, 4).astype(np.int32)
    cand = rng.integers(0, cfg.total_rows, C).astype(np.int32)
    want = _ref_step(ref, jmesh)(jp["v"], jp["w"], jp["b"], user, cand)
    got = cell.step_fn(tp["v"], tp["w"], tp["b"], torch.from_numpy(user),
                       torch.from_numpy(cand))
    urows = user + cfg.field_offsets().numpy()[:4].astype(np.int32)
    v, w = np.abs(jp["v"]).astype(np.float64), np.abs(jp["w"])
    mag = (abs(float(jp["b"])) + w[urows].sum() + w[cand]
           + (v[urows].sum(0) ** 2).sum() + v[cand] @ v[urows].sum(0))
    assert (np.abs(got.numpy() - want) <= FM_TOL * mag).all()


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_fm_train_step_matches_jax(mesh_shape):
    B = 16
    cell, ref, jmesh = _cells("fm", "train_batch", {"batch": B}, mesh_shape)
    cfg = get_arch("fm").smoke_config
    jp, tp = _fm_inputs(cfg, seed=5)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, cfg.vocab_per_field,
                       (B, cfg.n_sparse)).astype(np.int32)
    labels = rng.integers(0, 2, B).astype(np.float32)
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": j_adamw_init(jax.tree.map(jnp.asarray, jp), JAdamW())}
    _train_both(cell, ref, jmesh, jstate, tp, (idx, labels), FM_TOL,
                AdamWConfig())


# ------------------------------------------------------------- IMM cells --

def test_imm_select_cell_matches_jax_exactly():
    spec = {"n": 50, "theta": 96, "k": 6, "model": "IC"}
    jmesh = _jmesh()
    ref = jsteps.build_imm_cell("imm_select_youtube_ic", spec, jmesh)
    gen = torch.Generator().manual_seed(7)
    R = steps.imm_rows(gen, 96, 50, 48, per_row=5)
    valid = torch.rand(96, generator=gen) < 0.9
    want = _ref_step(ref, jmesh)(R.numpy(), valid.numpy())
    for shape in ((1, 1), (2, 2)):
        cell = steps.build_imm_cell("imm_select_youtube_ic", spec,
                                    _mesh(shape))
        n = cell.input_specs[0].shape[1]
        Rp = torch.zeros((96, n), dtype=torch.uint8)
        Rp[:, :50] = R
        seeds, frac, gains = cell.step_fn(Rp, valid)
        assert np.array_equal(seeds.numpy(), want[0])
        assert np.array_equal(gains.numpy(), want[2])
        assert float(frac) == float(want[1])


def test_imm_sample_cell_matches_jax_exactly():
    spec = {"n": 40, "m": 120, "batch": 8, "bfs_steps": 4, "model": "IC"}
    jmesh = _jmesh()
    ref = jsteps.build_imm_cell("imm_sample_google_ic", spec, jmesh)
    cell = steps.build_imm_cell("imm_sample_google_ic", spec, _mesh())
    rng = np.random.default_rng(8)
    src = rng.integers(0, 40, 120).astype(np.int32)
    dst = rng.integers(0, 40, 120).astype(np.int32)
    prob = rng.uniform(0, 0.5, 120).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(11))
    want = _ref_step(ref, jmesh)(key, src, dst, prob)
    got = cell.step_fn(torch.from_numpy(key.astype(np.uint32)),
                       *(torch.from_numpy(a) for a in (src, dst, prob)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_cell_inputs_have_the_cell_shapes():
    """``make_inputs`` draws every input at its spec's shape and dtype."""
    cases = [("fm", "serve_p99", {"batch": 8}),
             ("graphcast", "full_graph_sm", GRAPH),
             ("qwen1.5-0.5b", "decode_32k",
              {"seq_len": 12, "global_batch": 2})]
    for arch_id, shape_name, dims in cases:
        for shape in ((1, 1), (2, 2)):
            cell = getattr(steps, "build_arch_cell")(
                *_smoke(get_arch, arch_id, shape_name, dims), _mesh(shape))
            got = cell.make_inputs(torch.Generator().manual_seed(0), "cpu")
            for (p, t), (q, s) in zip(_leaves(got), _leaves(
                    cell.input_specs)):
                assert p == q and t.shape == s.shape and t.dtype == s.dtype
    mesh = make_local_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.size == 1


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]
