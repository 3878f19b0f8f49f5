"""The GNNs of the port (``repro_torch.models.gnn``), their building blocks
and configs, held to the JAX package on the same inputs.

Parameters come from the reference's ``init_*`` through
``convert.gnn_params_from_jax``; inputs are numpy draws from a seed.
Forwards, losses and every gradient leaf agree within ``1e-4 * (1 +
|ref|)`` in float32 (``1e-2`` with bf16 latents, on a graph where no
bf16 sum adds two messages: `test_graphcast_bf16_latents_match_jax`
says why).  The reference runs under ``jax.jit`` (``tests/_gnn_ref.py``).
Equiformer's cells are in ``tests/test_torch_irreps.py``.  The sharded forms on
2x2 meshes of the host are held to the port's single-device forms, never
to a reference mesh cell.  The property tests mirror
``tests/test_gnn.py`` on the port alone.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.gnn import egnn as jegnn  # noqa: E402
from repro.models.gnn import graphcast as jgc  # noqa: E402
from repro.models.gnn import graphsage as jsage  # noqa: E402
from repro.models.gnn import mpnn as jmpnn  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import gnn_params_from_jax  # noqa: E402
from repro_torch.graphs.partition import partition_edges_by_dst  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.gnn import (  # noqa: E402
    egnn, graphcast, graphsage, mpnn,
)

from _gnn_ref import (  # noqa: E402
    BF16_TOL, close as _close, close_trees as _close_trees, graph as _graph,
    params, ref, ref_vg, rotation as _rotation, sorted_tree as _sorted,
    t as _t,
)

ARCHS = ("graphsage-reddit", "egnn", "graphcast", "equiformer-v2")
#: the archs whose forward and gradients this file holds (Equiformer's
#: are in ``tests/test_torch_irreps.py``)
HERE = ARCHS[:3]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------ common, configs ----

def test_layer_norm_mlp_and_count_params_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 10)).astype(np.float32)
    s, b = rng.normal(size=10).astype(np.float32), rng.normal(
        size=10).astype(np.float32)
    _close(common.layer_norm(*_t(x, s, b)), jcommon.layer_norm(x, s, b))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = common.layer_norm(xb, *_t(s, b))
    assert got.dtype == torch.bfloat16
    _close(got, jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16), s, b),
           BF16_TOL)
    jp = jcommon.mlp_init(jax.random.PRNGKey(1), [10, 7, 3])
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(tp) == ["b0", "b1", "w0", "w1"]
    _close(common.mlp_apply(tp, torch.from_numpy(x)),
           jcommon.mlp_apply(jp, x))
    _close(common.mlp_apply(tp, torch.from_numpy(x), final_act=True),
           jcommon.mlp_apply(jp, x, final_act=True))
    for a in ARCHS:
        ja = jax_arch(a)
        jparams = jax.eval_shape(
            functools.partial(ja.init_fn, cfg=ja.smoke_config),
            jax.random.PRNGKey(0))
        tparams = get_arch(a).init_fn(torch.Generator().manual_seed(0),
                                      get_arch(a).smoke_config, device="cpu")
        assert common.count_params(tparams) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_shapes_equal_the_reference(arch):
    ja, ta = jax_arch(arch), get_arch(arch)
    for name in ("config", "smoke_config"):
        assert (dataclasses.asdict(getattr(ta, name))
                == dataclasses.asdict(getattr(ja, name)))
    assert ta.family == ja.family == "gnn"
    assert ta.source == ja.source
    assert {k: (v.kind, v.dims) for k, v in ta.shapes.items()} == \
        {k: (v.kind, v.dims) for k, v in ja.shapes.items()}
    from repro.configs._gnn_common import minibatch_subgraph_dims as jdims
    from repro_torch.configs._gnn_common import minibatch_subgraph_dims
    assert minibatch_subgraph_dims(1024, (15, 10)) == jdims(1024, (15, 10))


@pytest.mark.parametrize("arch", HERE)
def test_converter_keeps_the_reference_tree(arch):
    ja = jax_arch(arch)
    jp, tp = params(ja.init_fn, ja.smoke_config)
    assert (jax.tree.structure(jax.tree.map(lambda _: 0, jp))
            == jax.tree.structure(common.tree_map(lambda _: 0, tp)))
    for g, w in zip(common.tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the port's own init draws the same tree
    own = get_arch(arch).init_fn(torch.Generator().manual_seed(0),
                                 get_arch(arch).smoke_config, device="cpu")
    assert [tuple(t.shape) for t in common.tree_leaves(_sorted(own))] == \
        [w.shape for w in jax.tree.leaves(jp)]


@pytest.mark.parametrize("arch", HERE)
def test_smoke_step_matches_jax(arch):
    """Each arch's smoke hook on the converted parameters and the same
    threefry key: every output the reference returns."""
    ja, ta = jax_arch(arch), get_arch(arch)
    jp, tp = params(ja.init_fn, ja.smoke_config)
    want = ref(ja.smoke_step, jp, ja.smoke_config, jax.random.PRNGKey(1),
               static=(1,))
    got = ta.smoke_step(tp, ta.smoke_config, prng.PRNGKey(1))
    for k in want:
        _close(got[k], want[k])
    assert len(common.tree_leaves(got["grads"])) == len(jax.tree.leaves(jp))


# ------------------------------------------------------------------ mpnn ----

@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_aggregate_matches_jax(op):
    rng = np.random.default_rng(3)
    msgs = rng.normal(size=(40, 5)).astype(np.float32)
    # node 9 receives nothing; the sentinel 12 and -1 drop
    dst = rng.integers(0, 9, 40).astype(np.int32)
    dst[:3] = (12, 12, -1)
    got = mpnn.aggregate(*_t(msgs, dst), 12, op)
    _close(got, jmpnn.aggregate(msgs, dst, 12, op))
    assert bool((got[9:] == 0).all())


def test_gather_src_is_jnp_take():
    h = np.arange(12, dtype=np.float32).reshape(6, 2)
    idx = np.array([0, 5, -1, -6, 6, -7], np.int32)
    got = mpnn.gather_src(*_t(h, idx))
    want = np.asarray(jmpnn.gather_src(h, idx))
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got.numpy()), np.nan_to_num(want))


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_sharded_aggregate_equals_single_device(op, shape):
    rng = np.random.default_rng(4)
    n, e = 14, 60
    h = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    mesh = Mesh([["cpu"] * shape[1]] * shape[0], ("data", "model"))
    shards = shape[0] * shape[1]
    ss, ds, nb = partition_edges_by_dst(src, dst, n, shards)
    w = torch.from_numpy(rng.normal(size=(6, 6)).astype(np.float32))
    got = mpnn.sharded_aggregate(
        mesh, h, lambda x: torch.tanh(x @ w), torch.from_numpy(ss),
        torch.from_numpy(ds), nb, axis_name=("data", "model"), op=op)
    want = mpnn.aggregate(torch.tanh(h[torch.from_numpy(src)] @ w),
                          torch.from_numpy(dst), n, op)
    assert got.shape == (shards * nb, 6)
    _close(got[:n], want)
    # over "model" alone: each data row of tiles computes every block
    ss2, ds2, nb2 = partition_edges_by_dst(src, dst, n, shape[1])
    got2 = mpnn.sharded_aggregate(
        mesh, h, lambda x: x, torch.from_numpy(ss2), torch.from_numpy(ds2),
        nb2, axis_name="model", op=op)
    _close(got2[:n], mpnn.aggregate(h[torch.from_numpy(src)],
                                    torch.from_numpy(dst), n, op))


# ------------------------------------------------------------- GraphSAGE ----

SAGE = jsage.SageConfig(n_layers=2, d_hidden=8, d_feat=6, n_classes=3)


def _sage_blocks(seed=0, B=5, f1=3, f2=2, F=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, F)).astype(np.float32),
            rng.normal(size=(B, f1, F)).astype(np.float32),
            rng.normal(size=(B * f1, f2, F)).astype(np.float32),
            rng.integers(0, 3, B).astype(np.int32))


def test_graphsage_blocks_and_edges_match_jax():
    jp, tp = params(jsage.init_sage, SAGE)
    xs, x1, x2, labels = _sage_blocks()
    _close(graphsage.forward_blocks(tp, SAGE, *_t(xs, x1, x2)),
           ref(jsage.forward_blocks, jp, SAGE, xs, x1, x2, static=(1,)))
    nf, _, es, ed = _graph(d_feat=6)
    for agg in ("mean", "sum", "max"):
        cfg = dataclasses.replace(SAGE, aggregator=agg)
        _close(graphsage.forward_edges(tp, cfg, *_t(nf, es, ed), 14),
               ref(jsage.forward_edges, jp, cfg, nf, es, ed, 14))


def test_graphsage_losses_and_grads_match_jax():
    jp, tp = params(jsage.init_sage, SAGE)
    xs, x1, x2, labels = _sage_blocks()
    jl, jg = ref_vg(jsage.loss_blocks, jp, SAGE, xs, x1, x2, labels,
                    static=(1,))
    tl, tg = common.value_and_grad(graphsage.loss_blocks, tp, SAGE,
                                   *_t(xs, x1, x2, labels))
    _close(tl, jl)
    _close_trees(tg, jg)
    nf, _, es, ed = _graph(d_feat=6)
    lab = np.random.default_rng(1).integers(0, 3, 14).astype(np.int32)
    jl, jg = ref_vg(jsage.loss_edges, jp, SAGE, nf, es, ed, lab,
                                                  14)
    tl, tg = common.value_and_grad(graphsage.loss_edges, tp, SAGE,
                                   *_t(nf, es, ed, lab), 14)
    _close(tl, jl)
    _close_trees(tg, jg)


def test_graphsage_blocks_vs_edges_consistency():
    """Block mode on the full expansion of node 0's neighbourhood equals
    edge mode at node 0 (the reference's own property)."""
    _, tp = params(jsage.init_sage, SAGE)
    nf = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 6)).astype(np.float32))
    es = torch.tensor([1, 2, 2, 1])
    ed = torch.tensor([0, 0, 1, 2])
    full = graphsage.forward_edges(tp, SAGE, nf, es, ed, 3)
    blk = graphsage.forward_blocks(tp, SAGE, nf[0:1], nf[[1, 2]][None],
                                   nf[torch.tensor([[2, 2], [1, 1]])])
    _close(blk[0], full[0])


# ------------------------------------------------------------------ EGNN ----

EGNN = jegnn.EGNNConfig(n_layers=2, d_hidden=24, d_feat=8)


@pytest.mark.parametrize("coord_agg", ["mean", "sum"])
def test_egnn_forward_loss_and_grads_match_jax(coord_agg):
    """The forward with both coordinate aggregations; the loss and its
    gradients with the configs' ``mean`` (a sum of 3-4 raw coordinate
    updates a node makes gradients of ~1e5 here, where float32's own
    rounding reaches 1e-4 of them)."""
    cfg = dataclasses.replace(EGNN, coord_agg=coord_agg)
    jp, tp = params(jegnn.init_egnn, EGNN)
    nf, pos, es, ed = _graph()
    target = pos[::-1].copy()
    got = egnn.forward_edges(tp, cfg, *_t(nf, pos, es, ed), 14)
    want = ref(jegnn.forward_edges, jp, cfg, nf, pos, es, ed, 14)
    for g, w in zip(got, want):
        _close(g, w)
    if coord_agg != "mean":
        return
    jl, jg = ref_vg(jegnn.loss_edges, jp, cfg, nf, pos, es, ed,
                                                  target, 14)
    tl, tg = common.value_and_grad(egnn.loss_edges, tp, cfg,
                                   *_t(nf, pos, es, ed, target), 14)
    _close(tl, jl)
    _close_trees(tg, jg)


def test_egnn_e_n_equivariance():
    _, tp = params(jegnn.init_egnn, EGNN)
    nf, pos, es, ed = _t(*_graph())
    R, t = torch.from_numpy(_rotation()), torch.tensor([1.0, -2.0, 0.5])
    h1, x1, e1 = egnn.forward_edges(tp, EGNN, nf, pos, es, ed, 14)
    h2, x2, e2 = egnn.forward_edges(tp, EGNN, nf, pos @ R.T + t, es, ed, 14)
    _close(x2, x1 @ R.T + t)
    _close(h2, h1)
    _close(e2, e1)


def test_egnn_permutation_equivariance():
    cfg = dataclasses.replace(EGNN, n_layers=1, d_hidden=16)
    _, tp = params(jegnn.init_egnn, cfg)
    nf, pos, es, ed = _t(*_graph())
    perm = torch.from_numpy(np.random.default_rng(0).permutation(14))
    inv = torch.argsort(perm)
    h1, x1, _ = egnn.forward_edges(tp, cfg, nf, pos, es, ed, 14)
    h2, x2, _ = egnn.forward_edges(tp, cfg, nf[perm], pos[perm],
                                   inv[es.long()], inv[ed.long()], 14)
    _close(h2, h1[perm])
    _close(x2, x1[perm])


# -------------------------------------------------------------- GraphCast ----

GC = jgc.GraphCastConfig(n_layers=4, d_hidden=16, n_vars=5, d_edge_in=4,
                         remat=False)


def _gc_inputs(seed=9):
    nf, _, es, ed = _graph(d_feat=5)
    ef = np.random.default_rng(seed).normal(size=(50, 4)).astype(np.float32)
    return nf, ef, es, ed


@pytest.mark.parametrize("variant", ["remat", "remat_group2"])
def test_graphcast_forward_loss_and_grads_match_jax(variant):
    """A checkpoint a layer and one every two layers (the smoke config,
    without remat, is held by `test_smoke_step_matches_jax`)."""
    cfg = {"remat": dataclasses.replace(GC, remat=True),
           "remat_group2": dataclasses.replace(GC, remat=True,
                                               remat_group=2)}[variant]
    jp, tp = params(jgc.init_graphcast, GC)
    nf, ef, es, ed = _gc_inputs()
    _close(graphcast.forward_edges(tp, cfg, *_t(nf, ef, es, ed), 14),
           ref(jgc.forward_edges, jp, cfg, nf, ef, es, ed, 14))
    jl, jg = ref_vg(jgc.loss_edges, jp, cfg, nf, ef, es, ed, nf,
                                                14)
    tl, tg = common.value_and_grad(graphcast.loss_edges, tp, cfg,
                                   *_t(nf, ef, es, ed, nf), 14)
    _close(tl, jl)
    _close_trees(tg, jg)


def test_graphcast_bf16_latents_match_jax():
    """bf16 latents (f32 weights and products): forward, loss and every
    gradient leaf within 1e-2 of JAX on a graph where every node has one
    in-edge and one out-edge, so that no bf16 sum adds two messages.
    Where a node sums several, the two libraries round differently on the
    host: JAX rounds every add of a bf16 segment sum to bf16, PyTorch's
    ``index_add_`` accumulates in f32 and rounds once (on the card it
    adds with bf16 atomics).  On the random graph each bf16 forward then
    lies ~1% from the f32 one, in its own direction; both are held to
    the f32 forward within 2e-2 there."""
    cfg = dataclasses.replace(GC, dtype="bfloat16", remat=True,
                              remat_group=2)
    jp, tp = params(jgc.init_graphcast, GC)
    nf, ef, _, _ = _gc_inputs()
    es = np.random.default_rng(0).permutation(14).astype(np.int32)
    ed = np.arange(14, dtype=np.int32)
    ef = ef[:14]
    _close(graphcast.forward_edges(tp, cfg, *_t(nf, ef, es, ed), 14),
           ref(jgc.forward_edges, jp, cfg, nf, ef, es, ed, 14), BF16_TOL)
    jl, jg = ref_vg(jgc.loss_edges, jp, cfg, nf, ef, es, ed, nf,
                                                14)
    tl, tg = common.value_and_grad(graphcast.loss_edges, tp, cfg,
                                   *_t(nf, ef, es, ed, nf), 14)
    _close(tl, jl, BF16_TOL)
    _close_trees(tg, jg, BF16_TOL)
    nf, ef, es, ed = _gc_inputs()
    f32 = ref(jgc.forward_edges, jp, GC, nf, ef, es, ed, 14)
    _close(graphcast.forward_edges(tp, cfg, *_t(nf, ef, es, ed), 14), f32,
           2 * BF16_TOL)
    _close(ref(jgc.forward_edges, jp, cfg, nf, ef, es, ed, 14), f32,
           2 * BF16_TOL)


def test_graphcast_remat_group_must_divide():
    cfg = dataclasses.replace(GC, remat=True, remat_group=3)
    _, tp = params(jgc.init_graphcast, GC)
    with pytest.raises(ValueError, match="remat_group"):
        graphcast.forward_edges(tp, cfg, *_t(*_gc_inputs()), 14)


@pytest.mark.parametrize("shape,variant", [((2, 2), "remat_group2"),
                                           ((2, 1), "plain"),
                                           ((1, 2), "remat")])
def test_graphcast_dst_partitioned_equals_single_device(shape, variant):
    """The C2 processor on a mesh of the host (all-gather over "data",
    partial sums over "model") == `forward_edges` on one device, forward,
    loss and gradients."""
    cfg = dataclasses.replace(GC, node_axes=("data",),
                              remat=variant != "plain",
                              remat_group=2 if variant == "remat_group2"
                              else 1)
    _, tp = params(jgc.init_graphcast, GC)
    nf, ef, src, dst = _gc_inputs()
    ef_p, es, ed = graphcast.partition_edges(*_t(src, dst, ef), 14,
                                             shape[0], shape[1])
    nb = 14 // shape[0]
    assert es.shape[0] % (shape[0] * shape[1]) == 0
    # every data block's slab holds its own edges, local ids, sentinels
    blocks = es.shape[0] // shape[0]
    for b in range(shape[0]):
        d = ed[b * blocks:(b + 1) * blocks]
        real = d < nb
        assert sorted((d[real] + b * nb).tolist()) == sorted(
            x for x in dst.tolist() if min(x // nb, shape[0] - 1) == b)
        assert bool((ef_p[b * blocks:(b + 1) * blocks][~real] == 0).all())
    mesh = Mesh([["cpu"] * shape[1]] * shape[0], ("data", "model"))
    want = graphcast.forward_edges(tp, cfg, *_t(nf, ef, src, dst), 14)
    got = graphcast.forward_edges_dst_partitioned(
        tp, cfg, torch.from_numpy(nf), ef_p, es, ed, 14, mesh=mesh)
    _close(got, want)
    tl, tg = common.value_and_grad(graphcast.loss_edges, tp, cfg,
                                   *_t(nf, ef, src, dst, nf), 14)
    pl, pg = common.value_and_grad(graphcast.loss_edges_dst_partitioned,
                                   tp, cfg, torch.from_numpy(nf), ef_p, es,
                                   ed, torch.from_numpy(nf), 14, mesh=mesh)
    _close(pl, tl)
    _close_trees(pg, jax.tree.map(np.asarray, common.tree_map(
        lambda t: t.numpy(), tg)))


def test_graphcast_dst_partitioned_checks_its_mesh():
    cfg = dataclasses.replace(GC, node_axes=("data",))
    _, tp = params(jgc.init_graphcast, GC)
    nf, ef, es, ed = _t(*_gc_inputs())
    with pytest.raises(ValueError, match="mesh over"):
        graphcast.forward_edges_dst_partitioned(
            tp, cfg, nf, ef, es, ed, 14,
            mesh=Mesh([["cpu"] * 2], ("data", "vertex")))
    with pytest.raises(ValueError, match="must divide"):
        graphcast.forward_edges_dst_partitioned(
            tp, cfg, nf, ef, es, ed, 14,
            mesh=Mesh([["cpu"] * 3] * 2, ("data", "model")))


