"""The meshed MoE FFN (``repro_torch.models.moe_sharded``) and the mesh's
grouped collectives, on meshes of the host.

Held to the single-device MoE FFN, the port's ``_moe_ffn`` and JAX's
(``repro.models.transformer._moe_ffn``), never to the reference's own
meshed cell (``tests/test_models_lm.py::test_moe_shard_map_matches_dense_path``
fails on this JAX).  Where no choice drops, local capacities give the
same sums as the global one, so ``ep`` and ``tpe`` on the 1x1, 1x2, 2x1
and 2x2 meshes equal the single-device FFN within ``1e-4 * (1 + |ref|)``
(the f32 LM tolerance: ``tpe`` adds its ff blocks' partial sums in tile
order); on 1x1 ``C_loc == C`` and they are equal with drops too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import mesh as M  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe, moe_sharded  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = 1e-4
ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b")
SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2))
#: no choice drops at this factor (checked)
NO_DROP = 64.0
B, S = 4, 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_mesh_left():
    yield
    moe_sharded.MESH = None


def _close(got, want, tol=TOL):
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w) / (1 + np.abs(w))
    assert err.max() <= tol, err.max()


def _grid(shape):
    return Mesh([["cpu"] * shape[1]] * shape[0], ("data", "model"))


def _sharded(cfg, part):
    return dataclasses.replace(cfg, moe_impl="shard_map",
                               moe_shard_axes=("data",), moe_partition=part)


@pytest.fixture(scope="module")
def cells():
    """Per arch and capacity factor: layer 0 of the smoke config (the
    reference's weights), tokens from a numpy seed, and JAX's and the
    port's single-device MoE FFN on them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for arch in ARCHS:
        jcfg = jax_arch(arch).smoke_config
        jp = jax.jit(lambda key, jcfg=jcfg: jt.init_lm(key, jcfg))(
            jax.random.PRNGKey(0))
        layer = tt._layers(lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu"))[0]
        jl = jax.tree.map(lambda a: a[0], jp["layers"])
        x = np.random.default_rng(7).standard_normal(
            (B, S, jcfg.d_model)).astype(np.float32)
        for cf in (NO_DROP, 0.5):
            c = dataclasses.replace(jcfg, capacity_factor=cf)
            jy, jaux = jax.jit(lambda p, xx, c=c: jt._moe_ffn(p, xx, c))(
                jl, jnp.asarray(x.reshape(B * S, -1)))
            cfg = dataclasses.replace(get_arch(arch).smoke_config,
                                      capacity_factor=cf)
            y, aux = tt._moe_ffn(layer, torch.from_numpy(x).reshape(B * S, -1),
                                 cfg)
            out[arch, cf] = dict(layer=layer, x=x, cfg=cfg, jy=np.asarray(jy),
                                 jaux=float(jaux), y=y, aux=aux)
    torch.set_num_threads(prev)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("part", ["ep", "tpe"])
def test_sharded_matches_single_device(cells, arch, shape, part):
    c = cells[arch, NO_DROP]
    r = moe.route(torch.from_numpy(c["x"]).reshape(B * S, -1),
                  c["layer"]["router"], c["cfg"].n_experts, c["cfg"].top_k,
                  NO_DROP)
    assert bool(r.keep.all())
    moe_sharded.MESH = _grid(shape)
    y, aux = moe_sharded.moe_ffn_sharded(c["layer"], torch.from_numpy(c["x"]),
                                         _sharded(c["cfg"], part))
    assert y.shape == (B, S, c["cfg"].d_model) and y.dtype == torch.float32
    _close(y.reshape(B * S, -1), c["y"])
    _close(y.reshape(B * S, -1), c["jy"])
    _close(aux, float(c["aux"]))
    _close(aux, c["jaux"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("part", ["ep", "tpe"])
def test_sharded_1x1_equals_single_device_with_drops(cells, arch, part):
    c = cells[arch, 0.5]
    r = moe.route(torch.from_numpy(c["x"]).reshape(B * S, -1),
                  c["layer"]["router"], c["cfg"].n_experts, c["cfg"].top_k,
                  0.5)
    assert not bool(r.keep.all())
    moe_sharded.MESH = _grid((1, 1))
    y, aux = moe_sharded.moe_ffn_sharded(c["layer"], torch.from_numpy(c["x"]),
                                         _sharded(c["cfg"], part))
    _close(y.reshape(B * S, -1), c["y"])
    _close(y.reshape(B * S, -1), c["jy"])
    _close(aux, c["jaux"])


@pytest.mark.parametrize("part", ["ep", "tpe"])
def test_sharded_gradients_are_finite_and_match(cells, part):
    """Through the meshed FFN on 2x2, the gradients of x and of every
    weight are finite and equal the single-device FFN's where nothing
    drops."""
    c = cells["grok-1-314b", NO_DROP]
    moe_sharded.MESH = _grid((2, 2))
    lay = {k: v.clone().requires_grad_() for k, v in c["layer"].items()}
    x = torch.from_numpy(c["x"]).requires_grad_()
    y, aux = moe_sharded.moe_ffn_sharded(lay, x, _sharded(c["cfg"], part))
    g = torch.autograd.grad((y.square().sum() + aux),
                            [x] + [lay[n] for n in ("router", "w_gate_up",
                                                    "w_down")])
    lay2 = {k: v.clone().requires_grad_() for k, v in c["layer"].items()}
    x2 = torch.from_numpy(c["x"]).requires_grad_()
    y2, aux2 = tt._moe_ffn(lay2, x2.reshape(B * S, -1), c["cfg"])
    g2 = torch.autograd.grad((y2.square().sum() + aux2),
                             [x2] + [lay2[n] for n in ("router", "w_gate_up",
                                                       "w_down")])
    for a, b in zip(g, g2):
        assert bool(torch.isfinite(a).all())
        _close(a, b.numpy())


def test_lm_loss_through_the_meshed_moe():
    """The transformer's training path with ``moe_impl="shard_map"`` on a
    2x2 mesh: the single-device loss and gradients (nothing drops);
    prefill keeps the single-device FFN, as the reference's does."""
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").smoke_config,
                              capacity_factor=NO_DROP)
    p = tt.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (4, 8),
                         generator=torch.Generator().manual_seed(1))
    l0, g0 = tt.lm_value_and_grad(p, cfg, toks, toks)
    moe_sharded.MESH = _grid((2, 2))
    for part in ("ep", "tpe"):
        l1, g1 = tt.lm_value_and_grad(p, _sharded(cfg, part), toks, toks)
        _close(l1, float(l0))
        for (name, a), (_, b) in zip(tt.tree_leaves(g1),
                                     tt.tree_leaves(g0)):
            assert bool(torch.isfinite(a).all()), name
            _close(a, b.numpy())
    moe_sharded.MESH = None
    with torch.no_grad():
        logits, _ = tt.prefill(p, _sharded(cfg, "ep"), toks)
    assert bool(torch.isfinite(logits).all())


def test_meshed_moe_refuses_without_a_mesh_or_with_ragged_tiles():
    cfg = _sharded(get_arch("grok-1-314b").smoke_config, "ep")
    p = tt._layers(tt.init_lm(torch.Generator().manual_seed(0), cfg,
                              device="cpu"))[0]
    x = torch.zeros((2, 6, cfg.d_model))
    moe_sharded.MESH = None
    with pytest.raises(RuntimeError, match="MESH"):
        moe_sharded.moe_ffn_sharded(p, x, cfg)
    moe_sharded.MESH = Mesh([["cpu"] * 4], ("data", "model"))
    with pytest.raises(ValueError, match="divide"):
        moe_sharded.moe_ffn_sharded(p, x, cfg)
    moe_sharded.MESH = Mesh([["cpu"] * 2], ("data", "expert"))
    with pytest.raises(ValueError, match="model"):
        moe_sharded.moe_ffn_sharded(p, x, cfg)


# ------------------------------------------------------ grouped collectives

def test_grouped_collectives_in_tile_order_with_autograd():
    mesh = Mesh([["cpu"] * 3] * 2, ("data", "model"))
    base = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 4)
    base.requires_grad_()
    parts = M.tile_map(mesh, lambda c, dev: base[c[0] * 3 + c[1]][None] * 1.0)
    assert [M.axis_index(mesh, c, ("data", "model")) for c in
            np.ndindex(2, 3)] == list(range(6))
    assert M.axis_groups(mesh, "model") == [[(0, 0), (0, 1), (0, 2)],
                                            [(1, 0), (1, 1), (1, 2)]]
    assert M.axis_groups(mesh, "data") == [[(0, j), (1, j)] for j in range(3)]
    summed = M.psum_over(mesh, parts, "model")
    assert torch.equal(summed[1, 2], base[3:6].sum(0, keepdim=True))
    gathered = M.all_gather_over(mesh, parts, "data", dim=0)
    assert torch.equal(gathered[0, 1], base[[1, 4]])
    # all_to_all: chunk j of every tile of a group to tile j, in tile order
    wide = M.tile_map(mesh, lambda c, dev: base[c[0] * 3 + c[1]][None]
                      .repeat(3, 1).reshape(3, 4) + 100 * torch.arange(
                          3.0)[:, None])
    moved = M.all_to_all_over(mesh, wide, "model", split_axis=0,
                              concat_axis=1)
    assert moved[0, 2].shape == (1, 12)
    assert torch.equal(moved[0, 2], torch.cat([base[i] + 200 for i in
                                                range(3)])[None])
    back = M.all_to_all_over(mesh, moved, "model", split_axis=1,
                             concat_axis=0)
    for c in np.ndindex(2, 3):
        assert torch.equal(back[c], wide[c])
    loss = sum(summed[c].sum() + gathered[c].sum() + back[c].sum()
               for c in np.ndindex(2, 3))
    (g,) = torch.autograd.grad(loss, base)
    # each row: 3 psums of its group, 2 gathers of its column, 3 chunks
    assert torch.equal(g, torch.full_like(base, 3.0 + 2.0 + 3.0))
    with pytest.raises(ValueError, match="split"):
        M.all_to_all([torch.zeros(4, 2)] * 3, 0, 1, ["cpu"] * 3)
