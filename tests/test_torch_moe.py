"""The port's MoE layer (``repro_torch.models.moe`` and the transformer's
``_moe_ffn``) against the JAX package on the same weights and tokens.

Inputs come from a numpy seed; the weights are the reference's
``init_lm``/``init_moe`` carried across.  In float32 the routing indices,
the capacity, the slot positions, ``keep`` and the slot maps are equal
(a differing routing index is allowed only as a near-tie of two router
probabilities, classified by ``repro_torch.core.ties.classify_topk``),
and ``y`` and the aux loss lie within ``1e-4 * (1 + |ref|)``, the f32 LM
tolerance (the port sums the expert GEMMs and each token's slots in
another order than XLA).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import moe_sharded as jms  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.ties import classify_topk  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = 1e-4
MOE_ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=TOL):
    g = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w) / (1 + np.abs(w))
    assert err.max() <= tol, err.max()


@functools.lru_cache(maxsize=None)
def _init(arch, dtype):
    """The reference's ``init_lm`` of a smoke config at key 0, compiled
    once (eagerly it takes seconds), as numpy."""
    jcfg = dataclasses.replace(jax_arch(arch).smoke_config, dtype=dtype)
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jt.init_lm(key, jcfg))(jax.random.PRNGKey(0)))


def _layer(arch, **changes):
    """(jax cfg, port cfg, jax layer 0, port layer 0) of a MoE smoke
    config."""
    jcfg = dataclasses.replace(jax_arch(arch).smoke_config, **changes)
    cfg = dataclasses.replace(get_arch(arch).smoke_config, **changes)
    jp = _init(arch, jcfg.dtype)
    tp = lm_params_from_jax(jp, device="cpu")
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"])
    return jcfg, cfg, jl, tt._layers(tp)[0]


def _x(T, d, seed=0):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)


def _jax_slots(gate_idx, E, C):
    """The reference's sort-based slot maps (``transformer._moe_ffn``,
    lines 155-171) on ``gate_idx``: (pos, keep, slot_token, slot_valid)."""
    T, k = gate_idx.shape
    flat_eid = gate_idx.reshape(-1)
    order = jnp.argsort(flat_eid, stable=True)
    sorted_eid = flat_eid[order]
    seg_start = jnp.searchsorted(sorted_eid,
                                 jnp.arange(E, dtype=sorted_eid.dtype))
    pos_sorted = (jnp.arange(T * k, dtype=jnp.int32)
                  - seg_start[sorted_eid].astype(jnp.int32))
    pos = jnp.zeros((T * k,), jnp.int32).at[order].set(pos_sorted)
    pos = pos.reshape(T, k)
    keep = pos < C
    flat_slot = jnp.where(keep, gate_idx * C + pos, E * C)
    token_ids = jnp.broadcast_to(jnp.arange(T)[:, None], (T, k))
    slot_token = jnp.zeros((E * C,), jnp.int32).at[flat_slot.reshape(-1)].set(
        token_ids.reshape(-1), mode="drop")
    slot_valid = jnp.zeros((E * C,), jnp.bool_).at[flat_slot.reshape(-1)].set(
        True, mode="drop")
    return pos, keep, slot_token, slot_valid


def test_init_moe_shapes_dtypes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 64, 96, 8, dtype=torch.bfloat16)
    jp = jax.eval_shape(lambda key: jmoe.init_moe(
        key, 64, 96, 8, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    for name in ("router", "w_gate_up", "w_down"):
        assert tuple(p[name].shape) == jp[name].shape
        assert str(p[name].dtype).split(".")[-1] == jp[name].dtype.name
    assert p["router"].dtype == torch.float32
    assert abs(float(p["w_gate_up"].float().std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["w_down"].float().std()) - 96 ** -0.5) < 0.01
    # and the LM's stacked experts
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").smoke_config,
                              dtype="bfloat16")
    lp = tt.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    L, E, d, ff = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert lp["layers"]["router"].shape == (L, d, E)
    assert lp["layers"]["router"].dtype == torch.float32
    assert lp["layers"]["w_gate_up"].shape == (L, E, d, 2 * ff)
    assert lp["layers"]["w_down"].shape == (L, E, ff, d)
    assert lp["layers"]["w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_apply_matches_jax(cf):
    jp = jax.jit(lambda key: jmoe.init_moe(key, 32, 48, 8))(
        jax.random.PRNGKey(1))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _x(40, 32, seed=2)
    jy, jaux = _run(lambda p, xj: jmoe.moe_apply(
        p, xj, top_k=2, capacity_factor=cf), jp, jnp.asarray(x))
    y, aux = moe.moe_apply(p, torch.from_numpy(x), top_k=2,
                           capacity_factor=cf)
    assert y.dtype == torch.float32
    _close(y, jy)
    _close(aux, jaux)


def test_sort_based_routing_matches_onehot_reference():
    """Sort-based slot assignment == the dense one-hot cumsum reference,
    and == the reference's sort-based positions on the same ids."""
    T, k, E, C = 64, 2, 8, 12
    gate_idx = np.random.default_rng(3).integers(0, E, (T, k))
    onehot = np.eye(E, dtype=np.float32)[gate_idx]
    flat_oh = onehot.reshape(T * k, E)
    pos_ref = ((np.cumsum(flat_oh, axis=0) - flat_oh)
               .reshape(T, k, E) * onehot).sum(-1).astype(np.int64)
    pos = moe.sort_positions(torch.from_numpy(gate_idx), E)
    assert np.array_equal(pos.numpy(), pos_ref)
    jpos, jkeep, _, _ = _run(lambda g: _jax_slots(g, E, C),
                             jnp.asarray(gate_idx, jnp.int32))
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal((pos < C).numpy(), np.asarray(jkeep))


def test_top_k_keeps_the_lower_expert_on_a_tie():
    probs_row = torch.tensor([[0.0, 1.0, 1.0, 0.0, 1.0]])
    router = torch.eye(5)
    _, _, idx = moe.top_k_gates(torch.log(probs_row + 1e-30), router, 2)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.log(
        jnp.asarray(probs_row.numpy()) + 1e-30)), 2)
    assert idx.tolist() == [[1, 2]] == np.asarray(jidx).tolist()


def _run(fn, *args):
    """``jax.jit(fn)(*args)`` with XLA's cheaper compile (the reference's
    arithmetic either way; compiles dominate these tests)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_ffn_matches_jax(arch, cf):
    """Routing, slot maps, keep, y and aux of the transformer's gather
    dispatch; cf 0.5 drops tokens, cf 1.25 (the configs') may."""
    jcfg, cfg, jl, tl = _layer(arch, capacity_factor=cf)
    E, k = cfg.n_experts, cfg.top_k
    x = _x(48, cfg.d_model, seed=4)
    xt = torch.from_numpy(x)
    r = moe.route(xt, tl["router"], E, k, cf)
    C = max(int(cf * k * 48 / E), 1)

    def reference(layer, xj):
        _, idx = jax.lax.top_k(jax.nn.softmax(xj @ layer["router"], -1), k)
        return (idx, _jax_slots(idx, E, C),
                jms._local_dispatch(xj, layer["router"], E, k, cf),
                jt._moe_ffn(layer, xj, jcfg))

    jidx, slots, local, (jy, jaux) = _run(reference, jl, jnp.asarray(x))
    jidx = np.asarray(jidx)
    report = classify_topk(x, tl["router"], r.gate_idx, jidx)
    assert report["faults"] == [], report
    assert r.C == C
    if report["tokens"]:
        # near-ties only: hold the slot positions to the reference's on
        # its own ids
        pos = moe.sort_positions(torch.from_numpy(jidx), E)
    else:
        pos = r.pos
    jpos, jkeep, jtok, jvalid = (np.asarray(a) for a in slots)
    assert np.array_equal(pos.numpy(), jpos)
    assert np.array_equal((pos < C).numpy(), jkeep)
    if cf == 0.5:
        assert not jkeep.all()
    if report["tokens"]:
        return
    assert np.array_equal(r.keep.numpy(), jkeep)
    assert np.array_equal(r.slot_token.numpy(), jtok)
    assert np.array_equal(r.slot_valid.numpy(), jvalid)
    _, stok, sgate, jprobs, jeid = local
    assert np.array_equal(r.flat_eid.numpy(), np.asarray(jeid))
    assert np.array_equal(r.slot_token.numpy(), np.asarray(stok))
    _close(r.slot_gate, sgate)
    _close(r.probs, jprobs)
    y, aux = tt._moe_ffn(tl, xt, cfg)
    _close(y, jy)
    _close(aux, jaux)


def test_route_counts_drops_only_while_obs_is_on():
    """``moe.dropped`` / ``moe.choices`` equal ``keep``'s count, and the
    routing is the same with observability on or off."""
    from repro_torch import obs

    cfg = get_arch("moonshot-v1-16b-a3b").smoke_config
    router = torch.randn((cfg.d_model, cfg.n_experts),
                         generator=torch.Generator().manual_seed(1))
    xt = torch.from_numpy(_x(40, cfg.d_model, seed=6))
    off = moe.route(xt, router, cfg.n_experts, cfg.top_k, 0.5)
    obs.reset()
    try:
        assert obs.snapshot()["counters"] == {}
        obs.enable()
        on = [moe.route(xt, router, cfg.n_experts, cfg.top_k, 0.5)
              for _ in range(2)]
        counters = obs.snapshot()["counters"]
        capacity = obs.gauge("moe.capacity")
        assert (capacity.value, capacity.max) == (on[0].C, on[0].C)
    finally:
        obs.reset()
    dropped = int((~off.keep).sum())
    assert dropped > 0
    assert counters == {"moe.choices": 2 * off.keep.numel(),
                        "moe.dropped": 2 * dropped}
    for r in on:
        assert torch.equal(r.flat_slot, off.flat_slot)
        assert torch.equal(r.slot_gate, off.slot_gate)


def test_moe_ffn_bf16_matches_jax():
    jcfg, cfg, jl, tl = _layer("grok-1-314b", dtype="bfloat16")
    x = _x(32, cfg.d_model, seed=5)
    jy, jaux = _run(lambda p, xj: jt._moe_ffn(p, xj, jcfg), jl,
                    jnp.asarray(x, jnp.bfloat16))
    y, aux = tt._moe_ffn(tl, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    # the expert GEMMs round to bf16 in both; a few bf16 steps apart
    _close(y.float(), np.asarray(jy, np.float32), tol=3e-2)
    _close(aux, jaux)


def test_lm_params_from_jax_keeps_the_router_f32():
    jp = _init("moonshot-v1-16b-a3b", "bfloat16")
    for dtype in (None, torch.bfloat16, torch.float32):
        tp = lm_params_from_jax(jp, device="cpu", dtype=dtype)
        assert tp["layers"]["router"].dtype == torch.float32
        want = dtype or torch.bfloat16
        assert tp["layers"]["w_gate_up"].dtype == want
        assert tp["embed"].dtype == want
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            t = tp
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape
            assert np.array_equal(t.float().numpy(),
                                  np.asarray(leaf, np.float32))
