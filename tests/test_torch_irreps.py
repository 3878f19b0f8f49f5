"""The irreps machinery (``repro_torch.models.gnn.irreps``) and the
Equiformer-v2 built on it (``repro_torch.models.gnn.equiformer``), held
to the JAX package on the same inputs.

The Wigner stacks up to ``l_max`` 6 and the spherical harmonics are
unrolled exactly as the reference unrolls them (the same terms, added in
the same order), so they agree to float32's last bits; the Equiformer's
forward (flat, chunked, sentinel-padded edges), loss and every gradient
leaf agree within ``1e-4 * (1 + |ref|)``.  The property tests mirror
``tests/test_gnn.py`` on the port alone: homomorphism, orthogonality,
rotation invariance.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models.gnn import equiformer as jeq  # noqa: E402
from repro.models.gnn import irreps as jirreps  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.gnn import equiformer, irreps  # noqa: E402

from _gnn_ref import (  # noqa: E402
    close, close_trees, graph, params, ref, rotation, sorted_tree, t,
)

L_MAX = 6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _vectors():
    """Random directions, the axes, -z, a zero vector and near-aligned
    ones."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(24, 3)).astype(np.float32)
    special = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
                        [0, 0, 0], [1e-4, 0, 1], [1e-4, 0, -1],
                        [0, -2.5, 0]], np.float32)
    return np.concatenate([v, special])


def _jax_irreps(vec):
    R = jirreps.rotation_to_align_z(vec)
    return R, jirreps.wigner_d_stack(R, L_MAX), \
        jirreps.sph_harm_from_wigner(vec, L_MAX)


def test_wigner_stack_and_sph_harm_match_jax():
    vec = _vectors()
    # op by op: tracing the unrolled recursion for jit costs more
    jR, jD, jsh = _jax_irreps(vec)
    R = irreps.rotation_to_align_z(torch.from_numpy(vec))
    close(R, jR, 1e-6)
    D = irreps.wigner_d_stack(t(jR)[0], L_MAX)
    assert len(D) == L_MAX + 1
    for l, (got, want) in enumerate(zip(D, jD)):
        assert got.shape == (len(vec), 2 * l + 1, 2 * l + 1)
        close(got, want, 1e-5)
    close(irreps.sph_harm_from_wigner(torch.from_numpy(vec), L_MAX), jsh,
          1e-5)


def test_rotation_gradient_finite_at_zero_length_and_minus_z():
    """Both branches of `rotation_to_align_z` stay finite, and so does the
    gradient through the one not taken: a zero-length edge and edges
    along -z get finite gradients; elsewhere they are JAX's."""
    vec = _vectors()
    w = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)

    def jloss(v):
        return (jirreps.rotation_to_align_z(v) * w).sum()

    jg = np.asarray(jax.grad(jloss)(vec))
    v = torch.from_numpy(vec).requires_grad_()
    (irreps.rotation_to_align_z(v) * torch.from_numpy(w)).sum().backward()
    assert bool(torch.isfinite(v.grad).all())
    nonzero = np.linalg.norm(vec, axis=-1) > 0
    close(v.grad[torch.from_numpy(nonzero)], jg[nonzero], 1e-4)


def test_wigner_homomorphism_orthogonality_and_l1():
    """D(R1 R2) == D(R1) D(R2), D D^T == I, D^1 is R in (y, z, x) order."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    R1, R2 = irreps.rotation_to_align_z(v)
    D1 = irreps.wigner_d_stack(R1[None], L_MAX)
    D2 = irreps.wigner_d_stack(R2[None], L_MAX)
    D12 = irreps.wigner_d_stack((R1 @ R2)[None], L_MAX)
    for l in range(L_MAX + 1):
        close(D12[l][0], D1[l][0] @ D2[l][0], 1e-4)
        close(D1[l][0] @ D1[l][0].T, torch.eye(2 * l + 1), 1e-5)
    axes = [1, 2, 0]
    close(D1[1][0], R1[axes][:, axes], 0)
    # Y_l(z) is the m = 0 basis vector with norm sqrt((2l+1)/4pi)
    sh = irreps.sph_harm_from_wigner(torch.tensor([[0.0, 0.0, 1.0]]), 2)[0]
    want = np.zeros(9)
    for l, start in ((0, 0), (1, 1), (2, 4)):
        want[start + l] = math.sqrt((2 * l + 1) / (4 * math.pi))
    close(sh, want, 1e-6)
    assert irreps.num_sph(6) == 49
    assert irreps.l_slices(2) == jirreps.l_slices(2)


# ------------------------------------------------------------- Equiformer ----

EQ = jeq.EquiformerConfig(n_layers=2, d_hidden=16, l_max=2, m_max=1,
                          n_heads=2, d_feat=8, remat=False)


def _eq_edges(form, es, ed):
    if form == "chunked":
        return es.reshape(6, 8), ed.reshape(6, 8)
    if form == "padded":
        return (np.concatenate([es, np.zeros(16, np.int32)]),
                np.concatenate([ed, np.full(16, 14, np.int32)]))
    return es, ed


def _jax_eq(jp, cfg, nf, pos, es, ed, target, n):
    """The reference's forward, loss and gradients in one program."""
    fwd = jeq.forward_edges(jp, cfg, nf, pos, es, ed, n)
    return fwd, jax.value_and_grad(jeq.loss_edges)(jp, cfg, nf, pos, es, ed,
                                                   target, n)


def _check_equiformer(cfg, nf, pos, es, ed, target):
    jp, tp = params(jeq.init_equiformer, cfg)
    fwd, (jl, jg) = ref(_jax_eq, jp, cfg, nf, pos, es, ed, target, 14,
                        static=(1, -1))
    got = equiformer.forward_edges(tp, cfg, *t(nf, pos, es, ed), 14)
    for g, w in zip(got, fwd):
        close(g, w)
    tl, tg = common.value_and_grad(equiformer.loss_edges, tp, cfg,
                                   *t(nf, pos, es, ed, target), 14)
    assert all(bool(torch.isfinite(g).all())
               for g in common.tree_leaves(tg))
    close(tl, jl)
    close_trees(tg, jg)


@pytest.mark.parametrize("form,remat", [("flat", False), ("chunked", True),
                                        ("padded", True)])
def test_equiformer_forward_loss_and_grads_match_jax(form, remat):
    """Flat edges, edges chunked (6, 8) and edges padded with the sentinel
    ``n_nodes``; the chunked and padded cells with a checkpoint a layer."""
    cfg = dataclasses.replace(EQ, remat=remat)
    nf, pos, es, ed = graph(e=48)
    target = np.random.default_rng(2).normal(size=(14, 1)).astype(
        np.float32)
    _check_equiformer(cfg, nf, pos, *_eq_edges(form, es, ed), target)


def test_equiformer_zero_length_and_minus_z_edges():
    """A self loop (zero length: weight 0) and an edge along -z (the
    rotation's other branch) keep the forward and every gradient finite
    and equal to JAX's."""
    nf, pos, es, ed = graph(e=48)
    pos[1] = pos[0] - np.array([0, 0, 1.5], np.float32)
    es[:2], ed[:2] = (3, 0), (3, 1)
    _check_equiformer(EQ, nf, pos, es, ed, np.zeros((14, 1), np.float32))


def test_equiformer_rotation_invariance_and_chunked_equals_flat():
    _, tp = params(jeq.init_equiformer, EQ)
    nf, pos, es, ed = t(*graph(e=48))
    R = torch.from_numpy(rotation(0.8))
    inv1, o1 = equiformer.forward_edges(tp, EQ, nf, pos, es, ed, 14)
    inv2, o2 = equiformer.forward_edges(tp, EQ, nf, pos @ R.T, es, ed, 14)
    close(inv2, inv1, 1e-3)
    close(o2, o1, 1e-3)
    _, o3 = equiformer.forward_edges(tp, EQ, nf, pos, es.reshape(6, 8),
                                     ed.reshape(6, 8), 14)
    close(o3, o1)


def test_equiformer_index_sets_match_the_reference():
    for l_max, m_max in ((2, 1), (6, 2)):
        want = jeq._m_index_sets(l_max, m_max)
        sets, order = equiformer._m_index_sets(l_max, m_max,
                                               torch.device("cpu"))
        assert len(sets) == len(want)
        for (p, q), (jp_, jq) in zip(sets, want):
            assert p.tolist() == np.asarray(jp_).tolist()
            assert q.tolist() == np.asarray(jq).tolist()
        assert len(set(order.tolist())) == len(order)
        # built once a device
        assert equiformer._m_index_sets(l_max, m_max,
                                        torch.device("cpu"))[1] is order


def test_equiformer_arch_converter_and_smoke_step_match_jax():
    ja, ta = jax_arch("equiformer-v2"), get_arch("equiformer-v2")
    jp, tp = params(ja.init_fn, ja.smoke_config)
    for g, w in zip(common.tree_leaves(sorted_tree(tp)),
                    jax.tree.leaves(jp)):
        assert np.array_equal(g.numpy(), w)
    assert "layers" in tp and tp["layers"]["w_src"].shape == (2, 3, 16, 16)
    want = ref(ja.smoke_step, jp, ja.smoke_config, jax.random.PRNGKey(1),
               static=(1,))
    got = ta.smoke_step(tp, ta.smoke_config, prng.PRNGKey(1))
    for k in want:
        close(got[k], want[k])
