"""The port's FM recsys model (``repro_torch.models.recsys.fm``, the ``fm``
ArchDef) against the JAX package, from the same parameters (the
reference's ``init_fm`` carried across by ``fm_params_from_jax``, with
``w`` and ``b`` set nonzero from numpy so the linear term is held too)
and the same ids, on ``SMOKE`` and on a full-field config (39 fields x
K 10, vocab 64).

Tolerances (float32): the pair term within ``4e-6 * mag`` (see
``tests/test_torch_fm_kernel.py``), the linear terms and the candidate
dot product within ``4e-6`` of the sum of their terms' magnitudes, so a
logit or a score within ``4e-6 * (mag + sum |terms|)``; the loss within
``1e-6`` absolute (a mean of terms near 0.7).  Gradients: XLA's
scatter-add and PyTorch's ``index_add_`` accumulate the rows a batch
repeats in different orders, so each gradient is held to ``|port - jax|
<= 1e-5 |jax| + 1e-6 max |jax|``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models.recsys import fm as jfm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import fm_params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.recsys import fm  # noqa: E402

SMOKE = get_arch("fm").smoke_config
WIDE = fm.FMConfig(n_sparse=39, embed_dim=10, vocab_per_field=64)
CFGS = {"smoke": SMOKE, "wide": WIDE}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(cfg):
    return jfm.FMConfig(**dataclasses.asdict(cfg))


def _pair(cfg, seed=0):
    """(jax params, port params): ``init_fm``'s table, ``w ~ N(0, 0.1)``
    and ``b = 0.3`` from numpy."""
    jp = jfm.init_fm(jax.random.PRNGKey(seed), _jcfg(cfg))
    rng = np.random.default_rng(seed)
    tree = {"v": np.asarray(jp["v"]),
            "w": (rng.standard_normal(cfg.total_rows) * 0.1
                  ).astype(np.float32),
            "b": np.float32(0.3)}
    return ({k: jnp.asarray(a) for k, a in tree.items()},
            fm_params_from_jax(tree, device="cpu"))


def _ids(cfg, B, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_per_field, (B, cfg.n_sparse)).astype(np.int32)


def _mag(v):
    v = np.asarray(v, np.float64)
    s = v.sum(axis=-2)
    return 0.5 * (s * s + (v * v).sum(axis=-2)).sum(axis=-1)


def _logit_scale(tree, cfg, idx):
    """``mag + sum |w| + |b|`` of each row of ``idx`` (float64)."""
    rows = idx + np.arange(cfg.n_sparse) * cfg.vocab_per_field
    v, w = np.asarray(tree["v"])[rows], np.asarray(tree["w"])[rows]
    return _mag(v) + np.abs(w).sum(-1) + abs(float(tree["b"]))


def _close_grad(got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    bound = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("name", sorted(CFGS))
def test_logits_match_jax(name):
    cfg = CFGS[name]
    jp, tp = _pair(cfg)
    idx = _ids(cfg, 200)
    got = fm.fm_logits(tp, cfg, torch.from_numpy(idx)).numpy()
    want = np.asarray(jfm.fm_logits(jp, _jcfg(cfg), jnp.asarray(idx)))
    assert got.dtype == np.float32 and got.shape == (200,)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 4e-6 * _logit_scale(jp, cfg, idx)).all()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_retrieval_scores_match_jax(name):
    cfg = CFGS[name]
    jp, tp = _pair(cfg)
    user = np.array([3, 7, 11, 19], np.int32)
    cand = np.random.default_rng(2).integers(
        0, cfg.total_rows, 500).astype(np.int32)
    got = fm.fm_retrieval_scores(tp, cfg, torch.from_numpy(user),
                                 torch.from_numpy(cand)).numpy()
    want = np.asarray(jfm.fm_retrieval_scores(
        jp, _jcfg(cfg), jnp.asarray(user), jnp.asarray(cand)))
    v, w = np.asarray(jp["v"]), np.asarray(jp["w"])
    urows = user + np.arange(4) * cfg.vocab_per_field
    su = v[urows].astype(np.float64).sum(0)
    scale = (_mag(v[urows][None])[0] + np.abs(w[urows]).sum() + 0.3
             + np.abs(w[cand]) + np.abs(v[cand] * su).sum(-1))
    assert (np.abs(got.astype(np.float64) - want) <= 4e-6 * scale).all()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_and_grads_match_jax_with_repeated_rows(name):
    cfg = CFGS[name]
    jp, tp = _pair(cfg)
    B = 256                      # vocab <= 128: every field repeats rows
    idx = _ids(cfg, B, seed=3)
    labels = (np.random.default_rng(4).random(B) < 0.5).astype(np.float32)
    assert all(len(set(idx[:, f])) < B for f in range(cfg.n_sparse))
    loss, grads = fm.fm_value_and_grad(tp, cfg, torch.from_numpy(idx),
                                       torch.from_numpy(labels))
    jloss, jgrads = jax.value_and_grad(jfm.fm_loss)(
        jp, _jcfg(cfg), jnp.asarray(idx), jnp.asarray(labels))
    assert abs(float(loss) - float(jloss)) <= 1e-6
    assert float(fm.fm_loss(tp, cfg, torch.from_numpy(idx),
                            torch.from_numpy(labels))) == float(loss)
    for k in ("v", "w", "b"):
        assert grads[k].shape == tp[k].shape and grads[k].dtype == tp[k].dtype
        _close_grad(grads[k].numpy(), jgrads[k])
    assert not any(p.requires_grad for p in tp.values())


def test_retrieval_decomposition_matches_full_logit():
    """``tests/test_recsys.py``'s decomposition on the port: score(c) -
    score(c') equals logit(u + c) - logit(u + c') with the candidate's
    field appended (a one-hot candidate has no self-interaction)."""
    cfg = fm.FMConfig(n_sparse=5, embed_dim=4, vocab_per_field=50)
    _, p = _pair(cfg)
    user = torch.tensor([3, 7, 11, 19], dtype=torch.int32)
    cands = torch.tensor([0, 1, 2], dtype=torch.int32)
    scores = fm.fm_retrieval_scores(p, cfg, user,
                                    cands + 4 * cfg.vocab_per_field)
    full = [float(fm.fm_logits(p, cfg, torch.cat([user, c[None]])[None])[0])
            for c in cands]
    np.testing.assert_allclose(np.diff(scores.numpy()), np.diff(full),
                               rtol=1e-4, atol=1e-5)


def test_arch_def_matches_the_reference():
    arch, ref = get_arch("fm"), jax_arch("fm")
    full = arch.config
    assert (full.n_sparse, full.embed_dim, full.vocab_per_field,
            full.interaction) == (39, 10, 1_000_000, "fm-2way")
    assert full.total_rows == 39_000_000
    assert dataclasses.asdict(arch.smoke_config) == dataclasses.asdict(
        ref.smoke_config)
    assert arch.family == ref.family == "recsys"
    assert sorted(arch.shapes) == sorted(ref.shapes) == [
        "retrieval_cand", "serve_bulk", "serve_p99", "train_batch"]
    for name, shape in arch.shapes.items():
        assert (shape.kind, shape.dims) == (ref.shapes[name].kind,
                                            ref.shapes[name].dims)
    assert torch.equal(full.field_offsets()[:3],
                       torch.tensor([0, 1_000_000, 2_000_000]))


def test_smoke_step_matches_the_reference():
    arch, ref = get_arch("fm"), jax_arch("fm")
    cfg = arch.smoke_config
    jp, tp = _pair(cfg)
    got = arch.smoke_step(tp, cfg, prng.PRNGKey(5))
    want = ref.smoke_step(jp, _jcfg(cfg), jax.random.PRNGKey(5))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        assert g.shape == np.shape(w) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


def test_init_fm_defaults_to_cuda_and_follows_the_reference():
    arch = get_arch("fm")
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert arch.init_fn(SMOKE, generator=gen)["v"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            arch.init_fn(SMOKE, generator=gen)
    p = fm.init_fm(WIDE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    assert p["v"].shape == (WIDE.total_rows, 10) and p["w"].shape == (
        WIDE.total_rows,) and p["b"].shape == ()
    assert 0.009 < float(p["v"].std()) < 0.011
    assert not p["w"].any() and float(p["b"]) == 0.0
    again = fm.init_fm(WIDE, generator=torch.Generator().manual_seed(0),
                       device="cpu", dtype=torch.bfloat16)
    assert again["v"].dtype == torch.bfloat16
    assert torch.equal(again["v"], p["v"].to(torch.bfloat16))


def test_bf16_table_reads_the_pair_term_in_f32():
    cfg = SMOKE
    _, tp = _pair(cfg)
    bf = {k: t.to(torch.bfloat16) for k, t in tp.items()}
    idx = torch.from_numpy(_ids(cfg, 16))
    rows = idx.long() + cfg.field_offsets()[None]
    want_pair = ops.fm_interaction(bf["v"][rows].float())
    got = fm.fm_logits(bf, cfg, idx)
    assert got.dtype == torch.float32
    lin = bf["b"] + bf["w"][rows].sum(-1)
    assert torch.equal(got, lin + want_pair)


def test_params_carry_across():
    jp, _ = _pair(SMOKE)
    tree = {k: np.asarray(a) for k, a in jp.items()}
    tp = fm_params_from_jax(tree, device="cpu")
    for k in ("v", "w", "b"):
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), tree[k])
    bf = fm_params_from_jax({k: np.asarray(jnp.asarray(a, jnp.bfloat16))
                             for k, a in tree.items()}, device="cpu")
    assert bf["v"].dtype == torch.bfloat16
    assert torch.equal(bf["v"], tp["v"].to(torch.bfloat16))
    half = fm_params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert half["w"].dtype == torch.bfloat16
