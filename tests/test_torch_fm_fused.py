"""The fused FM serving kernel's plain version
(``repro_torch.kernels.fm_interaction.fm_gather_interaction_plain``, the
CPU path of ``ops.fm_gather_interaction``) against the JAX package: the
whole logit against ``repro.models.recsys.fm.fm_logits``, its pair part
against the Pallas kernel in interpret mode on ``jnp.take``-gathered
rows, its NaN rows against the reference's, the retrieval constant
against the reference's ``const``; and within the port, bitwise against
a numpy float32 emulation of the fixed order that is the kernel's
contract, and the model's two routes (`fm_logits` without a gradient is
one fused call; with one, today's chain, bitwise).

Tolerance against JAX (``tests/test_torch_fm.py``'s): a logit within
``4e-6 * (mag + sum |w| + |b|)``, ``mag = 0.5 * sum_k (s_k**2 + sum_f
v_fk**2)`` in float64: the pair term nearly cancels, so the bound scales
with the magnitudes summed, not the result.  bf16 tables are read as
float32 by both sides; both round the linear sum and ``b + lin`` to
bfloat16 once, as PyTorch's and JAX's promotions do.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.recsys import fm as jfm  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import fm_interaction as fmk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.recsys import fm  # noqa: E402

REL = 4e-6
SMOKE = get_arch("fm").smoke_config
WIDE = fm.FMConfig(n_sparse=39, embed_dim=10, vocab_per_field=64)
CFGS = {"smoke": SMOKE, "wide": WIDE}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tables(cfg, scale, dtype, seed=0):
    """float32 numpy ``v ~ N(0, scale)``, ``w ~ N(0, 0.1)``, ``b = 0.3``
    rounded to ``dtype``: ``(numpy f32 tree, jax tree, torch tree)``."""
    rng = np.random.default_rng(seed)
    tree = {"v": rng.standard_normal((cfg.total_rows, cfg.embed_dim))
            * scale,
            "w": rng.standard_normal(cfg.total_rows) * 0.1,
            "b": np.array(0.3)}
    tt = {k: torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype)) for k, a in tree.items()}
    np32 = {k: t.to(torch.float32).numpy() for k, t in tt.items()}
    jt = {k: jnp.asarray(a).astype(getattr(jnp, dtype))
          for k, a in np32.items()}
    return np32, jt, tt


def _ids(cfg, B, idx_dtype, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_per_field, (B, cfg.n_sparse)).astype(idx_dtype)


def _scale(np32, cfg, idx):
    """``mag + sum |w| + |b|`` of each request (float64); its rows in
    ``[-n, n)``."""
    rows = idx.astype(np.int64) + np.arange(idx.shape[1]) * \
        cfg.vocab_per_field
    rows = np.where(rows < 0, rows + np32["v"].shape[0], rows)
    v = np32["v"][rows].astype(np.float64)
    s = v.sum(axis=1)
    mag = 0.5 * (s * s + (v * v).sum(axis=1)).sum(axis=-1)
    return mag + np.abs(np32["w"][rows]).sum(-1) + abs(float(np32["b"]))


def _fused(tt, cfg, idx):
    return fmk.fm_gather_interaction_plain(
        torch.from_numpy(idx), cfg.vocab_per_field, tt["v"], tt["w"],
        tt["b"])


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
@pytest.mark.parametrize("scale", [0.01, 0.3])
def test_fused_plain_matches_jax_fm_logits(name, dtype, idx_dtype, scale):
    cfg = CFGS[name]
    np32, jt, tt = _tables(cfg, scale, dtype)
    idx = _ids(cfg, 200, idx_dtype)
    got = _fused(tt, cfg, idx).numpy()
    want = np.asarray(jfm.fm_logits(
        jt, jfm.FMConfig(**dataclasses.asdict(cfg)),
        jnp.asarray(idx.astype(np.int32))))
    assert got.dtype == np.float32 and got.shape == (200,)
    err = np.abs(got.astype(np.float64) - want)
    bound = REL * _scale(np32, cfg, idx)
    assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.01, 0.3])
def test_fused_pair_part_matches_pallas_interpret(name, dtype, scale):
    """With ``w`` and ``b`` zero the fused logit is its pair term alone:
    held to the Pallas kernel (interpret mode) on the rows ``jnp.take``
    gathers."""
    cfg = CFGS[name]
    np32, jt, tt = _tables(cfg, scale, dtype, seed=2)
    zero_w, zero_b = torch.zeros_like(tt["w"]), torch.zeros_like(tt["b"])
    idx = _ids(cfg, 130, "int32", seed=3)
    got = fmk.fm_gather_interaction_plain(
        torch.from_numpy(idx), cfg.vocab_per_field, tt["v"], zero_w,
        zero_b).numpy()
    rows = jnp.asarray(idx) + jnp.arange(cfg.n_sparse) * cfg.vocab_per_field
    want = np.asarray(jops.fm_interaction(jnp.take(jt["v"], rows, axis=0),
                                          interpret=True))
    np32["w"][:] = 0
    np32["b"] = np.float32(0)
    bound = REL * _scale(np32, cfg, idx)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), float((err / bound).max())


def _bf16(x):
    """float32 -> bfloat16 -> float32, round to nearest even (no NaNs)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _emulate(np32, V, idx, bf16):
    """The kernel's fixed order in numpy float32, one rounding an
    operation; a row outside ``[-n, n)`` gives NaN, one in ``[-n, 0)``
    wraps."""
    n = np32["v"].shape[0]
    B, F = idx.shape
    rows = idx.astype(np.int64) + np.arange(F, dtype=np.int64) * V
    bad = ((rows < -n) | (rows >= n)).any(axis=1)
    rows = np.where(rows < 0, rows + n, rows) % n
    v, w = np32["v"][rows], np32["w"][rows]               # (B, F, K), (B, F)
    K = v.shape[2]
    s = np.zeros((B, K), np.float32)
    s2 = np.zeros((B, K), np.float32)
    lin = np.zeros(B, np.float32)
    for f in range(F):
        s = s + v[:, f]
        s2 = s2 + v[:, f] * v[:, f]
        lin = lin + w[:, f]
    t = (s * s - s2) * np.float32(0.5)
    pair = np.zeros(B, np.float32)
    for k in range(K):
        pair = pair + t[:, k]
    b = np.float32(np32["b"])
    base = _bf16(b + _bf16(lin)) if bf16 else b + lin
    out = base + pair
    out[bad] = np.nan
    return out


@pytest.mark.parametrize("shape", [(1, 1, 1, 3), (7, 39, 10, 50),
                                   (300, 6, 4, 20), (65, 16, 8, 9),
                                   (5, 3, 256, 4), (33, 4, 5, 11)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
def test_fused_plain_is_the_fixed_order_bitwise(shape, dtype, idx_dtype):
    """Signed zeros included: ``b = -0.0``, a request whose ``w`` and ``v``
    rows are all ``-0.0``, and the bits compared, not the values."""
    B, F, K, V = shape
    cfg = fm.FMConfig(n_sparse=F, embed_dim=K, vocab_per_field=V)
    np32, _, tt = _tables(cfg, 0.3, dtype, seed=K)
    idx = _ids(cfg, B, idx_dtype, seed=B)
    tt["b"] = torch.tensor(-0.0, dtype=tt["b"].dtype)
    zero_rows = idx[0].astype(np.int64) + np.arange(F) * V
    tt["v"][zero_rows] = -0.0
    tt["w"][zero_rows] = -0.0
    np32 = {k: t.to(torch.float32).numpy() for k, t in tt.items()}
    got = _fused(tt, cfg, idx).numpy()
    want = _emulate(np32, V, idx, dtype == "bfloat16")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_nan_rows_and_wrapped_ids_match_jax(name, dtype):
    """A wrapped negative id is served as its row; an id past the table
    and one below ``-n`` make their requests NaN, where JAX's are."""
    cfg = CFGS[name]
    np32, jt, tt = _tables(cfg, 0.01, dtype, seed=4)
    idx = _ids(cfg, 64, "int32", seed=5)
    idx[1, 0] = -1                                # row n - 1
    idx[2, -1] = cfg.vocab_per_field              # past the table
    idx[3, 0] = -cfg.total_rows - 1               # below -n
    idx[4, 1] = -cfg.vocab_per_field              # row -V + V = 0
    got = _fused(tt, cfg, idx).numpy()
    want = np.asarray(jfm.fm_logits(
        jt, jfm.FMConfig(**dataclasses.asdict(cfg)), jnp.asarray(idx)))
    assert np.isnan(want).nonzero()[0].tolist() == [2, 3]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    bound = REL * _scale(np32, cfg, idx[ok])
    err = np.abs(got[ok].astype(np.float64) - want[ok])
    assert (err <= bound).all(), float((err / bound).max())
    np.testing.assert_array_equal(
        got.view(np.int32),
        _emulate(np32, cfg.vocab_per_field, idx,
                 dtype == "bfloat16").view(np.int32))


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retrieval_constant_matches_jax(name, dtype):
    """The user's constant ``b + sum wu + user_pair`` is the fused logit
    of the user's fields (B 1, F 4), as the reference computes it."""
    cfg = CFGS[name]
    np32, jt, tt = _tables(cfg, 0.3, dtype, seed=6)
    user = np.array([3, 7, 11, 19], np.int32) % cfg.vocab_per_field
    got = fmk.fm_gather_interaction_plain(
        torch.from_numpy(user)[None], cfg.vocab_per_field, tt["v"], tt["w"],
        tt["b"])
    urows = jnp.asarray(user) + jnp.arange(4) * cfg.vocab_per_field
    vu = jnp.take(jt["v"], urows, axis=0)
    want = float(jt["b"] + jnp.take(jt["w"], urows, axis=0).sum()
                 + jref.fm_interaction_ref(vu[None].astype(jnp.float32))[0])
    assert got.shape == (1,)
    bound = REL * _scale(np32, dataclasses.replace(cfg, n_sparse=4),
                         user[None])[0]
    assert abs(float(got[0]) - want) <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_logits_serves_through_the_fused_route(dtype):
    """Without a gradient `fm_logits` is one fused call and
    `fm_retrieval_scores` takes its constant from one more; with one,
    it is today's chain (`_gather`, ``FMInteraction``, ``w.sum(-1)``)
    bit for bit, and dispatches no fused call."""
    cfg = WIDE
    _, _, tt = _tables(cfg, 0.3, dtype, seed=7)
    idx = torch.from_numpy(_ids(cfg, 96, "int32", seed=8))
    obs.reset()
    obs.enable()
    try:
        with torch.no_grad():
            serve = fm.fm_logits(tt, cfg, idx)
            fm.fm_retrieval_scores(tt, cfg, idx[0, :4],
                                   torch.arange(50, dtype=torch.int32))
        serve_snap = obs.snapshot()["counters"]
        obs.reset()
        obs.enable()
        leaves = {k: t.detach().requires_grad_() for k, t in tt.items()}
        train = fm.fm_logits(leaves, cfg, idx)
        train_snap = obs.snapshot()["counters"]
    finally:
        obs.reset()
    key = "kernels.dispatch{impl=reference,kernel=%s}"
    assert serve_snap.get(key % "fm_gather_interaction") == 2
    assert key % "fm_interaction" not in serve_snap
    assert train_snap.get(key % "fm_interaction") == 1
    assert key % "fm_gather_interaction" not in train_snap
    want_serve = fmk.fm_gather_interaction_plain(
        idx, cfg.vocab_per_field, tt["v"], tt["w"], tt["b"])
    assert torch.equal(serve.view(torch.int32), want_serve.view(torch.int32))
    B = idx.shape[0]
    rows = (idx.long() + cfg.field_offsets()[None]).reshape(-1)
    today = (tt["b"] + tt["w"][rows].view(B, cfg.n_sparse).sum(dim=-1)
             + fmk.fm_interaction_plain(tt["v"][rows].view(
                 B, cfg.n_sparse, cfg.embed_dim).to(torch.float32)))
    assert train.requires_grad and train.dtype == torch.float32
    assert torch.equal(train.detach().view(torch.int32),
                       today.view(torch.int32))
    # the same route decides with grad mode on and no leaf asking
    again = fm.fm_logits(tt, cfg, idx)
    assert not again.requires_grad
    assert torch.equal(again.view(torch.int32), want_serve.view(torch.int32))


def test_fused_dispatch_checks_and_refusals():
    cfg = SMOKE
    _, _, tt = _tables(cfg, 0.3, "float32")
    idx = torch.from_numpy(_ids(cfg, 4, "int32"))
    before = dict(ops.launch_counts())
    ops.fm_gather_interaction(idx, cfg.vocab_per_field, tt["v"], tt["w"],
                              tt["b"])
    assert ops.launch_counts() == before            # no launch on the cpu
    with pytest.raises(ValueError, match="operands on"):
        ops.fm_gather_interaction(idx.to("meta"), 5, tt["v"], tt["w"],
                                  tt["b"])
    with pytest.raises(TypeError, match="int32 or int64"):
        fmk.fm_gather_interaction_plain(idx.to(torch.int16), 5, tt["v"],
                                        tt["w"], tt["b"])
    with pytest.raises(TypeError, match="one dtype"):
        fmk.fm_gather_interaction_cuda(idx, 5, tt["v"], tt["w"].double(),
                                       tt["b"])
    with pytest.raises(ValueError, match=r"idx \(B, F\)"):
        fmk.fm_gather_interaction_cuda(idx[0], 5, tt["v"], tt["w"], tt["b"])
    with pytest.raises(ValueError, match="rows"):
        fmk.fm_gather_interaction_cuda(idx, 5, tt["v"], tt["w"][:-1],
                                       tt["b"])
    # refused before any copy or launch: K > 256, a request whose ring
    # does not fit, B >= 2**31 (a stride-0 view, never materialised)
    wide = torch.zeros((8, 257))
    with pytest.raises(ValueError, match="does not fit"):
        fmk.fm_gather_interaction_cuda(idx[:, :1], 1, wide, wide[:, 0],
                                       wide[0, 0])
    with pytest.raises(ValueError, match="does not fit"):
        fmk.fm_gather_interaction_cuda(
            torch.zeros((1, 5000), dtype=torch.int32), 1, tt["v"], tt["w"],
            tt["b"])
    huge = torch.zeros((1, 2), dtype=torch.int32).expand(1 << 31, 2)
    with pytest.raises(ValueError, match="int32 request count"):
        fmk.fm_gather_interaction_cuda(huge, 1, tt["v"], tt["w"], tt["b"])
    assert ops.launch_counts() == before
    assert fmk.gather_shared_bytes(39, 10, 4) <= 232_448
    assert fmk.gather_shared_bytes(1, 256, 4) <= 232_448
