"""The port's LM training path (``repro_torch.models.transformer``
``lm_loss``, ``lm_value_and_grad``, remat, the chunked CE,
``prefill_chunked``; ``configs._lm_common.lm_smoke_step``) and the plain
attention backward (``kernels.flash_attention
.flash_attention_backward_plain``) against the JAX package, on the same
weights (the reference's ``init_lm`` carried across) and the same tokens.

Tolerance: ``|err| <= 1e-4 * (1 + |ref|)`` in float32 (PERF.md section 2),
for the loss and every gradient leaf: the same f32 arithmetic summed in
another order.  The bf16 caches of ``prefill_chunked`` within one bf16
step; the plain backward in bf16 within ``1e-2 * (1 + |ref|)`` of the f32
reference's (each gradient rounded to bf16 once, and the bf16 inputs'
output rounded once on the JAX side).  The JAX compilations run once per
module (module-scoped fixtures).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "h2o-danube-3-4b", "minicpm-2b",
         "moonshot-v1-16b-a3b", "grok-1-314b")
TOL = 1e-4
#: the reference's own small test config (tests/test_models_lm.py)
CFG = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
           vocab=128, remat=False)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=TOL, what=""):
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, what
    err = np.abs(g - w) / (1 + np.abs(w))
    assert err.max() <= tol, (what, err.max())


#: XLA's cheaper compile (the JAX side is the reference's arithmetic
#: either way; its compile time dominates these tests)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with `FAST`."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _init(jcfg):
    """The reference's ``init_lm`` at key 0, compiled once (eagerly it
    takes seconds)."""
    return _run(lambda key: jt.init_lm(key, jcfg), jax.random.PRNGKey(0))


def _port(jp):
    return lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _leaves(jtree):
    return jax.tree_util.tree_flatten_with_path(jtree)[0]


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.fixture(scope="module")
def smoke():
    """Per arch: the JAX smoke config, weights and tokens, its jitted
    ``lm_smoke_step`` and ``value_and_grad(lm_loss)`` on the smoke
    step's own tokens (one compilation each)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    key = jax.random.PRNGKey(3)
    for arch in ARCHS:
        jcfg = jax_arch(arch).smoke_config
        jp = _init(jcfg)

        def both(p, k, jcfg=jcfg, arch=arch):
            toks = jax.random.randint(k, (2, 16), 0, jcfg.vocab)
            labels = jnp.concatenate(
                [toks[:, 1:], jnp.full((2, 1), -1, toks.dtype)], axis=1)
            return (jax_arch(arch).smoke_step(p, jcfg, k),
                    jax.value_and_grad(jt.lm_loss)(p, jcfg, toks, labels))

        step, (loss, grads) = _run(both, jp, key)
        out[arch] = dict(jp=jp, step=step, loss=loss, grads=grads)
    torch.set_num_threads(prev)
    return out


def _smoke_tokens(cfg):
    toks = prng.randint(prng.PRNGKey(3), (2, 16), 0, cfg.vocab)
    labels = torch.cat([toks[:, 1:], torch.full((2, 1), -1,
                                                dtype=toks.dtype)], dim=1)
    return toks, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_value_and_grad_matches_jax(smoke, arch):
    """The loss and every gradient leaf of the five smoke configs: bias
    (qwen), window and GQA (danube), muP scales (minicpm), MoE with a
    bf16-free float32 router (moonshot, grok)."""
    ref_ = smoke[arch]
    cfg = get_arch(arch).smoke_config
    toks, labels = _smoke_tokens(cfg)
    loss, grads = tt.lm_value_and_grad(_port(ref_["jp"]), cfg, toks, labels)
    _close(loss, ref_["loss"], what="loss")
    leaves = _leaves(ref_["grads"])
    assert len(leaves) == len(list(tt.tree_leaves(grads)))
    for path, leaf in leaves:
        _close(_at(grads, path), leaf, what=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_smoke_step_matches_jax(smoke, arch):
    ref_ = smoke[arch]
    cfg = get_arch(arch).smoke_config
    out = get_arch(arch).smoke_step(_port(ref_["jp"]), cfg,
                                    prng.PRNGKey(3))
    want = ref_["step"]
    assert set(out) == set(want)
    for name in ("loss", "grad_norm", "prefill_logits"):
        _close(out[name], want[name], what=name)
    assert out["next_token"].tolist() == np.asarray(
        want["next_token"]).tolist()
    assert out["next_token"].dtype == torch.int32


def _small(**changes):
    jcfg = jt.LMConfig(**{**CFG, **changes})
    cfg = tt.LMConfig(**{**CFG, **changes})
    jp = _init(jcfg)
    return jcfg, cfg, jp, _port(jp)


def _toks(b, s, vocab, seed=1):
    toks = prng.randint(prng.PRNGKey(seed), (b, s), 0, vocab)
    assert np.array_equal(toks.numpy(), np.asarray(
        jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0, vocab)))
    return toks


def test_chunked_ce_matches_full_logits():
    """The reference's test on the port: the chunked CE (a chunk of 7
    over 24 positions) equals the full-logit CE."""
    _, cfg, _, tp = _small()
    toks = _toks(2, 24, cfg.vocab)
    labels = torch.cat([toks[:, 1:], torch.full((2, 1), -1,
                                                dtype=toks.dtype)], 1)
    with torch.no_grad():
        logits, aux = tt.lm_forward(tp, cfg, toks)
        logp = torch.log_softmax(logits.float(), -1)
        nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        mask = labels >= 0
        want = (nll * mask).sum() / mask.sum() + cfg.aux_loss_weight * aux
        got = tt.lm_loss(tp, cfg, toks, labels, ce_chunk=7)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.fixture(scope="module")
def ce_cells():
    """JAX's loss and gradients for the chunked-CE cells: S 24 with
    chunks of 4, 16 (24 is not a multiple) and S, and labels holding
    -1 in the middle and at the end."""
    jcfg = jt.LMConfig(**CFG)
    jp = _init(jcfg)
    toks = _toks(2, 24, jcfg.vocab, seed=2)
    labels = toks.clone()
    labels[0, 5] = labels[1, -3:] = -1
    jt_, jl = jnp.asarray(toks.numpy()), jnp.asarray(labels.numpy())

    def cells(p, t, lab):
        return {c: jax.value_and_grad(jt.lm_loss)(p, jcfg, t, lab, ce_chunk=c)
                for c in (4, 16, 24)}

    return dict(jp=jp, toks=toks, labels=labels, want=_run(cells, jp, jt_,
                                                           jl))


@pytest.mark.parametrize("ce_chunk", [4, 16, 24])
def test_chunked_ce_matches_jax(ce_cells, ce_chunk):
    cfg = tt.LMConfig(**CFG)
    loss, grads = tt.lm_value_and_grad(
        _port(ce_cells["jp"]), cfg, ce_cells["toks"], ce_cells["labels"],
        ce_chunk=ce_chunk)
    jloss, jgrads = ce_cells["want"][ce_chunk]
    _close(loss, jloss, what="loss")
    for path, leaf in _leaves(jgrads):
        _close(_at(grads, path), leaf, what=jax.tree_util.keystr(path))
    # the chunk is a memory knob, not a change of the loss
    _close(loss, ce_cells["want"][24][0], tol=1e-6, what="loss vs S")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "moonshot-v1-16b-a3b"])
def test_remat_equals_no_remat(arch):
    """Remat recomputes each layer in the backward: the same loss and
    gradients as keeping the activations."""
    cfg = get_arch(arch).smoke_config
    assert cfg.remat
    p = tt.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = _toks(2, 20, cfg.vocab)
    l1, g1 = tt.lm_value_and_grad(p, cfg, toks, toks)
    l2, g2 = tt.lm_value_and_grad(p, dataclasses.replace(cfg, remat=False),
                                  toks, toks)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    for (name, a), (_, b) in zip(tt.tree_leaves(g1), tt.tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


def test_lm_loss_leaves_params_alone_and_masks_every_label():
    _, cfg, _, tp = _small()
    toks = _toks(2, 8, cfg.vocab)
    before = {k: v.clone() for k, v in tt.tree_leaves(tp)}
    loss, grads = tt.lm_value_and_grad(tp, cfg, toks, torch.full_like(
        toks, -1))
    # no label counts: the loss is 0 / max(0, 1) and no gradient reaches
    # the head
    assert float(loss) == 0.0
    assert float(grads["lm_head"].abs().max()) == 0.0
    for k, v in tt.tree_leaves(tp):
        assert torch.equal(v, before[k]) and not v.requires_grad


PREFILL_CELLS = [
    (dict(), 8),
    (dict(n_kv_heads=4, n_experts=4, top_k=2, capacity_factor=8.0), 12),
    (dict(window=8), 8),
]


@pytest.mark.parametrize("changes,chunk", PREFILL_CELLS,
                         ids=["dense", "moe", "window"])
def test_prefill_chunked_matches_jax(changes, chunk):
    """The reference's chunked-prefill cells: logits and the bf16 cache
    against JAX's ``prefill_chunked``, and the logits against the port's
    own ``prefill`` within the reference's bound (0.06: the bf16 cache).
    The logits lie within ``1e-3 * (1 + |ref|)`` of JAX's, not the f32
    1e-4: the cache rounds every key and value to bf16, and one that the
    two frameworks round to neighbouring bf16 steps moves the later
    layers' scores by up to 2**-8 of its term (1.3e-4 seen on the MoE
    cell)."""
    jcfg, cfg, jp, tp = _small(**changes)
    toks = _toks(2, 24, cfg.vocab)
    jl, jc = _run(lambda p, t: jt.prefill_chunked(p, jcfg, t, chunk=chunk),
                  jp, jnp.asarray(toks.numpy()))
    with torch.no_grad():
        tl, tc = tt.prefill_chunked(tp, cfg, toks, chunk=chunk)
        whole, _ = tt.prefill(tp, cfg, toks)
    _close(tl, jl, tol=1e-3, what="logits")
    assert tc["len"] == int(jc["len"]) == 24
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16
        assert tuple(tc[name].shape) == jc[name].shape
        got = tc[name].float().numpy()
        want = np.asarray(jc[name], np.float32)
        step = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
        assert (np.abs(got - want) <= step).all(), name
    assert float((tl - whole).abs().max()) < 0.06
    with pytest.raises(ValueError, match="multiple"):
        tt.prefill_chunked(tp, cfg, toks, chunk=7)


def test_param_counts_match_jax():
    for arch in ARCHS:
        full, jfull = get_arch(arch).config, jax_arch(arch).config
        assert full.param_count() == jfull.param_count()
        assert full.active_param_count() == jfull.active_param_count()
        smoke = get_arch(arch).smoke_config
        assert smoke == tt.LMConfig(**dataclasses.asdict(
            jax_arch(arch).smoke_config))
        assert get_arch(arch).smoke_step is not None
        assert get_arch(arch).init_fn is tt.init_lm
    moon = get_arch("moonshot-v1-16b-a3b").config
    cut = dataclasses.replace(moon, n_layers=2)
    assert cut.param_count() == 1_812_211_712
    # the MoE count includes the router: what init_lm builds
    cfg = get_arch("grok-1-314b").smoke_config
    p = tt.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert sum(t.numel() for _, t in tt.tree_leaves(p)) == cfg.param_count()


# --------------------------------------------- the plain attention backward

#: (B, Hq, Hkv, Sq, Skv, D, window, causal): GQA, windows, ragged S, a
#: query block past the first (the backward walks blocks of rows)
BWD_CASES = [(2, 4, 2, 37, 37, 16, 0, True), (1, 6, 3, 45, 45, 8, 5, True),
             (1, 4, 1, 20, 50, 8, 7, True), (2, 2, 2, 10, 30, 8, 0, False),
             (1, 8, 2, 130, 130, 32, 0, True)]


@functools.lru_cache(maxsize=None)
def _bwd_cell(case):
    """f32 inputs of a backward case (bf16-representable, so that the
    f32 and bf16 cells share them) and ``jax.vjp`` of the reference's
    oracle there."""
    B, Hq, Hkv, Sq, Skv, D, window, causal = case
    rng = np.random.default_rng(Sq + D)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, Sq, D))]
    arrs = [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrs]

    def vjp(q, k, v, dout):
        _, pull = jax.vjp(lambda a, b, c: jref.attention_ref(
            a, b, c, causal=causal, window=window), q, k, v)
        return pull(dout)

    return arrs, _run(vjp, *(jnp.asarray(t.numpy()) for t in arrs))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_backward_plain(case, dtype, monkeypatch):
    B, Hq, Hkv, Sq, Skv, D, window, causal = case
    # blocks of a few rows, so that several query blocks and key spans run
    monkeypatch.setattr(fa, "_PLAIN_BLOCK_ELEMS", B * Hq * Skv * 16)
    arrs, jwant = _bwd_cell(case)
    q, k, v, dout = (t.to(dtype) for t in arrs)
    got = ref.flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                             window=window)
    tol = TOL if dtype == torch.float32 else 1e-2
    # torch autograd of the plain forward, on f32 copies
    f32 = [t.clone().requires_grad_() for t in arrs[:3]]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*f32, causal=causal, window=window), f32,
        arrs[3])
    for name, g, w, jw in zip("qkv", got, want, jwant):
        assert g.dtype == dtype and g.shape == w.shape
        _close(g, w.numpy(), tol=tol, what=f"d{name} vs torch")
        _close(g, jw, tol=tol, what=f"d{name} vs jax")
