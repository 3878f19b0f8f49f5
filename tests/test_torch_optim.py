"""The port's optimizer, schedules and click stream (``repro_torch.optim``,
``repro_torch.data``) against the JAX package, and a short FM training
run in both.

Tolerances: AdamW's math is float32 in both, but XLA may fuse its
elementwise chain and its ``pow`` may differ from PyTorch's by an ulp, so
after several steps parameters and moments are held to rtol 1e-5 (atol
1e-7 for the moments, which start at zero; bf16 moments to one bf16 step,
rtol 2**-7).  Clipping and the schedules: rtol 1e-6.  The click stream is
numpy in both: identical.  The FM run (60 steps, as
``tests/test_recsys.py::test_fm_loss_decreases_with_training`` runs it:
in 20 steps both packages fall by less than the 0.02 it requires):
losses within 1e-5 of JAX's at every step (float32 gradients summed in
other orders, compounded over the steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import clicks as jclicks  # noqa: E402
from repro.models.recsys import fm as jfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clip as jclip  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.convert import fm_params_from_jax  # noqa: E402
from repro_torch.data import synthetic_click_batches  # noqa: E402
from repro_torch.models.recsys import fm  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule, linear_warmup, wsd_schedule,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal(11).astype(np.float32),
                    "c": np.float32(rng.standard_normal())}}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lr_scale", [1.0, 0.25])
def test_adamw_matches_jax(moment_dtype, lr_scale):
    cfg = AdamWConfig(lr=0.01, moment_dtype=moment_dtype)
    jcfg = jadamw.AdamWConfig(lr=0.01, moment_dtype=moment_dtype)
    p0 = _tree(0)
    tp, jp = _to_torch(p0), _to_jax(p0)
    ts, js = adamw_init(tp, cfg), jadamw.adamw_init(jp, jcfg)
    for i in range(6):
        g = _tree(10 + i)
        tp, ts = adamw_update(tp, _to_torch(g), ts, cfg,
                              lr_scale=torch.tensor(lr_scale))
        jp, js = jadamw.adamw_update(jp, _to_jax(g), js, jcfg,
                                     lr_scale=jnp.float32(lr_scale))
    assert int(ts["step"]) == int(js["step"]) == 6
    rtol = 1e-5 if moment_dtype == "float32" else 2.0 ** -7
    for (name, got), (_, want) in zip(_flat(tp), _flat(jp)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for m in ("mu", "nu"):
        for (name, got), (_, want) in zip(_flat(ts[m]), _flat(js[m])):
            assert str(got.dtype).endswith(moment_dtype)
            np.testing.assert_allclose(_np(got), _np(want), rtol=rtol,
                                       atol=1e-7, err_msg=f"{m} {name}")


def test_adamw_leaves_its_arguments_alone():
    cfg = AdamWConfig(lr=0.1)
    p = _to_torch(_tree(0))
    before = {k: v.clone() for k, v in _flat(p)}
    state = adamw_init(p, cfg)
    new_p, new_state = adamw_update(p, _to_torch(_tree(1)), state, cfg)
    for k, v in _flat(p):
        assert torch.equal(v, before[k])
    assert int(state["step"]) == 0 and not state["mu"]["a"].any()
    assert not torch.equal(new_p["a"], p["a"])
    assert int(new_state["step"]) == 1


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_in_place_equals_clip_then_update(moment_dtype,
                                                        monkeypatch):
    """`adamw_update_` (slices of 7 elements here) gives
    `clip_by_global_norm` + `adamw_update`'s bits, two steps running."""
    from repro_torch.optim import adamw, adamw_update_, global_norm_scale
    monkeypatch.setattr(adamw, "_SLICE", 7)
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(50, generator=g).to(torch.bfloat16),
              "b": [torch.randn(4, 6, generator=g)]}
    grads = {"a": torch.randn(50, generator=g).to(torch.bfloat16) * 4,
             "b": [torch.randn(4, 6, generator=g) * 4]}
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    want_p, want_s = params, adamw_init(params, cfg)
    got_p = {"a": params["a"].clone(), "b": [params["b"][0].clone()]}
    got_s = adamw_init(got_p, cfg)
    for _ in range(2):
        clipped, _ = clip_by_global_norm(grads, 1.0)
        want_p, want_s = adamw_update(want_p, clipped, want_s, cfg)
        scale, _ = global_norm_scale(grads, 1.0)
        adamw_update_(got_p, grads, got_s, cfg, scale)
    for got, want in ((got_p["a"], want_p["a"]),
                      (got_p["b"][0], want_p["b"][0]),
                      (got_s["mu"]["a"], want_s["mu"]["a"]),
                      (got_s["nu"]["b"][0], want_s["nu"]["b"][0])):
        assert torch.equal(got, want)
    assert int(got_s["step"]) == int(want_s["step"]) == 2


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    g = {k: v * np.float32(scale) if isinstance(v, np.ndarray) else v
         for k, v in _tree(3).items()}
    got, gn = clip_by_global_norm(_to_torch(g), 1.0)
    want, jn = jclip.clip_by_global_norm(_to_jax(g), 1.0)
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    for (name, a), (_, b) in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, err_msg=name)
    bf = clip_by_global_norm({"x": torch.ones(4, dtype=torch.bfloat16)}, 1.0)
    assert bf[0]["x"].dtype == torch.bfloat16 and float(bf[1]) == 2.0


def test_schedules_match_jax():
    for step in (0, 1, 5, 10, 37, 100, 250, 1000):
        ts, js = torch.tensor(step, dtype=torch.int32), jnp.int32(step)
        for got, want in (
                (linear_warmup(ts, 10), jsched.linear_warmup(js, 10)),
                (wsd_schedule(ts, warmup=10, stable=100, decay=50),
                 jsched.wsd_schedule(js, warmup=10, stable=100, decay=50)),
                (cosine_schedule(ts, warmup=10, total=300),
                 jsched.cosine_schedule(js, warmup=10, total=300))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step}")
    assert float(linear_warmup(3, 0)) == 1.0


@pytest.mark.parametrize("seed,shard", [(0, 0), (1, 0), (7, 3)])
def test_click_batches_equal_the_reference(seed, shard):
    args = (5, 40, 64, 3)
    got = list(synthetic_click_batches(*args, dim=3, seed=seed, shard=shard))
    want = list(jclicks.synthetic_click_batches(*args, dim=3, seed=seed,
                                                shard=shard))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.int32 and gl.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_fm_training_follows_jax_and_learns():
    """60 AdamW steps (lr 0.05, no decay) of ``FMConfig(4, 4, 32)`` on the
    click stream in both packages from the same initial table."""
    cfg = fm.FMConfig(n_sparse=4, embed_dim=4, vocab_per_field=32)
    jcfg = jfm.FMConfig(n_sparse=4, embed_dim=4, vocab_per_field=32)
    jp = jfm.init_fm(jax.random.PRNGKey(0), jcfg)
    tp = fm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    opt_cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    jopt_cfg = jadamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    topt, jopt = adamw_init(tp, opt_cfg), jadamw.adamw_init(jp, jopt_cfg)

    @jax.jit
    def jstep(p, opt, idx, labels):
        loss, grads = jax.value_and_grad(jfm.fm_loss)(p, jcfg, idx, labels)
        p, opt = jadamw.adamw_update(p, grads, opt, jopt_cfg)
        return p, opt, loss

    losses, jlosses = [], []
    for idx, labels in synthetic_click_batches(4, 32, 256, 60, seed=1):
        loss, grads = fm.fm_value_and_grad(tp, cfg, torch.from_numpy(idx),
                                           torch.from_numpy(labels))
        tp, topt = adamw_update(tp, grads, topt, opt_cfg)
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(idx),
                                jnp.asarray(labels))
        losses.append(float(loss))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.02
    np.testing.assert_allclose(tp["v"].numpy(), np.asarray(jp["v"]),
                               rtol=1e-4, atol=1e-5)
