"""The port's LM serving path (``repro_torch.models.transformer`` and
``repro_torch.launch.serve.LMServer``) against the JAX package, from the
same weights (the reference's ``init_lm`` carried across by
``lm_params_from_jax``) and the same prompts, on the three dense smoke
configs.

Tolerances: f32 prefill logits and caches rtol 1e-4, atol 1e-5 (as
``tests/test_models_lm.py`` holds prefill against the forward pass: the
same f32 arithmetic summed in another order).  bf16 (Qwen's dtype at full
width): logits within 0.05 + 0.02|x|, and each layer's cache within 4
bf16 steps at the layer's largest magnitude (2**-5 of its scale).  Both
frameworks round every bf16 product to bf16 but may keep an intermediate
of a fused elementwise chain in f32, so single values land a step or two
apart, and the second layer starts from inputs that already differ (the
smoke config measured 2 steps there, 0.031 at magnitude 3.6).  Decode
caches (bf16 in both, whatever the model's dtype) within one bf16 ulp;
greedy tokens equal in f32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.launch.serve import LMServer as JaxServer  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "h2o-danube-3-4b", "minicpm-2b")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(arch, **changes):
    """(jax cfg, port cfg, jax params, port params) of a smoke config."""
    jcfg = dataclasses.replace(jax_arch(arch).smoke_config, **changes)
    cfg = dataclasses.replace(get_arch(arch).smoke_config, **changes)
    jp = jt.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")


def _prompts(B, S, vocab):
    toks = prng.randint(prng.PRNGKey(1), (B, S), 0, vocab)
    want = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, vocab)
    assert np.array_equal(toks.numpy(), np.asarray(want))
    return toks


def _f32(a):
    return np.asarray(a.to(torch.float32) if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


def _bf16_ulps(a, b):
    """Max distance in bf16 steps between two bf16 arrays."""
    def ordered(x):
        bits = (np.asarray(x, np.float32).view(np.int32) >> 16).astype(
            np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


def test_params_carry_across_leaf_for_leaf():
    jcfg, cfg, jp, tp = _pair("qwen1.5-0.5b")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == 1 + 11 + 2
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert np.array_equal(t.numpy(), np.asarray(leaf))
    bf = lm_params_from_jax(jax.tree.map(np.asarray, jt.init_lm(
        jax.random.PRNGKey(0), dataclasses.replace(jcfg, dtype="bfloat16"))),
        device="cpu")
    assert bf["layers"]["wq"].dtype == torch.bfloat16
    assert lm_params_from_jax({"w": np.ones(3, np.float32)}, device="cpu",
                              dtype=torch.bfloat16)["w"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_f32(arch):
    jcfg, cfg, jp, tp = _pair(arch)
    toks = _prompts(2, 12, cfg.vocab)
    jl, jc = jt.prefill(jp, jcfg, jnp.asarray(toks.numpy()))
    tl, tc = tt.prefill(tp, cfg, toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-4, atol=1e-5)
    assert tc["len"] == int(jc["len"]) == 12


def test_prefill_matches_jax_bf16():
    jcfg, cfg, jp, tp = _pair("qwen1.5-0.5b", dtype="bfloat16")
    toks = _prompts(2, 24, cfg.vocab)
    jl, jc = jt.prefill(jp, jcfg, jnp.asarray(toks.numpy()))
    tl, tc = tt.prefill(tp, cfg, toks)
    assert tl.dtype == torch.bfloat16 and tc["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0.02, atol=0.05)
    for name in ("k", "v"):
        for got, want in zip(_f32(tc[name]), _f32(jc[name])):   # layers
            step = np.spacing(np.float32(np.abs(want).max())) * 2.0 ** 16
            assert np.abs(got - want).max() <= 4 * step


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """Twelve steps from an empty cache: danube's 8-slot ring buffer
    wraps; tokens equal, bf16 caches within one ulp."""
    jcfg, cfg, jp, tp = _pair(arch)
    cache_len = cfg.window or 16
    toks = _prompts(2, 12, cfg.vocab)
    jc = jt.init_kv_cache(jcfg, 2, cache_len)
    tc = tt.init_kv_cache(cfg, 2, cache_len)
    dec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    for i in range(12):
        jn, jc = dec(jp, jc, jnp.asarray(toks[:, i:i + 1].numpy()))
        tn, tc = tt.decode_step(tp, cfg, tc, toks[:, i:i + 1])
        assert np.array_equal(tn.numpy(), np.asarray(jn)), i
        assert tc["len"] == int(jc["len"]) == i + 1
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16
        assert _bf16_ulps(_f32(tc[name]), _f32(jc[name])) <= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    jcfg, cfg, jp, tp = _pair(arch)
    toks = _prompts(2, 12, cfg.vocab)
    want = JaxServer(jcfg, jp, max_len=64).generate(
        jnp.asarray(toks.numpy()), 6)
    got = serve.LMServer(cfg, tp, max_len=64, device="cpu").generate(toks, 6)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()


def test_overflowing_full_cache_overwrites_the_last_slot():
    jcfg, cfg, jp, tp = _pair("qwen1.5-0.5b")
    toks = _prompts(2, 10, cfg.vocab)
    jc, tc = jt.init_kv_cache(jcfg, 2, 6), tt.init_kv_cache(cfg, 2, 6)
    dec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    for i in range(10):
        jn, jc = dec(jp, jc, jnp.asarray(toks[:, i:i + 1].numpy()))
        tn, tc = tt.decode_step(tp, cfg, tc, toks[:, i:i + 1])
        assert np.array_equal(tn.numpy(), np.asarray(jn)), i
    assert _bf16_ulps(_f32(tc["k"]), _f32(jc["k"])) <= 1


def test_forward_last_position_equals_prefill():
    _, cfg, _, tp = _pair("h2o-danube-3-4b")
    toks = _prompts(2, 20, cfg.vocab)
    full, aux = tt.lm_forward(tp, cfg, toks)
    last, _ = tt.prefill(tp, cfg, toks)
    assert aux == 0.0 and full.shape == (2, 20, cfg.vocab)
    torch.testing.assert_close(last, full[:, -1], rtol=1e-4, atol=1e-5)


def test_param_count_matches_jax_without_allocating():
    for arch in ARCHS:
        full = get_arch(arch).config
        assert full.param_count() == jax_arch(arch).config.param_count()
        assert full.head_dim == jax_arch(arch).config.head_dim
        assert full == get_arch(arch).config      # frozen, nothing built
    assert get_arch("qwen1.5-0.5b").config.param_count() == 619_496_448
    # and it counts what init_lm builds (at smoke size)
    for arch in ARCHS:
        cfg = get_arch(arch).smoke_config
        p = tt.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
        n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
        bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
            * cfg.n_layers if cfg.qkv_bias else 0
        assert n == cfg.param_count() + bias


def test_init_lm_is_seeded_and_scaled():
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").smoke_config,
                              dtype="bfloat16")
    a = tt.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = tt.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert a["embed"].dtype == torch.bfloat16
    assert abs(float(a["embed"].float().std()) - 0.02) < 0.002
    assert a["layers"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                       cfg.n_heads * cfg.head_dim)
    assert float(a["layers"]["bq"].abs().sum()) == 0.0


@pytest.mark.parametrize("arch", ("moonshot-v1-16b-a3b", "grok-1-314b"))
def test_moe_serves_like_jax(arch):
    """The MoE smoke configs served: prefill logits and cache within the
    f32 tolerance of JAX's, and greedy tokens equal to the reference
    server's (decode routes B = 2 tokens with a capacity of 1 slot an
    expert, so choices drop there as in the reference)."""
    jcfg, cfg, jp, tp = _pair(arch)
    toks = _prompts(2, 12, cfg.vocab)
    jl, jc = jt.prefill(jp, jcfg, jnp.asarray(toks.numpy()))
    tl, tc = tt.prefill(tp, cfg, toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-4, atol=1e-5)
    want = JaxServer(jcfg, jp, max_len=64).generate(
        jnp.asarray(toks.numpy()), 6)
    got = serve.LMServer(cfg, tp, max_len=64, device="cpu").generate(toks, 6)
    assert got.tolist() == np.asarray(want).tolist()


def test_server_defaults_to_cuda():
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    if torch.cuda.is_available():
        assert serve.LMServer(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.LMServer(cfg)
    assert serve.LMServer(cfg, device="cpu").device.type == "cpu"


def test_cli_serves_on_the_cpu_and_refuses_unported_workloads(capsys):
    out = serve.main(["--device", "cpu", "--arch", "h2o-danube-3-4b",
                      "--batch", "2", "--prompt-len", "10", "--gen", "4"])
    assert tuple(out.shape) == (2, 4)
    assert "h2o-danube-3-4b on cpu" in capsys.readouterr().out
    # --workload im and tier are ported (A6, A7), and their mesh (A8b):
    # like the engines, a mesh of the card refuses without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--workload", "im", "--mesh", "4"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--workload", "tier", "--mesh", "4"])
