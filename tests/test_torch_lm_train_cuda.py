"""LM training on the card: the attention kernels' gradient and the MoE
FFN, held to the plain path on the same inputs.

- ``FlashAttention`` (the kernel forward, the backward kernels:
  ``csrc/flash_attention_bwd_tc.cu`` for bf16, ``csrc/flash_attention_bwd.cu``
  for f32) against autograd of ``flash_attention_plain``: f32 on the SIMT
  kernels within ``1e-4 * (1 + |ref|)``, bf16 on the tensor-core kernels
  against the plain version on f32 copies within ``1e-2 * (1 + |ref|)``
  (the bf16 bound of ``chip_smoke.py``'s ``ATTN_TOL``: q, k, v and dO are
  bf16 operands, P enters dV as two bf16 parts, dS is rounded once, and
  each gradient is rounded to bf16 once; delta is summed from the
  recomputed f32 P); at D 8 to 256, GQA up to 48:8, ragged S, Sq
  < Skv and a window narrower than a tile; the forward's logsumexp against
  the plain one (1e-5); two backward calls give the same bits, also with
  dQ summed over many key blocks in a fixed order, and in f32 over
  thousands of blocks; the f32 kernels (delta from the forward's output,
  64-row tiles, 32 at D 256) at their tiles' edges: S 127 to 129 and
  1,025, a window narrower than a tile, Sq < Skv, D 8 and 256, GQA 48:8,
  no causal mask; the backward launches its kernel and never the plain
  version;
- ``lm_loss`` and every gradient leaf of the five smoke configs on cuda
  against cpu within ``1e-4 * (1 + |cpu|)`` (the f32 LM tolerance), and
  the repair this slice made: on CUDA tensors the q, k and v projections
  (and their biases) get gradients, through the kernel;
- the MoE dispatch's sentinel slot: heavy drops and decode's capacity of
  1 index no buffer past its end (a device-side assert would end the
  process's CUDA context).

Every test needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package:
``python -m pytest -q -m cuda tests/test_torch_lm_train_cuda.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

pytestmark = pytest.mark.cuda

ARCHS = ("qwen1.5-0.5b", "h2o-danube-3-4b", "minicpm-2b",
         "moonshot-v1-16b-a3b", "grok-1-314b")
ATTN_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LM_TOL = 1e-4

# (B, Hq, Hkv, S, D, window): D 64, 120 and 128, GQA, windows, ragged S;
# D 8 and 16 (the smoke widths) and 256, grok's 48:8, a window narrower
# than a tile; S a pair (Sq, Skv) for queries right-aligned to more keys
GRAD_CASES = [(2, 4, 4, 256, 64, 0), (1, 8, 2, 300, 64, 0),
              (2, 4, 2, 129, 120, 16), (1, 4, 1, 333, 120, 0),
              (2, 4, 4, 200, 128, 0), (1, 8, 2, 257, 128, 50),
              (2, 4, 2, 77, 8, 0), (1, 6, 3, 150, 16, 5),
              (1, 2, 2, 130, 256, 0), (1, 4, 1, 200, 256, 70),
              (1, 48, 8, 140, 128, 0), (2, 4, 2, (100, 300), 64, 0),
              (1, 4, 1, (70, 200), 120, 40)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    return float(((g - w).abs() / (1 + w.abs())).max())


def _attention_inputs(B, Hq, Hkv, S, D, dtype, seed):
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(h, s):
        return torch.randn((B, h, s, D), generator=g,
                           device="cuda").to(dtype)

    return draw(Hq, Sq), draw(Hkv, Skv), draw(Hkv, Skv), draw(Hq, Sq)


def _kernel_grads(q, k, v, dout, window):
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, window=window)
    return torch.autograd.grad(out, (qg, kg, vg), dout)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_attention_gradient_matches_plain(cuda, B, Hq, Hkv, S, D,
                                                window, dtype):
    seed = sum(S) if isinstance(S, tuple) else S
    q, k, v, dout = _attention_inputs(B, Hq, Hkv, S, D, dtype,
                                      seed + D + window)
    ops.reset_launches()
    got = _kernel_grads(q, k, v, dout, window)
    counts = ops.launch_counts()
    assert counts.get("flash_attention") == 1
    assert counts.get(fa.BWD_KERNEL) == 1
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*ref, window=window), ref, dout.float())
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _rel(a, b) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("Sq,Skv,D,window", [(300, 300, 64, 0),
                                             (70, 200, 120, 40)])
def test_forward_lse_matches_plain(cuda, dtype, Sq, Skv, D, window):
    """The logsumexp the forward writes for a gradient, against the
    plain version's (the output is the one written without it)."""
    q, k, v, _ = _attention_inputs(1, 4, 2, (Sq, Skv), D, dtype, 11)
    out, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, 4, Sq)
    want, _ = fa.flash_attention_stats_plain(q, k, v, window=window)
    assert _rel(lse, want) <= 1e-5
    alone, none = fa.forward_cuda(q, k, v, window=window)
    assert none is None and torch.equal(out, alone)


# (B, Hq, Hkv, S, D, window), f32 at the SIMT kernels' tile edges: S one
# below, at and above 128 rows (two 64-row tiles) and 1,025; a window
# narrower than a tile; Sq < Skv (with a window too); D 8, 120 and 256
# (32-row tiles); grok's 48:8; the last case without the causal mask
F32_EDGE_CASES = [(2, 4, 2, 127, 64, 0), (2, 4, 2, 128, 64, 0),
                  (2, 4, 2, 129, 64, 0), (1, 4, 2, 1025, 64, 0),
                  (1, 4, 2, 300, 64, 9), (2, 4, 2, (65, 257), 64, 0),
                  (1, 4, 1, (100, 1025), 64, 30), (2, 4, 2, 129, 8, 0),
                  (1, 4, 2, (70, 200), 120, 40), (1, 4, 2, 129, 256, 0),
                  (1, 2, 1, (33, 97), 256, 20), (1, 48, 8, 257, 64, 0),
                  (1, 4, 2, (50, 90), 32, 16)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", F32_EDGE_CASES)
def test_f32_backward_tile_edges_match_plain(cuda, B, Hq, Hkv, S, D,
                                             window):
    """The f32 gradient, one SIMT backward launch, within ``1e-4 * (1 +
    |ref|)`` of autograd through the plain version."""
    causal = (B, Hq, Hkv, S, D, window) != F32_EDGE_CASES[-1]
    q, k, v, dout = _attention_inputs(B, Hq, Hkv, S, D, torch.float32,
                                      23 + D + window)
    ops.reset_launches()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.FlashAttention.apply(qg, kg, vg, causal, window)
    got = torch.autograd.grad(out, (qg, kg, vg), dout)
    assert ops.launch_counts().get(f"{fa.BWD_KERNEL}:simt") == 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*ref, causal=causal, window=window), ref,
        dout)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= ATTN_TOL[torch.float32]


# (B, Hq, Hkv, S, D, window) of the bitwise test: GQA with a window; in
# f32 also 4 x 16 heads x 2,048 (2,048 dQ blocks of 64 rows, 512 dK/dV)
BITWISE_SHAPE, BITWISE_MANY = (2, 8, 2, 600, 64, 100), (4, 16, 4, 2048, 64,
                                                        0)


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, BITWISE_SHAPE), (torch.float32, BITWISE_SHAPE),
    (torch.float32, BITWISE_MANY)], ids=["bf16", "f32", "f32-many-blocks"])
def test_backward_gives_the_same_bits_twice(cuda, dtype, shape):
    """No atomics: two backward calls on the same inputs agree bit for
    bit, as a TrainLoop's bitwise replay needs."""
    B, Hq, Hkv, S, D, window = shape
    q, k, v, dout = _attention_inputs(B, Hq, Hkv, S, D, dtype, 3)
    first = _kernel_grads(q, k, v, dout, window)
    again = _kernel_grads(q, k, v, dout, window)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# (B, Hq, Hkv, S, D, window), bf16: at D <= 64 many key blocks add their
# dQ shares into each query tile in turn: S 2,048 causal; GQA 48:8 at S
# 1,024; 1,024 key blocks of work (8 x 16 heads x S 1,024), far more
# than the card's SMs, so that a block waits on shares from blocks that
# started long before it; a window's first block, and Sq < Skv with it.
# Above D 64 (the dQ pass): grok's 48:8 at D 128, a window at D 120 and
# Sq < Skv at D 256
ORDERED_CASES = [(1, 4, 4, 2048, 64, 0), (1, 48, 8, 1024, 64, 0),
                 (8, 16, 16, 1024, 64, 0), (1, 8, 2, 2048, 64, 700),
                 (2, 4, 2, (1000, 2100), 64, 500), (1, 48, 8, 1024, 128, 0),
                 (1, 8, 2, 2048, 120, 700),
                 (2, 4, 2, (1000, 2100), 256, 500)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", ORDERED_CASES)
def test_backward_ordered_dq_sums_match_plain_and_repeat(cuda, B, Hq, Hkv,
                                                         S, D, window):
    """dQ summed across the key blocks in a fixed order: the gradient
    within the bf16 bound of the plain one, and two calls bitwise."""
    q, k, v, dout = _attention_inputs(B, Hq, Hkv, S, D, torch.bfloat16, 17)
    ops.reset_launches()
    got = _kernel_grads(q, k, v, dout, window)
    assert ops.launch_counts().get(f"{fa.BWD_KERNEL}:tc") == 1
    again = _kernel_grads(q, k, v, dout, window)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*ref, window=window), ref, dout.float())
    for a, b in zip(got, want):
        assert _rel(a, b) <= ATTN_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype,impl", [(torch.bfloat16, "tc"),
                                        (torch.float32, "simt")])
def test_backward_launches_its_kernel_never_the_plain(cuda, monkeypatch,
                                                      dtype, impl):
    """bf16 goes to the wgmma backward, f32 to the SIMT one; the plain
    backward is never called (a sentinel in its place raises)."""
    def sentinel(*a, **kw):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(fa, "flash_attention_backward_plain", sentinel)
    q, k, v, dout = _attention_inputs(1, 4, 2, 130, 64, dtype, 7)
    ops.reset_launches()
    _kernel_grads(q, k, v, dout, 0)
    counts = {key: n for key, n in ops.launch_counts().items() if n}
    assert counts == {"flash_attention": 1, f"flash_attention:{impl}": 1,
                      fa.BWD_KERNEL: 1, f"{fa.BWD_KERNEL}:{impl}": 1}


def _params(cfg, device):
    p = tt.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    return tt._tree_map(lambda t: t.to(device), p)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_cuda_match_cpu(cuda, arch):
    cfg = get_arch(arch).smoke_config
    toks = prng.randint(prng.PRNGKey(4), (2, 41), 0, cfg.vocab)
    res = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launches()
        loss, grads = tt.lm_value_and_grad(
            _params(cfg, dev), cfg, toks[:, :-1].to(dev), toks[:, 1:].to(dev))
        res[dev] = (loss.cpu(), {"/".join(k): g
                                for k, g in tt.tree_leaves(grads)},
                    ops.launch_counts().get("flash_attention", 0))
    (lc, gc, nc), (lh, gh, nh) = res["cuda"], res["cpu"]
    # remat on: each layer's forward launches, and its recompute again
    assert (nc, nh) == (2 * cfg.n_layers, 0)
    assert _rel(lc, lh) <= LM_TOL
    assert gc.keys() == gh.keys()
    for name in gh:
        assert _rel(gc[name].cpu(), gh[name]) <= LM_TOL, name


def test_cuda_lm_loss_gives_the_qkv_gradients(cuda):
    """The repair: the kernel's route carries q, k and v's gradient (its
    wrapper once wrote into a fresh tensor with no backward, which would
    have left wq, wk, wv and the biases without one)."""
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").smoke_config,
                              remat=False)
    toks = prng.randint(prng.PRNGKey(5), (2, 33), 0, cfg.vocab)
    grads, launches = {}, {}
    for dev in ("cuda", "cpu"):
        ops.reset_launches()
        _, g = tt.lm_value_and_grad(_params(cfg, dev), cfg,
                                    toks[:, :-1].to(dev), toks[:, 1:].to(dev))
        grads[dev] = g["layers"]
        launches[dev] = ops.launch_counts().get("flash_attention", 0)
    assert launches == {"cuda": cfg.n_layers, "cpu": 0}
    for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
        got, want = grads["cuda"][name], grads["cpu"][name]
        assert float(want.abs().max()) > 0, name
        assert _rel(got.cpu(), want) <= LM_TOL, name


@pytest.mark.parametrize("T,cf,drops", [(64, 0.05, True), (4, 1.25, None),
                                        (37, 0.5, True), (512, 1.25, None)])
def test_moe_sentinel_slot_stays_in_range(cuda, T, cf, drops):
    """Heavy drops, a capacity of 1 (decode's B 4 over 64 experts) and a
    whole prefill's tokens: every dropped choice lands in the sentinel row
    and the cuda result equals the cpu's."""
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").smoke_config,
                              n_experts=64, top_k=6, capacity_factor=cf)
    p = tt._layers(_params(cfg, "cpu"))[0]
    x = torch.randn((T, cfg.d_model),
                    generator=torch.Generator().manual_seed(T))
    out = {}
    for dev in ("cuda", "cpu"):
        pd = {k: t.to(dev) for k, t in p.items()}
        r = moe.route(x.to(dev), pd["router"], cfg.n_experts, cfg.top_k, cf)
        y, aux = tt._moe_ffn(pd, x.to(dev), cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (r, y.cpu(), aux.cpu())
    rc, rh = out["cuda"][0], out["cpu"][0]
    assert rc.C == rh.C == moe.capacity(cf, cfg.top_k, T, cfg.n_experts)
    if drops:
        assert not bool(rh.keep.all())
    assert torch.equal(rc.gate_idx.cpu(), rh.gate_idx)
    assert torch.equal(rc.slot_token.cpu(), rh.slot_token)
    assert _rel(out["cuda"][1], out["cpu"][1]) <= LM_TOL
    assert _rel(out["cuda"][2], out["cpu"][2]) <= LM_TOL
