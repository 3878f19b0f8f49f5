"""The ``flash_attention`` CUDA kernels on the card, held to the plain
PyTorch version on the same inputs: bf16 through the tensor-core kernel
(``csrc/flash_attention_tc.cu``) within ``1e-2 * (1 + |ref|)``, f32
through the SIMT kernel within ``1e-4 * (1 + |ref|)``, the bounds of
``chip_smoke.py``'s ``ATTN_TOL``; and an out-of-range id in the FM and LM
gathers, which gives NaN where the reference does and leaves the CUDA
context alive for the next launch.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed: ``python -m pytest -q -m cuda tests/test_torch_attention_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}

# (B, Hq, Hkv, Sq, Skv, D, window): D 8 to 256, GQA 4:1 and 2:1, windows,
# decode-shaped Sq 1, Sq not a multiple of 64 or 128, Sq < Skv; then the
# SIMT kernel's tiles (64 query rows below Sq 1,024, 128 from it, 64-key
# stages): one past a query and a key tile's edge, windows that are and
# are not a multiple of the key tile, Sq 1 against 4,097 keys at D 256,
# D 8 and D 120 at Sq 300, and the 128-row tile at D 64 and D 120
CASES = [
    (4, 16, 16, 512, 512, 64, 0), (2, 4, 2, 1000, 1000, 64, 0),
    (4, 16, 16, 1, 512, 64, 0), (2, 4, 4, 100, 1000, 64, 64),
    (2, 4, 2, 77, 77, 16, 8), (1, 4, 1, 300, 300, 120, 0),
    (1, 2, 2, 130, 130, 256, 0), (3, 2, 1, 65, 65, 8, 5),
    (1, 4, 2, 129, 129, 128, 64), (1, 8, 2, 700, 1500, 120, 300),
    (2, 2, 1, 200, 333, 256, 50), (1, 4, 4, 1, 1, 64, 0),
    (1, 4, 2, 129, 129, 64, 0), (1, 4, 2, 257, 4097, 64, 0),
    (1, 4, 2, 1000, 1000, 64, 192), (1, 4, 2, 1000, 1000, 64, 200),
    (1, 4, 1, 1, 4097, 256, 0), (1, 4, 2, 300, 300, 8, 0),
    (2, 4, 2, 300, 300, 120, 0), (1, 4, 2, 1025, 1025, 64, 0),
    (1, 4, 2, 1153, 4097, 120, 0), (1, 2, 2, 1100, 1100, 120, 1000),
]


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


def _qkv(B, Hq, Hkv, Sq, Skv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(h, s):
        return torch.randn((B, h, s, D), generator=g, device="cuda").to(dtype)
    return draw(Hq, Sq), draw(Hkv, Skv), draw(Hkv, Skv)


def _check(got, want, dtype):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(g).all())
    err = float(((g - w).abs() / (1 + w.abs())).max())
    assert err <= TOL[dtype], err
    return err


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window", CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, window, dtype):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, dtype, seed=Sq + D + window)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, window=window)
    impl = "tc" if dtype == torch.bfloat16 else "simt"
    counts = ops.launch_counts()
    assert counts.get("flash_attention") == 1
    assert counts.get(f"flash_attention:{impl}") == 1
    assert counts.get(f"flash_attention:{({'tc', 'simt'} - {impl}).pop()}",
                      0) == 0
    _check(got, fa.flash_attention_plain(q, k, v, window=window), dtype)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window", [
    (1, 4, 2, 1025, 1025, 64, 0), (2, 4, 2, 300, 300, 120, 100)])
def test_f32_lse_matches_plain_and_repeats(cuda, B, Hq, Hkv, Sq, Skv, D,
                                           window):
    """The SIMT kernel's logsumexp (what the f32 backward reads) within
    ``1e-5 * (1 + |ref|)`` of the plain version's, and two calls give
    the same bits, output and lse."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, torch.float32, seed=Sq + window)
    out, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)
    out2, lse2 = fa.forward_cuda(q, k, v, window=window, with_lse=True)
    want, _ = fa.flash_attention_stats_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    err = float(((lse - want).abs() / (1 + want.abs())).max())
    assert err <= 1e-5, err
    _check(out, fa.flash_attention_plain(q, k, v, window=window),
           torch.float32)


# (B, Hq, Hkv, Sq, Skv, D, window) for the tensor-core kernel's logsumexp
# and repeats, on its tiles (128 queries a block, two warpgroups of 64;
# 128 keys a tile, 64 at D 256): D 8, 64, 120, 128 and 256; GQA 4:1; Sq
# 1,050 (the last block's second warpgroup holds no row); Sq < Skv at an
# offset of 64 (the first warpgroup skips each block's last tile) and of
# 800 with a window of 300 whose edge falls inside a tile; a window of 150
# (the second warpgroup skips each block's first tile); Sq 4,096 (rows of
# 31 interior tiles, unmasked)
LSE_CASES = [
    (3, 2, 1, 77, 77, 8, 5), (1, 4, 1, 1050, 1050, 64, 0),
    (1, 4, 2, 2048, 2112, 64, 0), (1, 8, 2, 700, 1500, 120, 300),
    (2, 4, 2, 1100, 1100, 128, 150), (1, 2, 2, 300, 364, 256, 0),
    (1, 4, 4, 4096, 4096, 64, 0), (1, 4, 1, 1000, 1000, 128, 0),
    (1, 2, 1, 640, 640, 256, 100),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window", LSE_CASES)
def test_bf16_lse_matches_plain_and_repeats(cuda, B, Hq, Hkv, Sq, Skv, D,
                                            window):
    """The tensor-core kernel's logsumexp (what the bf16 backward reads)
    within ``1e-4 * (1 + |ref|)`` of the plain version's (f32 scores of
    the same operands, summed in another order, and exponentials by
    ``ex2.approx``), its output within the bf16 bound, and two calls give
    the same bits, output and lse, and the output of a call without lse."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, torch.bfloat16, seed=Sq + D)
    out, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)
    out2, lse2 = fa.forward_cuda(q, k, v, window=window, with_lse=True)
    out3 = fa.flash_attention_cuda(q, k, v, window=window)
    want, _ = fa.flash_attention_stats_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(out, out3)
    err = float(((lse - want).abs() / (1 + want.abs())).max())
    assert err <= 1e-4, err
    _check(out, fa.flash_attention_plain(q, k, v, window=window),
           torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_non_causal_and_views(cuda, dtype):
    q, k, v = _qkv(2, 4, 2, 50, 90, 32, dtype, seed=1)
    _check(ops.flash_attention(q, k, v, causal=False, window=16),
           fa.flash_attention_plain(q, k, v, causal=False, window=16), dtype)
    # strided views and an offset base are copied to aligned operands
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    big = torch.zeros(k.numel() + 3, dtype=dtype, device="cuda")
    ko = big[3:].view(k.shape)
    ko.copy_(k)
    _check(ops.flash_attention(qt, ko, v),
           fa.flash_attention_plain(q, k, v), dtype)


def test_scores_far_apart(cuda):
    """Large logits: the online softmax's rescaling over many tiles (a
    row's max moves by hundreds) stays within the tolerance."""
    q, k, v = _qkv(1, 2, 2, 600, 600, 64, torch.float32, seed=3)
    ramp = torch.linspace(0, 12, 600, device="cuda")[None, None, :, None]
    q, k = (q * 4).bfloat16(), (k * ramp).bfloat16()
    v = v.bfloat16()
    _check(ops.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
           torch.bfloat16)


def test_refusals_on_cuda(cuda):
    q, k, v = _qkv(1, 2, 2, 8, 4, 16, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="admit no key"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 2, 2, 8, 8, 12, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())


def test_fm_out_of_range_id_keeps_the_context(cuda):
    """An id past the table gives a NaN logit for its request only, and
    the next launch runs: no device-side assert."""
    from repro_torch.models.recsys import fm

    cfg = fm.FMConfig(n_sparse=3, embed_dim=4, vocab_per_field=8)
    params = fm.init_fm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    idx = torch.tensor([[0, 1, 2], [7, 7, 8], [-1, 2, 3]], device="cuda")
    logits = fm.fm_logits(params, cfg, idx)
    torch.cuda.synchronize()
    assert torch.isnan(logits).tolist() == [False, True, False]
    host = {k: t.cpu() for k, t in params.items()}
    want = fm.fm_logits(host, cfg, idx.cpu())
    assert torch.equal(torch.isnan(want), torch.isnan(logits.cpu()))
    scores = fm.fm_retrieval_scores(params, cfg, idx[0],
                                    torch.tensor([0, 24, -25], device="cuda"))
    assert torch.isnan(scores).tolist() == [False, True, True]
    ops.reset_launches()
    again = fm.fm_logits(params, cfg, idx[:1])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(again).all())
    assert ops.launch_counts().get("fm_gather_interaction") == 1


def test_lm_out_of_range_token_keeps_the_context(cuda):
    """A token equal to ``vocab`` makes its row's logits NaN in prefill and
    in decode; the other row is served, and the next prefill runs."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import (decode_logits, init_lm,
                                                prefill)

    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    tokens[1, 5] = cfg.vocab
    logits, cache = prefill(params, cfg, tokens.cuda())
    torch.cuda.synchronize()
    assert torch.isnan(logits).any(-1).tolist() == [False, True]
    assert bool(torch.isfinite(logits[0]).all())
    step = torch.tensor([[3], [cfg.vocab]], device="cuda")
    full = dict(cache, k=torch.nn.functional.pad(cache["k"], (0, 0, 0, 4)),
                v=torch.nn.functional.pad(cache["v"], (0, 0, 0, 4)))
    out, _ = decode_logits(params, cfg, full, step)
    torch.cuda.synchronize()
    assert torch.isnan(out[:, 0]).any(-1).tolist() == [False, True]
    again, _ = prefill(params, cfg, tokens[:1].cuda())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(again).all())
