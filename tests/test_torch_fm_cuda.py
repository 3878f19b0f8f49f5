"""The ``fm_interaction`` and ``fm_gather_interaction`` CUDA kernels and
the FM model on the card, held to the plain PyTorch versions on the same
inputs: both kernels bitwise (the order of summation is their contract;
the fused one's NaN rows in the same places), the model's serving logits
bitwise the CPU's (one fused launch a call), its gradients and a clipped
AdamW step within the tolerances of ``tests/test_torch_fm.py`` (the
training route's gathers, sums and ``index_add_`` run in other orders on
the card).

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed: ``python -m pytest -q -m cuda tests/test_torch_fm_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fm_interaction as fmk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.recsys import fm  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
)

pytestmark = pytest.mark.cuda

WIDE = fm.FMConfig(n_sparse=39, embed_dim=10, vocab_per_field=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _batch(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape) * 0.01
    return torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))


def _bits(t):
    return t.cpu().view(torch.int32)


@pytest.mark.parametrize("B,F,K", [(1, 39, 10), (512, 39, 10),
                                   (1025, 39, 10), (1025, 6, 4),
                                   (77, 16, 8), (3, 8, 4), (5, 3, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_is_the_plain_version_bitwise(cuda, B, F, K, dtype):
    v = _batch((B, F, K), dtype, seed=B + K).to(cuda)
    ops.reset_launches()
    got = ops.fm_interaction(v)
    assert ops.launch_counts().get("fm_interaction") == 1
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(fmk.fm_interaction_plain(v)))
    assert torch.equal(_bits(got), _bits(fmk.fm_interaction_plain(v.cpu())))


def test_kernel_takes_views_and_refuses_what_it_cannot(cuda):
    v = _batch((40, 10, 39), "float32", seed=3).to(cuda).transpose(1, 2)
    assert not v.is_contiguous()
    assert torch.equal(_bits(fmk.fm_interaction_cuda(v)),
                       _bits(fmk.fm_interaction_plain(v.cpu())))
    assert fmk.fm_interaction_cuda(v[:0]).shape == (0,)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fm_interaction(v.half())
    with pytest.raises(ValueError, match="does not fit"):
        fmk.fm_interaction_cuda(torch.zeros((1, 2000, 8), device=cuda))
    with pytest.raises(ValueError, match="operands on"):
        fmk.fm_interaction(torch.zeros((1, 2, 2), device="meta"))


def _params(cfg):
    rng = np.random.default_rng(0)
    return {"v": torch.from_numpy((rng.standard_normal(
                (cfg.total_rows, cfg.embed_dim)) * 0.01).astype(np.float32)),
            "w": torch.from_numpy((rng.standard_normal(cfg.total_rows)
                                   * 0.1).astype(np.float32)),
            "b": torch.tensor(0.3)}


def test_model_on_the_card_matches_the_cpu(cuda):
    cfg, B = WIDE, 256
    host = _params(cfg)
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, cfg.vocab_per_field,
                                        (B, cfg.n_sparse)).astype(np.int32))
    labels = torch.from_numpy((rng.random(B) < 0.5).astype(np.float32))
    dev = {k: t.to(cuda) for k, t in host.items()}
    ops.reset_launches()
    got = fm.fm_logits(dev, cfg, idx.to(cuda)).cpu()
    assert ops.launch_counts().get("fm_gather_interaction") == 1
    assert not ops.launch_counts().get("fm_interaction")
    want = fm.fm_logits(host, cfg, idx)
    assert torch.equal(_bits(got), _bits(want))
    rows = (idx.long() + cfg.field_offsets()[None]).reshape(-1)
    v = host["v"][rows].double().view(B, cfg.n_sparse, -1)
    s = v.sum(1)
    scale = (0.5 * (s * s + (v * v).sum(1)).sum(-1)
             + host["w"][rows].double().view(B, -1).abs().sum(-1) + 0.3)
    assert ((got.double() - want.double()).abs() <= 4e-6 * scale).all()

    opt_cfg = AdamWConfig(lr=0.05)
    out = {}
    for name, p, i, y in (("cuda", dev, idx.to(cuda), labels.to(cuda)),
                          ("cpu", host, idx, labels)):
        loss, grads = fm.fm_value_and_grad(p, cfg, i, y)
        clipped, _ = clip_by_global_norm(grads, 1.0)
        new_p, _ = adamw_update(p, clipped, adamw_init(p, opt_cfg), opt_cfg)
        out[name] = (float(loss), {k: g.cpu() for k, g in grads.items()},
                     {k: t.cpu() for k, t in new_p.items()})
    (lc, gc, pc), (lh, gh, ph) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-6
    for k in ("v", "w", "b"):
        bound = 1e-5 * gh[k].abs() + 1e-6 * gh[k].abs().max()
        assert ((gc[k] - gh[k]).abs() <= bound).all(), k
        assert ((pc[k] - ph[k]).abs() <= 1e-4 * ph[k].abs() + 1e-5).all(), k


# --------------------------------------------- fm_gather_interaction ----

#: (B, F, K, vocab a field, dtype): the smoke's kernel-row shapes at a
#: small vocabulary (the full table is chip_smoke.py's), the retrieval
#: constant (B 1 x F 4), F/K 6/4 and 16/8, and K 5 in bf16 (10-byte rows,
#: copied as the 4-byte words that cover them)
FUSED = [(512, 39, 10, 1000, "float32"), (512, 39, 10, 1000, "bfloat16"),
         (1, 4, 10, 1000, "float32"), (1, 4, 10, 1000, "bfloat16"),
         (1025, 39, 10, 777, "float32"), (1025, 6, 4, 50, "float32"),
         (1025, 16, 8, 33, "bfloat16"), (300, 7, 5, 101, "bfloat16"),
         (4096, 39, 10, 20_000, "bfloat16"), (3, 2, 256, 9, "float32")]


def _fused_inputs(B, F, K, V, dtype, idx_dtype, seed, device):
    rng = np.random.default_rng(seed)
    n = F * V
    t = {"v": rng.standard_normal((n, K)) * 0.01,
         "w": rng.standard_normal(n) * 0.1, "b": np.array(0.3)}
    t = {k: torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
         .to(device) for k, a in t.items()}
    idx = rng.integers(0, V, (B, F)).astype(idx_dtype)
    if B > 3:
        idx[1, 0] = -1                          # wraps to row n - 1
        idx[2, F - 1] = V                       # past the table: NaN
        idx[3, 0] = -n - 1                      # below -n: NaN
    return torch.from_numpy(idx).to(device), t


def _same_bits(got, want):
    """Equal bits where the plain version is a number, NaN where it is."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("B,F,K,V,dtype", FUSED)
@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
def test_fused_kernel_is_the_plain_version_bitwise(cuda, B, F, K, V, dtype,
                                                   idx_dtype):
    idx, t = _fused_inputs(B, F, K, V, dtype, idx_dtype, seed=B + K,
                           device=cuda)
    ops.reset_launches()
    got = ops.fm_gather_interaction(idx, V, t["v"], t["w"], t["b"])
    assert ops.launch_counts().get("fm_gather_interaction") == 1
    torch.cuda.synchronize()
    want = fmk.fm_gather_interaction_plain(idx, V, t["v"], t["w"], t["b"])
    _same_bits(got, want)
    host = {k: a.cpu() for k, a in t.items()}
    _same_bits(got, fmk.fm_gather_interaction_plain(
        idx.cpu(), V, host["v"], host["w"], host["b"]))
    if B > 3:
        assert torch.isnan(got.cpu()).nonzero().flatten().tolist() == [2, 3]


def test_fused_kernel_reads_a_misaligned_bf16_table(cuda):
    """A bf16 table whose rows start 2 bytes past a 4-byte boundary (a
    view one element in): every row copied as its covering words."""
    idx, t = _fused_inputs(700, 39, 10, 500, "bfloat16", "int32", seed=5,
                           device=cuda)
    flat = torch.zeros(t["v"].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    flat[1:] = t["v"].reshape(-1)
    v = flat[1:].view_as(t["v"])
    assert v.data_ptr() % 4 == 2
    got = ops.fm_gather_interaction(idx, 500, v, t["w"], t["b"])
    _same_bits(got, fmk.fm_gather_interaction_plain(idx, 500, t["v"],
                                                    t["w"], t["b"]))


def test_fm_serving_calls_are_one_fused_launch(cuda):
    """fm_logits without a gradient and the retrieval constant launch
    fm_gather_interaction once each and nothing else of the port; a
    gradient step launches fm_interaction once and no fused kernel."""
    cfg = WIDE
    p = {k: t.to(cuda) for k, t in _params(cfg).items()}
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, cfg.vocab_per_field,
                                        (64, cfg.n_sparse)).astype(
        np.int32)).to(cuda)
    ops.reset_launches()
    with torch.no_grad():
        fm.fm_logits(p, cfg, idx)
    fm.fm_logits(p, cfg, idx.long())        # no leaf asks for a gradient
    fm.fm_retrieval_scores(p, cfg, idx[0, :4],
                           torch.arange(100, device=cuda))
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    assert counts == {"fm_gather_interaction": 3}
    ops.reset_launches()
    labels = torch.ones(64, device=cuda)
    fm.fm_value_and_grad(p, cfg, idx, labels)
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    assert counts == {"fm_interaction": 1}


def test_fused_refusals_raise_before_any_launch(cuda):
    idx, t = _fused_inputs(8, 4, 4, 10, "float32", "int32", seed=0,
                           device=cuda)
    ops.reset_launches()
    wide = torch.zeros((8, 257), device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        fmk.fm_gather_interaction_cuda(idx[:, :1], 1, wide, wide[:, 0],
                                       wide[0, 0])
    with pytest.raises(ValueError, match="does not fit"):
        fmk.fm_gather_interaction_cuda(
            torch.zeros((1, 5000), dtype=torch.int32, device=cuda), 1,
            t["v"], t["w"], t["b"])
    huge = torch.zeros((1, 2), dtype=torch.int32, device=cuda).expand(
        1 << 31, 2)
    with pytest.raises(ValueError, match="int32 request count"):
        fmk.fm_gather_interaction_cuda(huge, 1, t["v"], t["w"], t["b"])
    with pytest.raises(TypeError, match="one dtype"):
        ops.fm_gather_interaction(idx, 10, t["v"], t["w"].bfloat16(),
                                  t["b"])
    with pytest.raises(TypeError, match="int32 or int64"):
        ops.fm_gather_interaction(idx.short(), 10, t["v"], t["w"], t["b"])
    assert not any(ops.launch_counts().values())
    assert fmk.fm_gather_interaction_cuda(idx[:0], 10, t["v"], t["w"],
                                          t["b"]).shape == (0,)
    assert not any(ops.launch_counts().values())


def test_bf16_serving_allocates_no_f32_batch(cuda):
    """A bf16 table's serving call allocates its output and nothing of
    the (B, F, K) batch: its peak stays below one float32 (B, F, K)
    tensor and below the unfused chain (gathers, float32 copy,
    unfused kernel) at the same batch."""
    B, F, K, V = 65_536, 39, 10, 10_000
    idx, t = _fused_inputs(B, F, K, V, "bfloat16", "int32", seed=9,
                           device=cuda)
    cfg = fm.FMConfig(n_sparse=F, embed_dim=K, vocab_per_field=V)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        del out
        return extra

    def unfused():
        rows = (idx.long() + cfg.field_offsets(cuda)[None]).reshape(-1)
        v, w = fm._gather(t, rows)
        pair = fmk.fm_interaction_cuda(v.view(B, F, K).to(torch.float32))
        return t["b"] + w.view(B, F).sum(dim=-1) + pair

    with torch.no_grad():
        fused = peak(lambda: fm.fm_logits(t, cfg, idx))
        chain = peak(unfused)
    assert fused < B * F * K * 4 < chain
    assert fused <= 4 * B + (1 << 20)
