"""The ``fm_interaction`` CUDA kernel and the FM model on the card, held
to the plain PyTorch version on the same inputs: the kernel bitwise (the
order of summation is its contract), the model's logits, gradients and a
clipped AdamW step within the tolerances of ``tests/test_torch_fm.py``
(the kernel's pair term is bitwise, the gathers, sums and ``index_add_``
of the rest run in other orders on the card).

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
    assert ops.launch_counts().get("fm_interaction") == 1
    want = fm.fm_logits(host, cfg, idx)
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
