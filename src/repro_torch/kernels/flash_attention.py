"""flash_attention: causal grouped-query attention with an online softmax
and an optional sliding window, ``q (B, Hq, Sq, D)``, ``k, v (B, Hkv, Skv,
D)`` -> ``(B, Hq, Sq, D)`` in q's dtype.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:72
flash_attention`` (``_kernel``): the prefill attention of the LM server,
one launch per layer.  The function is the TPU kernel's: scale
``1/sqrt(D)``; query ``i`` sits at absolute position ``i + Skv - Sq``
(queries right-aligned to the keys); key ``j`` is admitted when
``j < Skv``, ``j <= qpos`` (causal) and ``j > qpos - window``
(``window > 0``); query head ``h`` reads KV head ``h // (Hq // Hkv)``;
f32 or bf16 in, f32 softmax statistics and accumulators, the output cast
to q's dtype.

**Fully masked rows are refused.**  A query row with no admitted key
exists only when the mask is causal and ``Sq > Skv`` (or ``Skv == 0``).
There the TPU kernel returns the mean of V over every key slot it walked,
padding included, so its value depends on its tile size, and the
reference's oracle returns NaN: there is nothing to be equal to, so the
kernel's wrapper and the plain version both raise ``ValueError``.  The
serving path never has such a row (prefill has ``Sq == Skv``).

The equality contract is a tolerance, not bits: the kernel sums q.k and
p.v in another order than the plain version.  In f32 the two agree to
about 1e-6 relative; in bf16 the output's rounding adds up to one bf16
ulp (2**-8 relative), and the tensor-core kernel's rounding of P to bf16
a little more.  The tests hold the plain version to the reference at 1e-5
(f32, its oracle), 2e-3 (its interpreted Pallas kernel) and 3e-2 (bf16),
as ``tests/test_kernels.py`` holds the TPU kernel.

Bound on an H100: operations.  Each admitted ``(q, k)`` pair costs ``4 D``
flops; a ``(b, h)`` has ``Sq (Sq + 1) / 2`` pairs causal and
``sum_i min(i + 1, W)`` with a window ``W`` (`admitted_pairs`).  At the
bf16 tensor-core rate of 989 TFLOP/s, B 1 x 16 heads x S 32,768 x D 64
(2.2 TFLOP) takes 2.2 ms; its bytes take 0.04 ms at 3.35 TB/s.

**Two designs, chosen by dtype** (`design`), each the only route for its
dtype on a CUDA tensor:

- **bf16: ``csrc/flash_attention_tc.cu``**, for the bound above.  Both
  products are ``wgmma`` on the tensor cores (S = Q.K^T from shared
  memory, O += P.V with P in registers), fed by TMA: one producer thread
  loads Q once and K/V tiles into a ring of shared-memory stages with an
  mbarrier each, two consumer warpgroups of 64 query rows take them; tiles
  are 128-byte swizzled 64-column sub-tiles whose ragged edges (D 120,
  rows past Sq or Skv) TMA fills with zeros.  Only the tiles that straddle
  the diagonal, the window's edge or Skv are masked.  P is rounded to bf16
  as the A operand of P.V (the TPU kernel multiplies it in f32): a
  relative error of at most 2**-9 a term, inside the bf16 tolerance.  Left
  for later: a softmax/GEMM pingpong, GQA sharing of staged K/V, fp8, a
  backward kernel.
- **f32: ``csrc/flash_attention.cu``**, SIMT f32 FMAs (one block per
  ``(b * Hq + h, 64-query tile)``, K and V staged in shared memory as
  f32).  The tensor cores would round f32 operands to TF32, which the f32
  contract (1e-4, and f32 greedy tokens equal to the reference's) does not
  allow; its bound is the f32 rate of 67 TFLOP/s.

Every CUDA launch counts once under ``flash_attention`` and once under
``flash_attention:<design>`` (`_common.launch_counts`).

**The gradient** (`FlashAttention`, what `ops.flash_attention` calls on
the card): the forward is the kernel above; the backward is
`flash_attention_backward_plain`, plain PyTorch.  It is plain because
the reference has no backward kernel either: no function of the JAX
package differentiates a Pallas kernel with a kernel of its own (there
is no ``custom_vjp`` under ``src/repro``), so JAX differentiates its
attention through the plain ``ref``/blockwise paths.  A backward kernel
is a follow-up (ROADMAP B).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "flash_attention"

#: score elements the plain version holds at once (f32), per query block
_PLAIN_BLOCK_ELEMS = 1 << 27


def admitted_pairs(Sq: int, Skv: int, *, causal: bool = True,
                   window: int = 0) -> int:
    """The admitted ``(q, k)`` pairs of one ``(b, h)``: the work the
    kernel's function needs (``4 D`` flops each)."""
    qpos = torch.arange(Sq, dtype=torch.int64) + (Skv - Sq)
    hi = torch.minimum(qpos, torch.tensor(Skv - 1)) if causal else \
        torch.full_like(qpos, Skv - 1)
    lo = (qpos - window + 1).clamp(min=0) if window > 0 else \
        torch.zeros_like(qpos)
    return int((hi - lo + 1).clamp(min=0).sum())


def check_operands(q, k, v, causal: bool) -> None:
    """Shapes of the function, and no fully masked query row."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{KERNEL}: q, k, v must be (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or (Bk, Dk) != (B, D):
        raise ValueError(f"{KERNEL}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{KERNEL}: Hq = {Hq} is not a multiple of "
                         f"Hkv = {Hkv}")
    if Sq and (Skv == 0 or (causal and Sq > Skv)):
        raise ValueError(
            f"{KERNEL}: Sq = {Sq}, Skv = {Skv}, causal: some query rows "
            f"admit no key; the TPU kernel's value there depends on its "
            f"tile size and the oracle's is NaN, so neither is defined")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: repeat the KV heads, f32
    einsum, mask, softmax, f32 einsum, cast.  Walks query blocks so that
    at most ``_PLAIN_BLOCK_ELEMS`` f32 scores are live at once."""
    check_operands(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    kk = k.to(torch.float32).repeat_interleave(group, dim=1)
    vv = v.to(torch.float32).repeat_interleave(group, dim=1)
    kpos = torch.arange(Skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    step = max(1, _PLAIN_BLOCK_ELEMS // max(B * Hq * Skv, 1))
    for s0 in range(0, Sq, step):
        s1 = min(Sq, s0 + step)
        qpos = torch.arange(s0, s1, device=q.device) + (Skv - Sq)
        mask = torch.ones((s1 - s0, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.einsum("bhqd,bhkd->bhqk",
                         q[:, :, s0:s1].to(torch.float32), kk) * scale
        s.masked_fill_(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, :, s0:s1] = torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    return out


def _key_span(s0: int, s1: int, Sq: int, Skv: int, causal: bool,
              window: int) -> tuple[int, int]:
    """The keys ``[lo, hi)`` that query rows ``[s0, s1)`` may admit; every
    key outside is masked for all of them."""
    off = Skv - Sq
    hi = min(Skv, s1 + off) if causal else Skv
    lo = max(0, s0 + off - window + 1) if window > 0 else 0
    return lo, max(lo, hi)


def flash_attention_backward_plain(q, k, v, dout, *, causal: bool = True,
                                   window: int = 0):
    """``(dq, dk, dv)`` of the kernel's function at ``(q, k, v)`` for the
    output's cotangent ``dout``, in plain PyTorch: f32 throughout, each
    cast to its operand's dtype at the end.

    It walks query blocks as `flash_attention_plain` does (at most
    ``_PLAIN_BLOCK_ELEMS`` f32 scores live), over just the keys a block
    may admit (`_key_span`), and recomputes the scores ``S = q k^T /
    sqrt(D)`` and each row's logsumexp, so ``P = exp(S - lse)``.  Then
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP - delta)``, ``dQ = dS
    K / sqrt(D)`` and ``dK = dS^T Q / sqrt(D)``; dK and dV are summed over
    each KV head's query group.  Masked pairs have ``P = 0`` and give
    nothing.

    ``delta`` is each row's ``rowsum(P * dP)``, from the recomputed f32
    ``P``: in exact arithmetic it is ``rowsum(dO * O)``, but the kernel's
    output is rounded to bf16, and that rounding in ``delta`` put the
    bf16 gradients 4x further from the f32 ones (at 1 x 4 x 2,048 x 64,
    a bf16 output from the plain forward: 0.0089 of the 1e-2 bound,
    ``1 + |ref|`` relative, against 0.0022 this way).  So the output is
    not needed, and not saved."""
    check_operands(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    kk = k.to(f32).repeat_interleave(group, dim=1)
    vv = v.to(f32).repeat_interleave(group, dim=1)
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dkk = torch.zeros(kk.shape, dtype=f32, device=q.device)
    dvv = torch.zeros(vv.shape, dtype=f32, device=q.device)
    step = max(1, _PLAIN_BLOCK_ELEMS // max(B * Hq * Skv, 1))
    for s0 in range(0, Sq, step):
        s1 = min(Sq, s0 + step)
        lo, hi = _key_span(s0, s1, Sq, Skv, causal, window)
        if lo == hi:
            continue
        qpos = torch.arange(s0, s1, device=q.device) + (Skv - Sq)
        kpos = torch.arange(lo, hi, device=q.device)
        mask = torch.ones((s1 - s0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        qb = q[:, :, s0:s1].to(f32)
        kb, vb = kk[:, :, lo:hi], vv[:, :, lo:hi]
        dob = dout[:, :, s0:s1].to(f32)
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
        s.masked_fill_(~mask, float("-inf"))
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        del s
        dvv[:, :, lo:hi] += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
        delta = (p * dp).sum(dim=-1, keepdim=True)
        ds = p.mul_(dp.sub_(delta))
        del dp
        dq[:, :, s0:s1] = torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
        dkk[:, :, lo:hi] += torch.einsum("bhqk,bhqd->bhkd", ds, qb) * scale
    dk = dkk.view(B, Hkv, group, Skv, D).sum(dim=2)
    dv = dvv.view(B, Hkv, group, Skv, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """`flash_attention_cuda` with a gradient: the forward launches the
    kernel (``tc`` for bf16, ``simt`` for f32) and saves q, k and v; the
    backward is `flash_attention_backward_plain` on them.  A recompute
    under ``torch.utils.checkpoint`` runs the forward, and so launches the
    kernel, again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_cuda(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_plain(
            q, k, v, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary (the kernel's loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


#: the CUDA kernel of each dtype: bf16 on the tensor cores, f32 on SIMT
#: FMAs (the tensor cores would round f32 to TF32)
DESIGNS = {torch.bfloat16: "tc", torch.float32: "simt"}
#: the csrc source of each design; its C entry point is ``repro_<source>``,
#: and both take the same arguments
_SOURCE = {"tc": "flash_attention_tc", "simt": "flash_attention"}
#: query rows a tensor-core block takes, and CUDA's cap on a grid's
#: second axis (the SIMT grid is (query tiles, B * Hq), the tensor-core
#: one (B * Hq, query tiles))
_TC_BLOCK_Q, _GRID_MAX = 128, 65535


def design(q, k, v) -> str:
    """The kernel that a CUDA call on these operands runs: ``"tc"``
    (bf16) or ``"simt"`` (f32); raises on any other dtype."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DESIGNS:
        raise TypeError(f"{KERNEL}: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    return DESIGNS[q.dtype]


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    check_operands(q, k, v, causal)
    impl = design(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError(f"{KERNEL}: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D % 8 or not 0 < D <= 256:
        raise ValueError(f"{KERNEL}: head dim {D} must be a multiple of 8 "
                         f"up to 256")
    rows = B * Hq if impl == "simt" else -(-Sq // _TC_BLOCK_Q)
    if rows > _GRID_MAX:
        raise ValueError(f"{KERNEL}: {'B * Hq' if impl == 'simt' else 'Sq'}"
                         f" exceeds the {impl} kernel's grid ({rows} > "
                         f"{_GRID_MAX:,} blocks)")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    source = _SOURCE[impl]
    fn = C.bind(build.library(source), f"repro_{source}",
                (C.VOIDP, C.VOIDP, C.VOIDP, C.VOIDP) + (C.I32,) * 8
                + (ctypes.c_float, C.VOIDP))
    with C.on_device(KERNEL, q, k, v, out) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, Sq, Skv, D, int(bool(causal)),
                 max(int(window), 0), 1.0 / math.sqrt(D), stream)
    C.launched(KERNEL, err, impl)
    return out
