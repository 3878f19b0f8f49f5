"""fm_interaction: the FM 2-way term (Rendle, ICDM'10) by the sum-square
trick, ``out[b] = 0.5 * sum_k ((sum_f v[b,f,k])**2 - sum_f v[b,f,k]**2)``,
``v (B, F, K)`` float32 or bfloat16 -> ``(B,)`` float32.

Replaces the TPU kernel ``src/repro/kernels/fm_interaction.py:
fm_interaction`` (``_kernel``).  The JAX model calls the kernel's
reference directly; the port's model (``models/recsys/fm.py``) calls
`FMInteraction` for the pair term of every ``fm_logits`` batch and the
user's self-interaction in ``fm_retrieval_scores``, so the kernel serves
both on the card.

The order of summation is the contract.  Inputs are read as float32; for
each ``(b, k)``, ``s`` and ``s2`` sum ``v`` and ``v * v`` over ``f = 0..
F-1`` in order from +0.0; ``t_k = 0.5 * (s * s - s2)`` with one rounding
per operation; the output sums ``t_k`` over ``k = 0..K-1`` in order from
+0.0.  The plain version writes exactly that as loops of elementwise
tensor operations (no ``.sum()``, whose order PyTorch does not fix), and
the kernel uses ``__fadd_rn``/``__fmul_rn``/``__fsub_rn`` so that no add
is fused into an FMA: the two agree bit for bit at every shape.

Against the JAX reference the contract is a tolerance, and not a relative
one on the result: ``(sum v)**2`` and ``sum v**2`` nearly cancel, so at
the model's init scale (``normal * 0.01``) two orders of summation can
differ by far more than float32's epsilon of the result.  Their
difference stays a small multiple of epsilon times ``mag = 0.5 * sum_k
(s_k**2 + s2_k)``; the tests hold ``|port - jax| <= 4e-6 * (mag +
1e-30)`` (``tests/test_torch_fm_kernel.py``).

The gradient (`FMInteraction`) is the reference's autodiff in closed
form, ``d out_b / d v_bfk = s_bk - v_bfk``, in plain PyTorch with ``s``
recomputed from the saved ``v``: the JAX package has no backward kernel.

Bound on an H100: bytes, ``B F K`` elements read once and ``4 B`` bytes
written; 409,993,216 B at B 262,144 x F 39 x K 10 in f32, 0.122 ms at
3.35 TB/s.  Design (``csrc/fm_interaction.cu``): a 256-thread block
stages R consecutive rows (one contiguous span, coalesced) in shared
memory as float32, a thread per ``(row, k)`` walks ``f``, a thread per
row adds its K terms.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "fm_interaction"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's shared-memory budget: (F + 1) * K floats a row
_SHARED_BYTES = 48 * 1024


def field_sum(v32: torch.Tensor, *, square: bool = False) -> torch.Tensor:
    """``sum_f v32[:, f, :]`` (or of its squares) ``(B, K)`` float32,
    added in ascending ``f`` from +0.0."""
    B, F, K = v32.shape
    s = torch.zeros((B, K), dtype=torch.float32, device=v32.device)
    for f in range(F):
        x = v32[:, f]
        s = s + (x * x if square else x)
    return s


def fm_interaction_plain(v) -> torch.Tensor:
    """The kernel's function in plain PyTorch, bitwise its result."""
    _check(v)
    v32 = v.to(torch.float32)
    s = field_sum(v32)
    t = (s * s - field_sum(v32, square=True)) * 0.5
    out = torch.zeros(v.shape[0], dtype=torch.float32, device=v.device)
    for k in range(v.shape[2]):
        out = out + t[:, k]
    return out


def _check(v) -> None:
    if v.dim() != 3:
        raise ValueError(f"{KERNEL}: v must be (B, F, K), got shape "
                         f"{tuple(v.shape)}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"{KERNEL}: v must be float32 or bfloat16, got "
                        f"{v.dtype}")


def fm_interaction_cuda(v) -> torch.Tensor:
    _check(v)
    B, F, K = v.shape
    if 4 * K * (F + 1) > _SHARED_BYTES or K > 256:
        raise ValueError(f"{KERNEL}: a row of F {F} x K {K} does not fit "
                         f"the kernel's block (4 K (F + 1) <= 49,152 bytes, "
                         f"K <= 256)")
    if B >= 1 << 31:
        raise ValueError(f"{KERNEL}: B = {B} exceeds the kernel's int32 "
                         f"row count")
    v = v.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=v.device)
    if B == 0 or F * K == 0:
        return out.zero_()
    fn = C.bind(build.library("fm_interaction"), "repro_fm_interaction",
                (C.VOIDP, C.I32, C.VOIDP, C.I32, C.I32, C.I32, C.VOIDP))
    err = fn(v.data_ptr(), _DTYPES[v.dtype], out.data_ptr(), B, F, K,
             C.stream())
    C.launched(KERNEL, err)
    return out


def fm_interaction(v) -> torch.Tensor:
    """Dispatch without a gradient: the kernel for a CUDA ``v``, the plain
    version for a CPU one."""
    if C.impl_for(KERNEL, v) == "cuda":
        return fm_interaction_cuda(v)
    return fm_interaction_plain(v)


class FMInteraction(torch.autograd.Function):
    """`fm_interaction` with the reference's gradient: forward dispatches
    (the kernel on CUDA), backward is ``g[:, None, None] * (s[:, None, :]
    - v)`` with ``s`` recomputed from the saved ``v``."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return fm_interaction(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        v32 = v.to(torch.float32)
        s = field_sum(v32)
        return (g[:, None, None] * (s[:, None, :] - v32)).to(v.dtype)
