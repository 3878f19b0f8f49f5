"""fm_interaction: the FM 2-way term (Rendle, ICDM'10) by the sum-square
trick, ``out[b] = 0.5 * sum_k ((sum_f v[b,f,k])**2 - sum_f v[b,f,k]**2)``,
``v (B, F, K)`` float32 or bfloat16 -> ``(B,)`` float32.

Replaces the TPU kernel ``src/repro/kernels/fm_interaction.py:
fm_interaction`` (``_kernel``).  The JAX model calls the kernel's
reference directly; the port's model (``models/recsys/fm.py``) calls
`FMInteraction` for the pair term of ``fm_logits`` when a gradient is
asked for, and `fm_gather_interaction` (below) for a serving call.

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

``fm_gather_interaction`` fuses the embedding gathers in front of it: the
FM logit ``b + sum_f w[row] + pair(v[row])`` of a request batch straight
from its ids ``idx (B, F)``, ``row = idx[b, f] + f * V``, in one launch
(the model's serving route, ``models/recsys/fm.py``).  Ids follow
``jnp.take``: a row in ``[-n, 0)`` wraps, any other outside ``[0, n)``
makes its request's logit NaN.  The pair term is the contract above on
the gathered rows; the linear term sums ``w[row]`` as float32 over
ascending ``f`` from +0.0 and rounds where PyTorch's promotion rounds in
``b + w.sum(-1) + pair``: ``(b + lin) + pair`` in float32,
``f32(bf16(b + bf16(lin))) + pair`` in bfloat16.  Its plain version
spells that out, so the kernel gives the same bits, NaN rows included.
Bound at serve_bulk (f32, int32 ids): 491,782,144 B read once, 0.147 ms
at 3.35 TB/s; random 40-byte rows move ~1.02 GB of 32-byte sectors, a
~0.306 ms floor (the source note works both out).  Design: a persistent
grid of blocks walking tiles of R requests, the tiles' rows copied by
``cp.async`` into a three-stage shared-memory ring, two tiles in flight
while one is reduced: no ``(B, F, K)`` tensor, no int64 row ids and no float32
copy of a bfloat16 table reach device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "fm_interaction"
KERNEL_GATHER = "fm_gather_interaction"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IDX_DTYPES = {torch.int32: 0, torch.int64: 1}
#: the kernel's shared-memory budget: (F + 1) * K floats a row
_SHARED_BYTES = 48 * 1024
#: the fused kernel's: a ring of three stages, in Hopper's 227 KB a block
_GATHER_STAGES, _GATHER_SHARED_BYTES = 3, 232_448


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
    with C.on_device(KERNEL, v, out) as stream:
        err = fn(v.data_ptr(), _DTYPES[v.dtype], out.data_ptr(), B, F, K,
                 stream)
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


def _check_gather(idx, v, w, b) -> None:
    if idx.dim() != 2 or v.dim() != 2 or w.dim() != 1 or b.dim() != 0:
        raise ValueError(
            f"{KERNEL_GATHER}: need idx (B, F), v (n, K), w (n,) and b (), "
            f"got {tuple(idx.shape)}, {tuple(v.shape)}, {tuple(w.shape)}, "
            f"{tuple(b.shape)}")
    if w.shape[0] != v.shape[0]:
        raise ValueError(f"{KERNEL_GATHER}: w has {w.shape[0]} rows, v "
                         f"{v.shape[0]}")
    if idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"{KERNEL_GATHER}: idx must be int32 or int64, got "
                        f"{idx.dtype}")
    if v.dtype not in _DTYPES or w.dtype != v.dtype or b.dtype != v.dtype:
        raise TypeError(f"{KERNEL_GATHER}: v, w and b must share one dtype, "
                        f"float32 or bfloat16, got {v.dtype}, {w.dtype}, "
                        f"{b.dtype}")


def fm_gather_interaction_plain(idx, vocab_per_field: int, v, w,
                                b) -> torch.Tensor:
    """The fused kernel's function in plain PyTorch, bitwise its result:
    ``b + sum_f w[row] + fm_interaction(v[row])`` with ``row = idx[:, f] +
    f * vocab_per_field`` gathered as ``jnp.take`` does, the linear term
    summed and rounded in the kernel's order."""
    _check_gather(idx, v, w, b)
    (B, F), (n, K) = idx.shape, v.shape
    rows = idx.to(torch.int64) + torch.arange(
        F, dtype=torch.int64, device=idx.device) * vocab_per_field
    inside = rows.clamp(-n, n - 1)
    safe = torch.remainder(inside, n).reshape(-1)
    pair = fm_interaction_plain(v.index_select(0, safe).view(B, F, K))
    w32 = w.index_select(0, safe).view(B, F).to(torch.float32)
    lin = torch.zeros(B, dtype=torch.float32, device=idx.device)
    for f in range(F):
        lin = lin + w32[:, f]
    b32 = b.to(torch.float32)
    if v.dtype == torch.bfloat16:
        lin = lin.to(torch.bfloat16).to(torch.float32)
        base = (b32 + lin).to(torch.bfloat16).to(torch.float32)
    else:
        base = b32 + lin
    return (base + pair).masked_fill((inside != rows).any(dim=1),
                                     float("nan"))


def gather_shared_bytes(F: int, K: int, itemsize: int) -> int:
    """The most shared memory the fused kernel's ring takes for a tile of
    one request (a row copied as the 4-byte words covering it)."""
    def r16(x):
        return -(-x // 16) * 16
    slot = -(-K * itemsize // 4) * 4 + 4
    stage = r16(r16(r16(F * slot) + 4 * F) + 8 * F)
    return _GATHER_STAGES * stage + 4 * K


def fm_gather_interaction_cuda(idx, vocab_per_field: int, v, w,
                               b) -> torch.Tensor:
    _check_gather(idx, v, w, b)
    (B, F), (n, K) = idx.shape, v.shape
    if K > 256 or gather_shared_bytes(F, K, v.element_size()) \
            > _GATHER_SHARED_BYTES:
        raise ValueError(f"{KERNEL_GATHER}: a request of F {F} x K {K} "
                         f"does not fit the kernel's block (K <= 256, its "
                         f"ring within 232,448 bytes of shared memory)")
    if B >= 1 << 31:
        raise ValueError(f"{KERNEL_GATHER}: B = {B} exceeds the kernel's "
                         f"int32 request count")
    idx, v, w = idx.contiguous(), v.contiguous(), w.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=v.device)
    if B == 0:
        return out
    fn = C.bind(build.library("fm_interaction"),
                "repro_fm_gather_interaction",
                (C.VOIDP, C.I32, C.VOIDP, C.VOIDP, C.VOIDP, C.I32, C.VOIDP,
                 C.I64, C.I32, C.I32, C.I64, C.I64, C.VOIDP))
    with C.on_device(KERNEL_GATHER, idx, v, w, b, out) as stream:
        err = fn(idx.data_ptr(), _IDX_DTYPES[idx.dtype], v.data_ptr(),
                 w.data_ptr(), b.data_ptr(), _DTYPES[v.dtype],
                 out.data_ptr(), B, F, K, int(vocab_per_field), n, stream)
    C.launched(KERNEL_GATHER, err)
    return out
