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
  mbarrier each, consumer warpgroups of 64 query rows take them (three at
  D <= 128, 192 queries a block; two at D 256); tiles are 128-byte
  swizzled 64-column sub-tiles whose ragged edges (D 120, rows past Sq or
  Skv) TMA fills with zeros.  A warpgroup issues a tile's S with the
  previous tile's P.V and runs the tile's softmax (``ex2.approx``) under
  that P.V and the other warpgroups' products; only the tiles that
  straddle the diagonal, the window's edge or Skv run the masked softmax,
  compiled apart.  P is rounded to bf16 as the A
  operand of P.V (the TPU kernel multiplies it in f32): a relative error
  of at most 2**-9 a term, inside the bf16 tolerance.  Left for later:
  GQA sharing of staged K/V, a TMA store of the output, persistent
  blocks, fp8.
- **f32: ``csrc/flash_attention.cu``**, SIMT f32 FMAs.  The tensor
  cores would round f32 operands to TF32, which the f32 contract (1e-4,
  and f32 greedy tokens equal to the reference's) does not allow; its
  bound is the f32 rate of 67 TFLOP/s (2.05 ms at 1 x 16 x 8,192 x 64).
  One block of 256 threads per (query tile, ``b * Hq + h``), the grid one
  axis of them, heaviest tiles first; a thread owns 8 query rows (4 below
  Sq 1,024, where the tile is 64 queries, not 128) by 4 keys of S and the
  same rows of O, so every operand is a conflict-free 16-byte
  shared-memory load, 8 wavefronts a warp per 64 FMAs at D 64; K and V
  stream through two 64-key shared-memory stages filled by
  ``cp.async``, each landing while the other product runs; only the
  tiles on the diagonal or a window edge evaluate the mask; P is
  ``ex2.approx`` of one FMA.  Registers, spills and blocks an SM: the
  source's header.

Every CUDA launch counts once under ``flash_attention`` and once under
``flash_attention:<design>`` (`_common.launch_counts`).

**The gradient** (`FlashAttention`, what `ops.flash_attention` calls on
the card) has a kernel of each design too, though the reference has
none (JAX differentiates its plain attention; there is no ``custom_vjp``
under ``src/repro``): the function is `flash_attention_backward_plain`'s.
For a gradient the forward also writes each row's logsumexp
(`flash_attention_stats_plain` is its plain version); the backward
(`flash_attention_backward_cuda`) takes it and recomputes P in f32.  Each
design takes ``delta`` (``rowsum(P * dP)``, equal to ``rowsum(dO * O)``
in exact arithmetic) where its output allows: bf16 sums it from the
recomputed P, as the plain version does, since its output is rounded;
f32 from its output, which is not, so `FlashAttention` saves it:

- **bf16: ``csrc/flash_attention_bwd_tc.cu``**, ``wgmma`` + TMA on the
  forward's building blocks (``csrc/hopper_tc.cuh``): a delta pass (a
  block keeps its query rows' Q and dO and walks their key tiles once),
  then a dK/dV pass (a block keeps 128 keys' K and V and walks the
  group's query heads and the query tiles that admit its keys) that also
  forms each tile's share of dQ and adds it into an f32 sum in device
  memory, the key blocks of a query tile in ascending order (a counter a
  tile says whose turn it is), and an epilogue that rounds the sums to
  bf16.  P enters dV as two bf16 parts (the rounding and its residue:
  rounded once it puts dV past the bf16 bound at GQA 48:8); dS is
  rounded once, but for dK above D 64 (two parts: once, it put dk past
  the bound at grok's heads).  16 D flops a pair at D <= 64, 22 D above,
  against the gradient's 10 D.
- **f32: ``csrc/flash_attention_bwd.cu``**, SIMT f32 FMAs on the
  forward's tiling (8 own rows by 4 walked rows a thread at D <= 64,
  conflict-free 16-byte shared loads, the walked tiles in two
  ``cp.async`` stages, the mask on edge tiles only, P by ``ex2`` of one
  FMA): a dQ pass whose
  prologue sums ``delta = rowsum(dO * O)`` from the saved f32 output and
  which then walks its key tiles once, and a dK/dV pass; 14 D flops a
  pair.

Neither adds in an order that changes from call to call: two backward
calls on the same inputs give the same bits, as a `TrainLoop`'s bitwise
replay needs.  Every backward counts
once under ``flash_attention_bwd`` and ``flash_attention_bwd:<design>``,
not under ``flash_attention``.  `flash_attention_backward_plain` stays as
the plain version, for the tests and as a yardstick.
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


def _plain_forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """The f32 output and, given ``with_lse``, the rows' logsumexp,
    walking query blocks so that at most ``_PLAIN_BLOCK_ELEMS`` f32
    scores are live at once."""
    check_operands(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    group = Hq // k.shape[1]
    kk = k.to(torch.float32).repeat_interleave(group, dim=1)
    vv = v.to(torch.float32).repeat_interleave(group, dim=1)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    Skv, scale = kk.shape[2], 1.0 / math.sqrt(D)
    kpos = torch.arange(Skv, device=q.device)
    step = max(1, _PLAIN_BLOCK_ELEMS // max(B * Hq * Skv, 1))
    for s0 in range(0, Sq, step):
        s1 = min(Sq, s0 + step)
        qpos = torch.arange(s0, s1, device=q.device) + (Skv - Sq)
        mask = torch.ones((s1 - s0, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, s0:s1].to(torch.float32),
                         kk) * scale
        s.masked_fill_(~mask, float("-inf"))
        if with_lse:
            lse[:, :, s0:s1] = torch.logsumexp(s, dim=-1)
        out[:, :, s0:s1] = torch.einsum("bhqk,bhkd->bhqd",
                                        torch.softmax(s, dim=-1), vv)
    return out, lse


def flash_attention_stats_plain(q, k, v, dout=None, *, causal: bool = True,
                                window: int = 0):
    """``(lse, delta)``, ``(B, Hq, Sq)`` f32 each: every row's logsumexp
    of its scaled, masked scores (natural log), which the forward kernel
    writes for a gradient, and, given the output's cotangent ``dout``,
    ``delta = rowsum(dout * O)`` with O the f32 output, which the f32
    backward kernel's dQ pass sums so from the forward's output and the
    bf16 one as ``rowsum(P * dP)`` (equal in exact arithmetic); None
    without ``dout``."""
    out, lse = _plain_forward(q, k, v, causal, window, True)
    delta = None if dout is None else (dout.to(torch.float32) * out).sum(-1)
    return lse, delta


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: repeat the KV heads, f32
    einsum, mask, softmax, f32 einsum, cast.  Walks query blocks so that
    at most ``_PLAIN_BLOCK_ELEMS`` f32 scores are live at once."""
    return _plain_forward(q, k, v, causal, window, False)[0].to(q.dtype)


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
    not needed here; the f32 kernel takes delta from its f32 output."""
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
    """The kernels with a gradient: the forward launches
    `flash_attention_cuda`'s kernel (``tc`` for bf16, ``simt`` for f32),
    which also writes the rows' logsumexp when an input needs a gradient,
    and saves q, k, v and it, and for f32 its output too (the f32
    backward's delta); the backward launches
    `flash_attention_backward_cuda`.  A recompute under
    ``torch.utils.checkpoint`` runs the forward, and so launches the
    kernel, again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = forward_cuda(q, k, v, causal=causal, window=window,
                                with_lse=any(ctx.needs_input_grad[:3]))
        keep = (out,) if lse is not None and design(q, k, v) == "simt" \
            else ()
        ctx.save_for_backward(q, k, v, lse, *keep)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, *keep = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(
            q, k, v, lse, dout, causal=ctx.causal, window=ctx.window,
            out=keep[0] if keep else None)
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
#: the backward's name in the launch counts, and its sources
BWD_KERNEL = "flash_attention_bwd"
_BWD_SOURCE = {"tc": "flash_attention_bwd_tc", "simt": "flash_attention_bwd"}
#: the fewest query rows a tensor-core block takes (192 at D <= 128, 128
#: at D 256), and CUDA's cap on a grid's second axis (the tensor-core grid
#: is (B * Hq, query tiles))
_TC_BLOCK_Q, _GRID_MAX = 128, 65535
#: the SIMT forward's smallest query tile, and CUDA's cap on a grid's
#: first axis, where that kernel puts its B * Hq * query tiles blocks
_SIMT_BLOCK_Q, _GRID_X_MAX = 64, 2**31 - 1
#: the backward's smallest tile of rows; the tensor-core grids are
#: (heads, tiles), each SIMT grid one axis of heads x tiles
_BWD_TILE = {"tc": 64, "simt": 32}


def design(q, k, v) -> str:
    """The kernel that a CUDA call on these operands runs: ``"tc"``
    (bf16) or ``"simt"`` (f32); raises on any other dtype."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DESIGNS:
        raise TypeError(f"{KERNEL}: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    return DESIGNS[q.dtype]


def _launch_checks(q, k, v, causal: bool) -> str:
    """What every launch of either direction needs of q, k and v: the
    function's shapes, one dtype of the two designs, one device, a head
    dim the kernels take and a forward grid CUDA can launch; the
    design."""
    check_operands(q, k, v, causal)
    impl = design(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError(f"{KERNEL}: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}")
    B, Hq, Sq, D = q.shape
    if D % 8 or not 0 < D <= 256:
        raise ValueError(f"{KERNEL}: head dim {D} must be a multiple of 8 "
                         f"up to 256")
    if impl == "simt":
        what, blocks, cap = ("B * Hq * query tiles",
                             B * Hq * -(-Sq // _SIMT_BLOCK_Q), _GRID_X_MAX)
    else:
        what, blocks, cap = "Sq", -(-Sq // _TC_BLOCK_Q), _GRID_MAX
    if blocks > cap:
        raise ValueError(f"{KERNEL}: {what} exceeds the {impl} kernel's "
                         f"grid ({blocks:,} > {cap:,} blocks)")
    return impl


def forward_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                 with_lse: bool = False):
    """``(out, lse)``: the kernel's output and, given ``with_lse``, each
    row's logsumexp of its scaled, masked scores, ``(B, Hq, Sq)`` f32,
    which `flash_attention_backward_cuda` takes; without it lse is None
    and the kernel writes none."""
    impl = _launch_checks(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    source = _SOURCE[impl]
    fn = C.bind(build.library(source), f"repro_{source}",
                (C.VOIDP,) * 5 + (C.I32,) * 8 + (ctypes.c_float, C.VOIDP))
    with C.on_device(KERNEL, q, k, v, out) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq,
                 Skv, D, int(bool(causal)), max(int(window), 0),
                 1.0 / math.sqrt(D), stream)
    C.launched(KERNEL, err, impl)
    return out, lse


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    return forward_cuda(q, k, v, causal=causal, window=window)[0]


def _bwd_workspace_words(impl: str, B: int, Hq: int, Sq: int,
                         D: int) -> int:
    """4-byte words of the backward's scratch, which the C entry point
    carves: the rows' delta (``(B, Hq, Sq)`` f32); for ``tc`` also, each
    part on a 16-byte boundary, the counters (a ticket, then one a dq_acc
    chunk; the entry point zeroes them) and, at D <= 64, dq_acc, the f32
    sums of dQ's shares in 64 x 64 chunks (B * Hq heads x query tiles of
    64), which the kernel fills (``csrc/flash_attention_bwd_tc.cu``
    ``carve``)."""
    rows = B * Hq * Sq
    if impl != "tc":
        return rows
    chunks = B * Hq * -(-Sq // 64) if D <= 64 else 0

    def up4(n):
        return -(-n // 4) * 4

    return up4(rows) + up4(1 + chunks) + chunks * 64 * 64


def flash_attention_backward_cuda(q, k, v, lse, dout, *,
                                  causal: bool = True, window: int = 0,
                                  out=None):
    """``(dq, dk, dv)`` in the operands' dtype, on the design's backward
    kernels: ``lse`` is the rows' logsumexp from `forward_cuda` with
    ``with_lse``, ``dout`` the output's cotangent in q's dtype, and for
    f32 ``out`` the forward's output on these operands, whose
    ``rowsum(dout * out)`` is delta (bf16 takes none: it sums delta from
    P).  The operand, head-dim and grid checks are the forward's; one call
    of the C entry point (all of the design's passes) counts once under
    ``flash_attention_bwd`` and ``flash_attention_bwd:<design>``."""
    impl = _launch_checks(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if dout.dtype != q.dtype or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"{BWD_KERNEL}: dout {tuple(dout.shape)} "
                         f"{dout.dtype} does not match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Sq):
        raise ValueError(f"{BWD_KERNEL}: lse must be float32 {(B, Hq, Sq)},"
                         f" got {tuple(lse.shape)} {lse.dtype}")
    if impl == "simt":
        if out is None or out.dtype != torch.float32 or \
                tuple(out.shape) != tuple(q.shape):
            got = "none" if out is None else \
                f"{tuple(out.shape)} {out.dtype}"
            raise ValueError(f"{BWD_KERNEL}: the f32 backward takes delta "
                             f"from the forward's output: out must be "
                             f"float32 {tuple(q.shape)}, got {got}")
    elif out is not None:
        raise ValueError(f"{BWD_KERNEL}: the bf16 backward sums delta from "
                         f"P and takes no out")
    tiles = -(-max(Sq, Skv) // _BWD_TILE[impl])
    blocks, cap = (B * Hq * tiles, _GRID_X_MAX) if impl == "simt" else \
        (tiles, _GRID_MAX)
    if blocks > cap:
        raise ValueError(f"{BWD_KERNEL}: S exceeds the {impl} backward's "
                         f"grid ({blocks:,} > {cap:,} blocks)")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lse, dout = _aligned(lse), _aligned(dout)
    extra = (_aligned(out),) if impl == "simt" else ()
    if q.numel() == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    workspace = torch.empty(_bwd_workspace_words(impl, B, Hq, Sq, D),
                            dtype=torch.float32, device=q.device)
    source = _BWD_SOURCE[impl]
    ptrs = (q, k, v, lse, dout, *extra, dq, dk, dv, workspace)
    fn = C.bind(build.library(source), f"repro_{source}",
                (C.VOIDP,) * len(ptrs) + (C.I32,) * 8
                + (ctypes.c_float, C.VOIDP))
    with C.on_device(BWD_KERNEL, q, k, v, lse, dout, *extra) as stream:
        err = fn(*(t.data_ptr() for t in ptrs), B, Hq, Hkv, Sq, Skv, D,
                 int(bool(causal)), max(int(window), 0), 1.0 / math.sqrt(D),
                 stream)
    C.launched(BWD_KERNEL, err, impl)
    return dq, dk, dv
