"""ic_frontier_step: one probabilistic reverse-BFS step of the dense IC
sampler in the log-semiring,
``new = (rand < -expm1(frontier @ logq)) & ~visited``.

Replaces the TPU kernel ``src/repro/kernels/ic_frontier.py:
ic_frontier_step`` (``_kernel``): a ``(B, n) x (n, n)`` f32 product whose
logits never reach device memory, fused with the Bernoulli test and the
visited mask.  The dense product is the TPU's formulation; on the card
it is a gather over logq's nonzeros.

The order of summation is the contract.  For each output ``(b, u)``,
``acc`` is the float32 sum of ``logq[v, u]`` over ``frontier[b, v] = 1``,
in ascending ``v``, one term at a time, from ``+0.0``.  A zero ``logq``
entry leaves ``acc`` unchanged bit for bit (``acc`` is never ``-0.0``:
it starts at ``+0.0`` and a sum of two finite floats that rounds to zero
is ``+0.0``), so a walk over the nonzeros of column ``u`` in ascending
``v`` that adds those whose ``v`` is in row ``b``'s frontier is the same
function to the bit; so is the dense ascending sum.  logq is finite
(the samplers clamp it at -30).  The epilogue, shared with the dense
backend (`activation`), is ``p = float32(-expm1(float64(acc)))`` and
``new = rand < p & ~visited``: float64 ``expm1`` rounded once to f32
gives the same ``p`` on the card and on the host, where the f32 ``expm1``
of two libraries differ.  So the kernel and its plain version agree
bitwise at every shape, on either device.

The column form (`column_form`, set-up work in plain PyTorch, one host
sync a build): logq's entries with ``q != 0`` (``-0.0`` and ``+0.0``
both dropped) grouped by column ``u`` and ascending in ``v`` within each,
as CSC arrays ``col_ptr (n + 1,) int32``, ``rows (nnz,) int32`` and
``vals (nnz,) float32``.  A column block of logq, ``(n, w)`` (a tile of
a meshed BFS, which computes its own ``w`` columns of ``new`` from the
whole frontier), has a form of ``w`` columns over the same ``n`` rows:
``col_ptr (w + 1,)``, and the step's visited, rand and output are
``(B, w)``; each column's sum is the same, bit for bit.  A caller that steps on one table builds it
once (the dense sampler, per bound sampler); the plain version walks the
same form one rank at a time (`column_terms`).  Neither reads logq when
handed its form, so the form records the logq it came from (storage,
view and version counter) and a step handed both refuses a form of
another table or one built before logq was last written; handed the
form alone (``logq=None``), the form is the table.

Bound on an H100: the bytes the function must move, ``7 B n`` (frontier,
visited and the output one byte a cell, rand four) plus the form's
``8 nnz + 4 (n + 1)``, at 3.35 TB/s, against one f32 add for each
frontier entry and nonzero of logq's row; the dense product's
``4 n^2 + 7 B n`` bytes are not the function's work.  Design
(``csrc/ic_frontier.cu``): a first kernel packs the frontier 32 rows to
a word a vertex; then a block owns 32 batch rows and a run of output
columns carrying about the same nonzeros as every other block, copies
its rows' packed frontier into shared memory, and a warp walks one
column's nonzeros at a time, lane = batch row, adding ``q`` where the
lane's bit ``v`` is set; no atomics, no tensor cores.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "ic_frontier_step"


def activation(acc, rand, visited) -> torch.Tensor:
    """``rand < float32(-expm1(float64(acc))) & ~visited`` as bool: the
    epilogue of the kernel, its plain version and the dense backend."""
    p = torch.expm1(acc.to(torch.float64)).neg_().to(torch.float32)
    return (rand < p) & ~visited.to(torch.bool)


def _padded_out(B: int, n: int, device) -> torch.Tensor:
    """A zeroed ``(B, padded_width(n))`` uint8 buffer as its ``[:, :n]``."""
    return torch.zeros((B, C.padded_width(n)), dtype=torch.uint8,
                       device=device)[:, :n]


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnForm:
    """logq's nonzeros by column, ascending ``v`` within each column:
    column ``u`` holds ``rows[col_ptr[u]:col_ptr[u + 1]]`` and the
    matching ``vals`` (``logq[v, u]``).  All three on logq's device."""
    col_ptr: torch.Tensor   # (width + 1,) int32
    rows: torch.Tensor      # (nnz,) int32, in [0, n)
    vals: torch.Tensor      # (nnz,) float32
    n: int                  # logq's rows: the frontier's vertices
    nnz: int
    #: the logq this form was built from (`_source_of`), or None for a
    #: form made without one; a step handed both checks they match
    source: tuple | None = None
    #: logq's columns, the step's output width (None: ``n``, square)
    n_cols: int | None = None

    @property
    def width(self) -> int:
        return self.n if self.n_cols is None else self.n_cols

    @property
    def device(self) -> torch.device:
        return self.col_ptr.device

    @property
    def nbytes(self) -> int:
        return 4 * (self.width + 1) + 8 * self.nnz

    @functools.cached_property
    def terms(self) -> list:
        """`column_terms` of this form, built at first use."""
        return column_terms(self)


def _source_of(logq) -> tuple:
    """What identifies a logq and its contents: its storage, view and
    version counter (which every in-place write bumps; an inference-mode
    tensor keeps none)."""
    return (logq.device, logq.untyped_storage().data_ptr(),
            logq.storage_offset(), tuple(logq.shape), logq.stride(),
            None if logq.is_inference() else logq._version)


def column_form(logq) -> ColumnForm:
    """The `ColumnForm` of a float32 ``logq``: the square table, or an
    ``(n, w)`` block of its columns."""
    if logq.dim() != 2 or logq.dtype != torch.float32:
        raise ValueError(f"{KERNEL}: logq must be a float32 matrix, got "
                         f"{tuple(logq.shape)} {logq.dtype}")
    n, w = logq.shape
    u, v = logq.t().nonzero(as_tuple=True)     # sorted by u, then v
    vals = logq[v, u]
    col_ptr = torch.zeros(w + 1, dtype=torch.int64, device=logq.device)
    torch.cumsum(torch.bincount(u, minlength=w), 0, out=col_ptr[1:])
    nnz = int(u.shape[0])
    if nnz >= 1 << 31:
        raise ValueError(f"{KERNEL}: {nnz} nonzeros exceed int32 offsets")
    return ColumnForm(col_ptr.to(torch.int32), v.to(torch.int32),
                      vals.contiguous(), n, nnz, _source_of(logq),
                      None if w == n else w)


def check_form(cols: ColumnForm, n: int, device, logq=None,
               width: int = None) -> None:
    """Raise unless ``cols`` is a column form of an ``(n, width)`` logq
    (``width`` defaults to ``n``) with its tensors on ``device`` and,
    when ``logq`` is given, the form that `column_form` built from this
    ``logq`` as it stands (not a stale one, nor one of another
    table)."""
    if not isinstance(cols, ColumnForm):
        raise TypeError(f"{KERNEL}: cols must be a ColumnForm, got "
                        f"{type(cols).__name__}")
    width = n if width is None else width
    if cols.n != n or cols.width != width \
            or tuple(cols.col_ptr.shape) != (width + 1,) \
            or tuple(cols.rows.shape) != (cols.nnz,) \
            or tuple(cols.vals.shape) != (cols.nnz,):
        raise ValueError(f"{KERNEL}: a column form of n = {cols.n} by "
                         f"{cols.width} (nnz {cols.nnz}) does not fit "
                         f"n = {n} by {width}")
    if (cols.col_ptr.dtype, cols.rows.dtype, cols.vals.dtype) != (
            torch.int32, torch.int32, torch.float32):
        raise TypeError(f"{KERNEL}: cols must hold int32 col_ptr and rows "
                        f"and float32 vals, got {cols.col_ptr.dtype}, "
                        f"{cols.rows.dtype}, {cols.vals.dtype}")
    dev = torch.device(device)
    if any(t.device != dev or not t.is_contiguous()
           for t in (cols.col_ptr, cols.rows, cols.vals)):
        raise ValueError(f"{KERNEL}: cols must be contiguous on {dev}, got "
                         f"{cols.col_ptr.device}")
    if logq is not None and cols.source != _source_of(logq):
        raise ValueError(f"{KERNEL}: cols is not the column form of this "
                         f"logq as it stands (built from another table, "
                         f"or logq was written since): rebuild it, or pass "
                         f"logq=None")


def column_terms(cols: ColumnForm) -> list:
    """A form's nonzeros grouped by rank within their column: a list over
    ranks ``r`` of ``(u, v, q)`` index and value tensors holding, for
    every column ``u`` with more than ``r`` nonzeros, its ``r``-th nonzero
    ``(v, q = logq[v, u])`` in ascending ``v``."""
    ptr = cols.col_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    u = torch.repeat_interleave(torch.arange(cols.width, device=cols.device),
                                counts, output_size=cols.nnz)
    rank = torch.arange(cols.nnz, device=cols.device) - ptr[u]
    order = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist() if cols.nnz else []
    v, q = cols.rows.long(), cols.vals
    groups, off = [], 0
    for c in sizes:
        idx = order[off:off + c]
        groups.append((u[idx], v[idx], q[idx]))
        off += c
    return groups


def ascending_acc(frontier, logq, cols=None) -> torch.Tensor:
    """``frontier @ logq`` summed as the kernel sums it: logq's nonzeros
    in ascending ``v`` per column, one rank at a time (a gather and a
    predicated add over every column that has an ``r``-th nonzero),
    which equals the dense ascending sum because zero terms are exact.
    ``cols`` is ``column_form(logq)`` when the caller has built it (then
    ``logq`` is not read and may be None)."""
    cols = column_form(logq) if cols is None else cols
    f = C.as_bytes(frontier) != 0
    acc = torch.zeros((f.shape[0], cols.width), dtype=torch.float32,
                      device=f.device)
    for u, v, q in cols.terms:
        cur = acc[:, u]
        acc[:, u] = torch.where(f[:, v], cur + q, cur)
    return acc


def ic_frontier_step_plain(frontier, visited, logq, rand,
                           cols=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, bitwise its result
    (`ascending_acc` over ``cols``, built here when not given, then
    `activation`).  ``logq`` may be None when ``cols`` is given; given
    both, ``cols`` must be ``logq``'s form (`check_form`).  A column
    block ``logq (n, w)`` takes ``visited`` and ``rand`` of ``(B, w)``.
    Returns a ``(B, w)`` uint8 view of a row-padded buffer."""
    B, n = frontier.shape
    w = visited.shape[1]
    cols = _form_for(logq, cols, n, frontier.device, w)
    out = _padded_out(B, w, frontier.device)
    out.copy_(activation(ascending_acc(frontier, logq, cols), rand,
                         visited))
    return out


def _form_for(logq, cols, n: int, device, width: int) -> ColumnForm:
    """The form a step walks: ``cols``, checked against ``(n, width)``,
    ``device`` and ``logq`` (when given), or ``logq``'s, built here."""
    if logq is not None and (tuple(logq.shape) != (n, width)
                             or logq.dtype != torch.float32):
        raise ValueError(f"{KERNEL}: logq must be a ({n}, {width}) float32 "
                         f"matrix, got {tuple(logq.shape)} {logq.dtype}")
    if cols is None:
        if logq is None:
            raise ValueError(f"{KERNEL}: give logq or its column form")
        cols = column_form(logq)
    check_form(cols, n, device, logq, width)
    return cols


def _row_block(t: torch.Tensor, what: str) -> tuple[int, int]:
    """``(data_ptr, row_stride)`` of a 2-D block with unit column stride."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{KERNEL}: {what} must be a 2-D row block with "
                         f"unit column stride, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.data_ptr(), (t.stride(0) if t.shape[0] > 1 else t.shape[1])


#: batch rows a block owns (one a lane); the grid's second dimension
#: holds ceil(B / 32) row tiles
ROWS_PER_BLOCK = 32

_step_fn = None


def _step_entry():
    """The C entry point, bound once (the build runs at first use)."""
    global _step_fn
    if _step_fn is None:
        _step_fn = C.bind(
            build.library("ic_frontier"), "repro_ic_frontier_step",
            (C.VOIDP, C.I64, C.VOIDP, C.I64, C.VOIDP, C.VOIDP, C.VOIDP,
             C.VOIDP, C.I64, C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.I32,
             C.I32, C.VOIDP))
    return _step_fn


def ic_frontier_step_cuda(frontier, visited, logq, rand,
                          cols=None) -> torch.Tensor:
    B, n = frontier.shape
    w = visited.shape[1] if visited.dim() == 2 else -1
    if visited.shape[0] != B or tuple(rand.shape) != (B, w):
        raise ValueError(f"{KERNEL}: frontier {tuple(frontier.shape)}, "
                         f"visited {tuple(visited.shape)} and rand "
                         f"{tuple(rand.shape)} must be (B, n), (B, w) and "
                         f"(B, w)")
    if rand.dtype != torch.float32:
        raise TypeError(f"{KERNEL}: rand must be float32, got {rand.dtype}")
    tiles = -(-B // ROWS_PER_BLOCK)
    if tiles > 65535:
        raise ValueError(f"{KERNEL}: B = {B} exceeds the kernel's grid")
    cols = _form_for(logq, cols, n, frontier.device, w)
    # the kernel writes every byte of the row-padded output, pad included
    out = torch.empty((B, C.padded_width(w)), dtype=torch.uint8,
                      device=frontier.device)[:, :w]
    if B == 0 or n == 0 or w == 0:
        return out.zero_()
    f_ptr, ld_f = _row_block(C.as_bytes(frontier), "frontier")
    v_ptr, ld_v = _row_block(C.as_bytes(visited), "visited")
    r_ptr, ld_r = _row_block(rand, "rand")
    # scratch: the frontier packed 32 rows to a word, rows of ldw words
    ldw = -(-n // 4) * 4
    words = torch.empty((tiles, ldw), dtype=torch.int32,
                        device=frontier.device)
    with C.on_device(KERNEL, frontier, visited, rand, cols.vals,
                     out) as stream:
        err = _step_entry()(f_ptr, ld_f, v_ptr, ld_v, cols.col_ptr.data_ptr(),
                            cols.rows.data_ptr(), cols.vals.data_ptr(), r_ptr,
                            ld_r, out.data_ptr(), out.stride(0),
                            words.data_ptr(), ldw, B, n, w, stream)
    C.launched(KERNEL, err)
    return out
