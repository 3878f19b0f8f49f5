"""Shared plumbing of the kernel wrappers: device dispatch, launch
counts, the launch device and stream, and row-view checks.

A wrapper takes its plain PyTorch version only for CPU tensors; for CUDA
tensors it launches its kernel or raises — there is no fallback.  Every
dispatch records ``kernels.dispatch{kernel, impl=cuda|reference}`` on the
obs registry, and every launch adds one to ``LAUNCHES[kernel]``, so a run
can show that its main path went through the kernels.

A kernel launches on its operands' card and on that card's current
stream (`on_device`), whichever card is current: a tile of a mesh on a
second card, or an engine on ``cuda:1``, runs there.  Operands on two
devices raise.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch import obs

#: arena and batch rows start on 16-byte boundaries so kernels read them
#: with 16-byte loads; pad bytes between n and the stride are zero
ROW_ALIGN = 16

#: launches per kernel since the last `reset_launches`; read and written
#: under `_LAUNCH_LOCK` (a tier's refresh worker and its query thread
#: launch kernels at once, and ``+=`` on a dict entry is not atomic)
LAUNCHES: dict[str, int] = {}
_LAUNCH_LOCK = threading.Lock()

VOIDP, I64, I32, U32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_uint32)


def padded_width(n: int) -> int:
    """Row stride (bytes) of an ``n``-column uint8 row block."""
    return -(-int(n) // ROW_ALIGN) * ROW_ALIGN


def impl_for(kernel: str, *tensors: torch.Tensor) -> str:
    """``"reference"`` when every operand lies on the CPU, ``"cuda"`` when
    every operand lies on one CUDA device; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        impl = "reference"
    elif kinds == {"cuda"}:
        impl = "cuda"
        _one_device(kernel, tensors)
    else:
        raise ValueError(
            f"{kernel}: operands on {sorted(kinds)}; the CUDA kernel takes "
            f"CUDA tensors, the plain version CPU tensors")
    obs.counter("kernels.dispatch", kernel=kernel, impl=impl).add(1)
    return impl


def _one_device(kernel: str, tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(
            f"{kernel}: operands on {sorted(str(d) for d in devices)}; a "
            f"launch takes its operands on one device")
    return devices.pop()


def launched(kernel: str, err: int, design: str | None = None) -> None:
    """Raise on a refused launch (the C entry point returns
    ``cudaGetLastError()``), else count it, and count it under
    ``kernel:design`` too for a kernel with one CUDA design per dtype."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    keys = (kernel,) if design is None else (kernel, f"{kernel}:{design}")
    with _LAUNCH_LOCK:
        for key in keys:
            LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


@contextlib.contextmanager
def on_device(kernel: str, *tensors):
    """Make the operands' card current for a launch and yield the handle
    of its current stream; operands (None skipped) on two devices
    raise."""
    dev = _one_device(kernel, tensors)
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def bind(lib, fn: str, argtypes) -> ctypes._CFuncPtr:
    """``lib.fn`` taking ``argtypes`` and returning an int.  The library
    keeps the function, so its types are set on the first call only
    (setting them costs more host time than the rest of a small launch's
    wrapper)."""
    f = getattr(lib, fn)
    if getattr(f, "argtypes", None) is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A bool tensor as uint8 (same storage); uint8 passes through."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if t.dtype != torch.uint8:
        raise TypeError(f"expected a uint8/bool tensor, got {t.dtype}")
    return t


def row_view(t: torch.Tensor, what: str) -> tuple[int, int]:
    """``(data_ptr, row_stride)`` of a 2-D uint8/bool row block that a
    kernel reads or writes with 16-byte accesses: unit column stride, a
    16-byte-aligned base and a row stride that is a multiple of 16 bytes
    covering the padded width, with storage behind the last row's pad."""
    if t.dim() != 2 or t.stride(1) != 1 and t.shape[1] > 1:
        raise ValueError(f"{what}: need a 2-D row block with unit column "
                         f"stride, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")
    rows, n = t.shape
    ld = t.stride(0) if rows > 1 else padded_width(n)
    ptr = t.data_ptr()
    if ptr % ROW_ALIGN or ld % ROW_ALIGN or ld < n:
        raise ValueError(
            f"{what}: rows must start on {ROW_ALIGN}-byte boundaries "
            f"(base % 16 = {ptr % ROW_ALIGN}, row stride {ld}); allocate "
            f"(rows, padded_width(n)) and pass [:, :n]")
    need = t.storage_offset() + (rows - 1) * ld + padded_width(n)
    if rows and t.untyped_storage().nbytes() < need:
        raise ValueError(f"{what}: storage ends inside the last row's "
                         f"padding ({need} bytes needed)")
    return ptr, ld
