"""The port's device rule: every entry point, engine and store runs on
``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA on a
host without a GPU raises instead of carrying on slowly on the host."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless told otherwise; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the host")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    host), so that a host clock read after it times that work."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
