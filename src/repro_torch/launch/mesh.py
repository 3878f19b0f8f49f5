"""Production mesh definitions (``repro.launch.mesh``).

Mesh shapes (the reference's TPU v5e pods):
  single-pod : (16, 16)    axes ("data", "model")       — 256 chips
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model") — 512 chips

IMM shards the RRRset (theta) axis over ("pod","data") and the vertex axis
over "model"; LMs put batch on ("pod","data") and TP/experts on "model".

A `repro_torch.mesh.Mesh` may repeat one device in its grid: that is the
port's counterpart of ``--xla_force_host_platform_device_count``.  So the
production meshes are grids of one device — the card unless told
otherwise, or ``"meta"`` for the dry run (`repro_torch.launch.dryrun`),
which builds every cell without allocating anything.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.roofline import TPU_V5E  # noqa: F401  (re-exported)
from repro_torch.mesh import Mesh


def _grid(shape: tuple, device) -> list:
    if len(shape) == 1:
        return [device] * shape[0]
    return [_grid(shape[1:], device) for _ in range(shape[0])]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The (16, 16) or (2, 16, 16) production mesh, every tile on
    ``device`` (``cuda`` unless told otherwise; ``"meta"`` allocates
    nothing)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_grid(shape, resolve_device(device)), axes)


def make_local_mesh(shape=None, axes=("data", "model"), device=None) -> Mesh:
    """A small mesh over the cards there are, ``(count, 1)`` unless
    ``shape`` says otherwise (its size the count, as ``jax.make_mesh``
    wants), or over the host with ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    shape = tuple(shape or (len(devices), 1))
    if math.prod(shape) != len(devices):
        raise ValueError(f"a {shape} mesh over {len(devices)} devices")
    return Mesh(np.array(devices, dtype=object).reshape(shape).tolist(),
                axes)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a production mesh ('pod' included)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"
