"""A device mesh held by one process: the port's counterpart of
``jax.sharding.Mesh`` and of the collectives a ``shard_map`` body uses
(``psum``, ``all_gather``, ``all_to_all`` and the psum-or of membership
bits), and the column gather a column-blocked BFS exchanges its frontier
with.

The reference runs a single controller: one process holds the mesh, the
store hands its tiles to ``shard_map`` and the collectives run inside one
traced function.  Here one process holds a grid of ``torch.device``
objects, each tile of a meshed arena is a tensor on its own device, and a
collective is a function over the list of per-tile tensors that reduces
them in tile order, so float32 counters (integer-valued, exact below
2**24) come out the same on every layout.  Across distinct cards a
collective copies tiles peer to peer (``.to(device, non_blocking=True)``,
which PyTorch orders after the work queued on the source's stream); no
tile waits on the host.

The collectives over named axes (`psum_over`, `all_gather_over`,
`all_to_all_over`) take and return one tensor a tile, as an object
ndarray of the mesh's shape (`tile_map` builds one): each runs within the
groups of tiles that share every coordinate but the named axes
(`axis_groups`), as a ``lax.psum(x, axes)`` inside ``shard_map`` does.
Every collective is made of ``.to``, ``+``, ``cat`` and ``stack``, so
autograd runs through it: a gradient comes back to each tile's device.

Every collective adds to three obs counters keyed by its ``kind``
(``psum``, ``psum_or``, ``all_gather``, ``all_gather_cols``,
``all_to_all``): ``mesh.collective.calls``, ``mesh.collective.bytes``
(the bytes of the tiles it was given) and ``mesh.collective.cross_bytes``
(the bytes it moved between two distinct devices: 0 on a grid that
repeats one device).  The counters are host-side, read only shapes and
devices, and take no sync; with obs off each is one flag check.  They
are the port's counterpart of the collective census the reference reads
from XLA's optimized HLO (``repro.launch.hlo_analysis``).

A device may repeat in the grid — the counterpart of XLA's
``--xla_force_host_platform_device_count``: a 2x2 mesh of ``cpu`` runs
the full tiled code path in one process, and so does a 2x2 mesh of one
card.  A mesh's devices share one type (all ``cpu`` or all ``cuda``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs


class Mesh:
    """A named grid of devices.  ``devices`` is a nested sequence (or an
    object ndarray) of ``torch.device`` objects or device strings with one
    dimension per name in ``axis_names``; ``shape[name]`` is the size of
    that axis, as on a ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        names = tuple(axis_names)
        arr = np.array(devices, dtype=object)
        if arr.ndim != len(names):
            raise ValueError(f"a mesh over axes {names} needs a "
                             f"{len(names)}-d device grid, got {arr.ndim}-d")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [_indexed(torch.device(d)) for d in arr.reshape(-1)]
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"a mesh's devices share one type, got "
                             f"{sorted({d.type for d in flat})}")
        grid = np.empty(arr.shape, dtype=object)
        grid.reshape(-1)[:] = flat
        self.devices = grid
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list:
        """The grid's devices once each, in grid order."""
        seen = []
        for d in self.devices.reshape(-1):
            if d not in seen:
                seen.append(d)
        return seen

    def tile_devices(self, theta_axes, vertex_axis=None) -> list:
        """``[Dt][Dv]`` devices of the tiles of an arena laid out as
        ``P(theta_axes, vertex_axis)``: theta shard ``t`` is the row-major
        index over ``theta_axes``, vertex shard ``v`` the index along
        ``vertex_axis`` (``Dv = 1`` without one).  Tiles are replicated
        over any other axis; its first device holds them."""
        theta_axes = ((theta_axes,) if isinstance(theta_axes, str)
                      else tuple(theta_axes))
        used = theta_axes + ((vertex_axis,) if vertex_axis else ())
        for a in used:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in mesh axes "
                                 f"{self.axis_names}")
        rest = tuple(a for a in self.axis_names if a not in used)
        order = [self.axis_names.index(a) for a in used + rest]
        grid = self.devices.transpose(order)
        grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
        dt = int(np.prod([self.shape[a] for a in theta_axes]))
        dv = int(self.shape[vertex_axis]) if vertex_axis else 1
        return grid.reshape(dt, dv).tolist()

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}; {[str(d) for d in self.distinct_devices()]})"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it names (the current one), so that a grid of
    ``"cuda"`` and one of ``"cuda:0"`` hold the same devices; without a
    card the name is left for `repro_torch.device.resolve_device` to
    refuse."""
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


# ------------------------------------------------------------ collectives --

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _census(kind: str, nbytes: int, cross: int) -> None:
    """One call of collective ``kind`` over ``nbytes`` of tiles, ``cross``
    of them moved between distinct devices (obs counters; no sync)."""
    if obs.enabled():
        obs.counter("mesh.collective.calls", kind=kind).add(1)
        obs.counter("mesh.collective.bytes", kind=kind).add(nbytes)
        obs.counter("mesh.collective.cross_bytes", kind=kind).add(cross)


def _gather_census(kind: str, parts, device) -> None:
    """`_census` of ``parts`` all brought to ``device``."""
    if obs.enabled():
        dev = _indexed(torch.device(device))
        _census(kind, sum(_nbytes(p) for p in parts),
                sum(_nbytes(p) for p in parts if p.device != dev))


def psum(parts, device) -> torch.Tensor:
    """Sum of the per-tile tensors ``parts`` on ``device``, added in
    tile order."""
    _gather_census("psum", parts, device)
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(device, non_blocking=True)
    return out


def psum_or(parts, device) -> torch.Tensor:
    """Logical or of the per-tile bool tensors ``parts`` on ``device``."""
    _gather_census("psum_or", parts, device)
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = out | p.to(device, non_blocking=True)
    return out


def all_gather(parts, device) -> torch.Tensor:
    """The per-tile tensors ``parts`` stacked in tile order on
    ``device``."""
    _gather_census("all_gather", parts, device)
    return torch.stack([p.to(device, non_blocking=True) for p in parts])


def all_gather_cols(parts, device, out) -> torch.Tensor:
    """The per-tile column blocks ``parts`` (each ``(K, w_v)``) gathered
    in tile order into ``out (K, sum w_v)`` on ``device``: the frontier
    exchange of a column-blocked BFS."""
    _gather_census("all_gather_cols", parts, out.device)
    lo = 0
    for p in parts:
        w = p.shape[1]
        out[:, lo:lo + w].copy_(p.to(device, non_blocking=True))
        lo += w
    return out


# ------------------------------------------- collectives over named axes --

def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def tile_map(mesh: Mesh, fn) -> np.ndarray:
    """``fn(coords, device)`` for every tile, as an object ndarray of the
    mesh's shape (``coords`` a tuple of grid indices)."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for c in np.ndindex(*mesh.devices.shape):
        out[c] = fn(c, mesh.devices[c])
    return out


def axis_index(mesh: Mesh, coords: tuple, axes) -> int:
    """The row-major index of tile ``coords`` over ``axes`` (in the
    given order): ``lax.axis_index`` of those axes."""
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.shape[a] + coords[mesh.axis_names.index(a)]
    return idx


def axis_groups(mesh: Mesh, axes) -> list:
    """The tiles grouped over ``axes``: one group for each combination
    of the other axes' coordinates, each a list of tile coordinates in
    row-major order over ``axes`` (`axis_index`)."""
    axes = _axes(axes)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not in mesh axes "
                             f"{mesh.axis_names}")
    groups: dict = {}
    for c in np.ndindex(*mesh.devices.shape):
        rest = tuple(c[i] for i, a in enumerate(mesh.axis_names)
                     if a not in axes)
        groups.setdefault(rest, []).append(c)
    return [sorted(g, key=lambda c: axis_index(mesh, c, axes))
            for g in groups.values()]


def psum_over(mesh: Mesh, parts: np.ndarray, axes) -> np.ndarray:
    """Each tile's sum of ``parts`` over its group along ``axes``, added
    in tile order, on the tile's device."""
    out = np.empty(parts.shape, dtype=object)
    for group in axis_groups(mesh, axes):
        home = mesh.devices[group[0]]
        total = psum([parts[c] for c in group], home)
        if obs.enabled():
            # the sum's copies back to the group's other devices
            obs.counter("mesh.collective.cross_bytes", kind="psum").add(
                _nbytes(total) * sum(mesh.devices[c] != home
                                     for c in group))
        for c in group:
            out[c] = total.to(mesh.devices[c], non_blocking=True)
    return out


def all_gather_over(mesh: Mesh, parts: np.ndarray, axes,
                    dim: int) -> np.ndarray:
    """Each tile's ``parts`` of its group along ``axes`` concatenated in
    tile order along ``dim`` (``lax.all_gather(..., tiled=True)``), on
    the tile's device."""
    out = np.empty(parts.shape, dtype=object)
    for group in axis_groups(mesh, axes):
        for c in group:
            dev = mesh.devices[c]
            _gather_census("all_gather", [parts[g] for g in group], dev)
            out[c] = torch.cat([parts[g].to(dev, non_blocking=True)
                                for g in group], dim=dim)
    return out


def all_to_all(parts, split_axis: int, concat_axis: int,
               devices) -> list:
    """``lax.all_to_all(..., tiled=True)`` over the tiles ``parts`` (one
    group, in tile order): each part splits into ``len(parts)`` equal
    chunks along ``split_axis``; tile ``j`` gets chunk ``j`` of every
    part, concatenated in tile order along ``concat_axis``, on
    ``devices[j]``."""
    n = len(parts)
    size = parts[0].shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size {size} "
                         f"does not split into {n} tiles")
    chunks = [p.chunk(n, dim=split_axis) for p in parts]
    if obs.enabled():
        _census("all_to_all", sum(_nbytes(p) for p in parts),
                sum(_nbytes(chunks[i][j]) for i in range(n)
                    for j in range(n)
                    if chunks[i][j].device
                    != _indexed(torch.device(devices[j]))))
    return [torch.cat([chunks[i][j].to(devices[j], non_blocking=True)
                       for i in range(n)], dim=concat_axis)
            for j in range(n)]


def all_to_all_over(mesh: Mesh, parts: np.ndarray, axis: str,
                    split_axis: int, concat_axis: int) -> np.ndarray:
    """`all_to_all` within each group of tiles along ``axis``."""
    out = np.empty(parts.shape, dtype=object)
    for group in axis_groups(mesh, axis):
        moved = all_to_all([parts[c] for c in group], split_axis,
                           concat_axis, [mesh.devices[c] for c in group])
        for c, t in zip(group, moved):
            out[c] = t
    return out
