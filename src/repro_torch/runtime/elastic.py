"""Elastic re-meshing: restore a checkpoint into another mesh
(``repro.runtime.elastic``).

Checkpoints hold logical (whole) arrays, so elasticity is placing each
leaf with the current mesh's sharding.  ``ElasticPlan`` maps a leaf's
path to a partition spec on a `repro_torch.mesh.Mesh`; ``reshard_tree``
applies it, and ``gather_tree`` gives the logical arrays back (the
reference's ``np.asarray`` of a global array).

A spec has one entry a leading dim: ``None`` (the dim is whole on every
tile), a mesh axis name, or a tuple of names (the dim is split over their
row-major product, `repro_torch.mesh.axis_index`); dims past its end are
whole, so ``()`` replicates, as ``PartitionSpec()`` does.  A split dim
must divide evenly, as ``jax.device_put`` requires.  A placed leaf is a
`ShardedLeaf`: one tensor a tile of the mesh (built by
`repro_torch.mesh.tile_map`), each on its tile's device and owning its
memory, with the leaf's ``sharding`` (``.mesh``, ``.spec``), ``shape``
and ``dtype``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.store import _host, to_tensor
from repro_torch.mesh import Mesh, axis_index, tile_map


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its ``spec`` on ``mesh``."""
    mesh: Mesh
    spec: tuple = ()

    def _axes(self, ndim: int) -> list:
        """Per dim, the tuple of mesh axes it is split over (``()``:
        whole)."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"leaf's {ndim} dims")
        out, used = [], set()
        for entry in tuple(self.spec) + (None,) * (ndim - len(self.spec)):
            axes = (() if entry is None else (entry,)
                    if isinstance(entry, str) else tuple(entry))
            for a in axes:
                if a not in self.mesh.shape:
                    raise ValueError(f"axis {a!r} is not in mesh axes "
                                     f"{self.mesh.axis_names}")
                if a in used:
                    raise ValueError(f"axis {a!r} splits two dims of "
                                     f"spec {self.spec}")
                used.add(a)
            out.append(axes)
        return out

    def shard_shape(self, shape) -> tuple:
        """The block of a leaf of ``shape`` that one tile holds (every
        split dim must divide, as ``NamedSharding.shard_shape``
        requires)."""
        out = []
        for dim, (n, ax) in enumerate(zip(shape, self._axes(len(shape)))):
            parts = math.prod(self.mesh.shape[a] for a in ax)
            if n % parts:
                raise ValueError(f"dim {dim} of size {n} does not split "
                                 f"into {parts} blocks (spec {self.spec})")
            out.append(n // parts)
        return tuple(out)

    def tile_slices(self, shape) -> Callable:
        """``coords -> tuple of slices``: the block of a leaf of
        ``shape`` that tile ``coords`` holds."""
        axes = self._axes(len(shape))
        blocks = self.shard_shape(shape)

        def slices(coords):
            out = []
            for ax, b in zip(axes, blocks):
                if ax:
                    i = axis_index(self.mesh, coords, ax)
                    out.append(slice(i * b, (i + 1) * b))
                else:
                    out.append(slice(None))
            return tuple(out)

        return slices


class ShardedLeaf:
    """A logical array placed on a mesh: ``tiles`` an object ndarray of
    the mesh's shape, each a tensor on its tile's device."""

    def __init__(self, tiles: np.ndarray, sharding: NamedSharding,
                 shape: tuple, dtype: torch.dtype):
        self.tiles = tiles
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype

    def gather(self, device=None) -> torch.Tensor:
        """The logical array on ``device`` (the first tile's by
        default), assembled from the tiles bit for bit."""
        mesh = self.sharding.mesh
        dev = torch.device(device) if device is not None else \
            mesh.devices.reshape(-1)[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        slices = self.sharding.tile_slices(self.shape)
        for c in np.ndindex(*mesh.devices.shape):
            out[slices(c)] = self.tiles[c].to(dev)
        return out

    def __array__(self, dtype=None, copy=None):
        a = _host(self.gather())
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedLeaf(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, mesh={self.sharding.mesh})")


def place(leaf, sharding: NamedSharding) -> ShardedLeaf:
    """``leaf`` (a tensor or a loaded host array) as tiles on
    ``sharding``'s mesh: ``jax.device_put(leaf, sharding)``."""
    t = to_tensor(leaf)
    slices = sharding.tile_slices(tuple(t.shape))
    tiles = tile_map(sharding.mesh, lambda c, dev: t[slices(c)].to(
        dev, copy=True).contiguous())
    return ShardedLeaf(tiles, sharding, tuple(t.shape), t.dtype)


@dataclasses.dataclass
class ElasticPlan:
    mesh: Mesh
    spec_fn: Callable  # leaf path tuple -> spec

    def sharding_for(self, path) -> NamedSharding:
        return NamedSharding(self.mesh, tuple(self.spec_fn(path)))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _rebuild(tree, it):
    """``tree``'s structure (dicts in sorted key order) with leaves from
    ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree.keys())}
    if isinstance(tree, (list, tuple)):
        vals = [_rebuild(v, it) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    return next(it)


def reshard_tree(tree, plan: ElasticPlan):
    """Every leaf placed with the plan's sharding for its path."""
    return _rebuild(tree, iter(place(leaf, plan.sharding_for(path))
                               for path, leaf in _paths(tree)))


def gather_tree(tree, device=None):
    """The logical arrays of a resharded tree, each on ``device`` (its
    first tile's by default)."""
    return _rebuild(tree, iter(leaf.gather(device)
                               for _, leaf in _paths(tree)))


def replicated_plan(mesh: Mesh) -> ElasticPlan:
    return ElasticPlan(mesh=mesh, spec_fn=lambda path: ())
