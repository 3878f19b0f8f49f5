"""Uniform fan-out neighbour sampler for GraphSAGE minibatch training
(``repro.graphs.sampler``).

For each seed node, ``fanout`` in-neighbours are drawn uniformly with
replacement from the CSC adjacency (the standard GraphSAGE estimator);
zero-degree nodes give the sentinel ``n`` (masked downstream).  The draws
are the reference's threefry ``uniform`` (`repro_torch.prng`) and
``floor(u * max(deg, 1))`` is the same float32 product in both libraries,
so the ids equal JAX's bit for bit.  Everything runs on the adjacency's
device; only the key splits are host work.
"""
from __future__ import annotations

import torch

from repro_torch import prng


def neighbor_sampler(key, dst_offsets: torch.Tensor, in_src: torch.Tensor,
                     seeds: torch.Tensor, fanout: int) -> torch.Tensor:
    """seeds ``(B,)`` -> ``(B, fanout)`` int32 sampled in-neighbour ids
    (the sentinel ``n`` for isolated nodes)."""
    dev = dst_offsets.device
    n = dst_offsets.shape[0] - 1
    seeds = seeds.to(device=dev, dtype=torch.int64)
    start = dst_offsets[seeds]
    # a sentinel seed (a later hop's frontier) reads offset n twice: no
    # neighbours, as the reference's clamped gather gives it
    deg = dst_offsets[torch.clamp(seeds + 1, max=n)] - start
    u = prng.uniform(key, (seeds.shape[0], fanout), device=dev)
    off = torch.floor(u * torch.clamp(deg, min=1)[:, None].to(torch.float32))
    pick = start[:, None].to(torch.int64) + off.to(torch.int32)
    nbrs = in_src[torch.clamp(pick, 0, in_src.shape[0] - 1)]
    return torch.where(deg[:, None] > 0, nbrs.to(torch.int32),
                       torch.full_like(nbrs, n, dtype=torch.int32))


def sample_blocks(key, dst_offsets: torch.Tensor, in_src: torch.Tensor,
                  seeds: torch.Tensor, fanouts) -> list:
    """Multi-hop sampling: ``[(frontier, nbrs)]`` a hop, where hop ``i``
    samples ``fanouts[i]`` neighbours of every node of the previous
    frontier (``frontier_0 = seeds``)."""
    blocks = []
    frontier = seeds
    for f in fanouts:
        key, sub = prng.split(key)
        nbrs = neighbor_sampler(sub, dst_offsets, in_src, frontier, f)
        blocks.append((frontier, nbrs))
        frontier = nbrs.reshape(-1)
    return blocks
