"""Mixture-of-Experts layer (``repro.models.moe``): top-k routing with
capacity, SwiGLU experts and the Switch-style load-balance loss.

`moe_apply` is the reference's GShard formulation, a one-hot dispatch
and combine einsum over ``(T, E, C)``, in float32 as the reference
computes it.  The transformer's FFN (`repro_torch.models.transformer`)
and the meshed FFN (`repro_torch.models.moe_sharded`) route the same way
but move rows by index: `route` gives every ``(token, choice)`` its slot
in its expert's queue with a stable sort (no ``O(T k E)`` one-hot),
`dispatch` copies token rows into the ``(E, C, d)`` slots and `combine`
sums each token's weighted expert outputs back.

Both index moves are deterministic on the card.  The reference's
combine is a scatter-add over the slots; a CUDA ``index_add_`` adds with
atomics, so its float32 sums would land in another order from run to
run.  `combine` instead gathers each token's ``k`` slots, sorted by slot
(the order in which the reference's scatter visits them), and adds them
in that order; `dispatch` writes each slot once, so the backward of both
is a gather and a fixed-order sum too.  Every buffer has one extra row,
the sentinel slot ``E * C`` that a dropped choice points at, sliced off
before use: nothing indexes past the end of a buffer (on CUDA that would
be a device-side assert that ends the process).

With observability on, `route` adds its choices to ``moe.choices`` and
those over capacity to ``moe.dropped``, and sets ``moe.capacity`` to
``C``: a read of ``keep``'s sum, so one device sync a routing, and none
while observability is off.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.models.common import dense_init


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32) -> dict:
    """``{"router" (d, E) float32, "w_gate_up" (E, d, 2 ff), "w_down"
    (E, ff, d)}``: the router ``N(0, 1/d)`` in float32 whatever
    ``dtype``, the experts ``N(0, 1) / sqrt(fan_in)`` cast to ``dtype``,
    drawn on ``gen``'s device."""
    return {
        "router": dense_init(gen, d_model, n_experts, torch.float32),
        "w_gate_up": expert_init(gen, (n_experts,), d_model, 2 * d_ff, dtype),
        "w_down": expert_init(gen, (n_experts,), d_ff, d_model, dtype),
    }


def expert_init(gen: torch.Generator, lead: tuple, fan_in: int, fan_out: int,
                dtype) -> torch.Tensor:
    """``normal(lead + (fan_in, fan_out)) / sqrt(fan_in)``, drawn in f32 on
    ``gen``'s device and cast to ``dtype``."""
    w = torch.randn((*lead, fan_in, fan_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def capacity(capacity_factor: float, top_k: int, T: int, E: int) -> int:
    """Slots per expert, ``max(int(cf * k * T / E), 1)`` in Python floats
    as the reference computes it."""
    return max(int(capacity_factor * top_k * T / E), 1)


def top_k_gates(x: torch.Tensor, router: torch.Tensor, k: int):
    """``(probs (T, E), gate_vals (T, k), gate_idx (T, k))`` of ``x (T,
    d)``: float32 router logits, their softmax, the ``k`` largest
    probabilities renormalized to sum to one.  Ties keep the lower
    expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order): the top ``k`` of a stable descending sort."""
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gate = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def sort_positions(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Each ``(token, choice)``'s position in its expert's queue, ``(T,
    k)`` int64, in flat ``(token, choice)`` order: a stable argsort of the
    expert ids, each one's segment start found by ``searchsorted`` (left
    side), the rank within the segment scattered back.  Equal to the
    one-hot cumulative count of `moe_apply`."""
    flat = gate_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_eid = flat[order]
    seg_start = torch.searchsorted(
        sorted_eid, torch.arange(E, dtype=sorted_eid.dtype,
                                 device=flat.device))
    pos_sorted = (torch.arange(flat.numel(), device=flat.device)
                  - seg_start[sorted_eid])
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos.view(gate_idx.shape)


@dataclasses.dataclass
class Routing:
    """The slot maps of one routing, as the reference builds them.

    ``flat_slot (T, k)`` is each choice's slot ``e * C + pos``, or the
    sentinel ``E * C`` when it dropped (``keep`` false).  ``slot_token``,
    ``slot_valid`` and ``slot_gate`` are ``(E * C,)``: the token in each
    slot (0 where empty), whether it holds one, and its gate value (0
    where empty)."""
    E: int
    C: int
    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    flat_slot: torch.Tensor
    slot_token: torch.Tensor
    slot_valid: torch.Tensor
    slot_gate: torch.Tensor

    @property
    def flat_eid(self) -> torch.Tensor:
        return self.gate_idx.reshape(-1)


def route(x: torch.Tensor, router: torch.Tensor, E: int, k: int,
          capacity_factor: float) -> Routing:
    """Top-k routing of ``x (T, d)`` and its sort-based slot maps, with
    ``C = capacity(capacity_factor, k, T, E)`` slots an expert."""
    T = x.shape[0]
    C = capacity(capacity_factor, k, T, E)
    probs, gate, idx = top_k_gates(x, router, k)
    pos = sort_positions(idx, E)
    keep = pos < C
    flat_slot = torch.where(keep, idx * C + pos, E * C)
    slots = flat_slot.reshape(-1)
    dev = x.device
    tokens = torch.arange(T, device=dev).repeat_interleave(k)
    n = E * C + 1
    slot_token = torch.zeros(n, dtype=torch.int64, device=dev)
    slot_token[slots] = tokens
    slot_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    slot_valid[slots] = True
    slot_gate = torch.zeros(n, dtype=torch.float32, device=dev)
    slot_gate[slots] = (gate * keep).reshape(-1)
    if obs.enabled():
        obs.counter("moe.choices").add(keep.numel())
        obs.counter("moe.dropped").add(keep.numel() - int(keep.sum()))
        obs.gauge("moe.capacity").set(C)
    return Routing(E, C, probs, gate, idx, pos, keep, flat_slot,
                   slot_token[:-1], slot_valid[:-1], slot_gate[:-1])


def dispatch(x: torch.Tensor, r: Routing) -> torch.Tensor:
    """``x (T, d)``'s rows in their slots, ``(E, C, d)``, zero in empty
    slots: the reference's ``where(slot_valid, x[slot_token], 0)``,
    written slot by slot (each slot once; the dropped choices land in
    the sentinel row, sliced off)."""
    T, d = x.shape
    k = r.gate_idx.shape[1]
    buf = x.new_zeros((r.E * r.C + 1, d))
    buf = buf.index_put((r.flat_slot.reshape(-1),),
                        x.repeat_interleave(k, dim=0))
    return buf[:-1].view(r.E, r.C, d)


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """``(T, d)`` float32: each token's expert outputs ``ye (E, C, d)``
    times their slot's gate (in ``ye``'s dtype, as the reference), summed
    in float32 over the token's slots in ascending slot order; a dropped
    choice adds the sentinel's zero row."""
    E, C, d = ye.shape
    weighted = (ye * r.slot_gate.view(E, C, 1).to(ye.dtype)).reshape(E * C, d)
    weighted = torch.cat([weighted, weighted.new_zeros((1, d))]).to(
        torch.float32)
    rows = weighted[torch.sort(r.flat_slot, dim=1).values]       # (T, k, d)
    y = rows[:, 0]
    for j in range(1, rows.shape[1]):
        y = y + rows[:, j]
    return y


def experts(xe: torch.Tensor, w_gate_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their slots: ``(E, C, d) -> (E, C, d)``,
    two batched matmuls in the operands' dtype."""
    g, u = torch.bmm(xe, w_gate_up).chunk(2, dim=-1)
    return torch.bmm(F.silu(g) * u, w_down)


def aux_loss(r: Routing) -> torch.Tensor:
    """Switch-style load balance: ``E * sum(density * mean prob)``, the
    density every choice's expert counted over ``T`` (dropped ones
    too)."""
    T = r.probs.shape[0]
    density = torch.bincount(r.flat_eid, minlength=r.E).to(torch.float32) / T
    return r.E * torch.sum(density * r.probs.mean(dim=0))


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25):
    """``x (T, d) -> (y (T, d), aux ())``, the reference's GShard
    dispatch: one-hot ``(T, E, C)`` dispatch and combine tensors from a
    cumulative count of the one-hot choices, float32 einsums throughout,
    ``y`` cast to ``x``'s dtype.  Tokens over capacity drop."""
    T, d = x.shape
    E = params["router"].shape[1]
    C = capacity(capacity_factor, top_k, T, E)
    f32 = torch.float32
    probs, gate, idx = top_k_gates(x, params["router"], top_k)
    onehot = F.one_hot(idx, E).to(f32)                           # (T, k, E)
    flat = onehot.reshape(T * top_k, E)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).view(T, top_k, E)
    pos = (pos_in_expert * onehot).sum(dim=-1)                   # (T, k)
    keep = pos < C
    onehot_kept = onehot * keep[..., None]
    # a position past the capacity has no one-hot column (jax.nn.one_hot)
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).to(f32)
    disp = torch.einsum("tke,tkc->tec", onehot_kept, pos_oh)
    comb = torch.einsum("tke,tkc,tk->tec", onehot_kept, pos_oh, gate)
    xe = torch.einsum("tec,td->ecd", disp, x.to(f32))
    gu = torch.einsum("ecd,edf->ecf", xe, params["w_gate_up"].to(f32))
    g, u = gu.chunk(2, dim=-1)
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * u,
                      params["w_down"].to(f32))
    y = torch.einsum("tec,ecd->td", comb, ye)
    density = onehot.sum(dim=1).mean(dim=0)
    aux = E * torch.sum(density * probs.mean(dim=0))
    return y.to(x.dtype), aux
