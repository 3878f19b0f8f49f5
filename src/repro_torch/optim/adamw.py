"""AdamW with dtype-configurable moments (``repro.optim.adamw``).

The update math is float32 whatever the leaves' dtype, as in the
reference: the bias corrections ``1 - b ** step`` are float32 (a 0-dim
float32 tensor raised to the float32 step), each leaf's moments and new
value are computed in float32 and cast back to the moment and parameter
dtypes.  `adamw_init` and `adamw_update` are pure like the reference's:
they return new tensors and leave their arguments as they are.
`adamw_update_` gives the same bits in place, a slice of each leaf at a
time, with the clip's scale folded in: the counterpart of a jitted step
that donates its state, whose peak holds no second copy of the
parameters, the moments or the gradients.  ``moment_dtype="bfloat16"``
halves the optimizer state.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak; schedules multiply this
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts and lists of like
    structure (a GNN's per-layer list, as in the reference's pytrees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, *parts) for parts in zip(tree, *rest)]
    return fn(tree, *rest)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _leaf_update(state, cfg: AdamWConfig, lr_scale):
    """``(step, upd)``: the next step count and ``upd(p, g, mu, nu) ->
    (new_p, new_mu, new_nu)``, one leaf's (or one slice's) update."""
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    f32 = torch.float32
    c1 = 1.0 - torch.tensor(b1, dtype=f32) ** step.to(f32)
    c2 = 1.0 - torch.tensor(b2, dtype=f32) ** step.to(f32)
    lr = cfg.lr * lr_scale
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, mu, nu):
        # the reference's expressions; the in-place steps act on fresh
        # temporaries only and give the same bits, with fewer of them
        # alive at once (a full-width FM table is 1.56 GB a copy)
        g32 = g.to(f32)
        mu32 = mu.to(f32) * b1
        mu32 += (1 - b1) * g32
        nu32 = nu.to(f32) * b2
        nu32 += (1 - b2) * g32 * g32
        update = (mu32 / c1).div_((nu32 / c2).sqrt_().add_(cfg.eps))
        p32 = p.to(f32)
        update += cfg.weight_decay * p32
        new_p = p32 - lr * update
        return new_p.to(p.dtype), mu32.to(mdt), nu32.to(mdt)

    return step, upd


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """``(new_params, new_state)`` after one AdamW step; ``lr_scale`` (a
    number or a 0-dim tensor, a schedule's value) multiplies ``cfg.lr``."""
    step, upd = _leaf_update(state, cfg, lr_scale)
    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    return _part(out, 0), {"mu": _part(out, 1), "nu": _part(out, 2),
                           "step": step}


#: elements of a leaf one in-place update slice holds (its float32
#: temporaries are a few of these, 256 MiB each)
_SLICE = 1 << 26


def adamw_update_(params, grads, state, cfg: AdamWConfig,
                  grad_scale: torch.Tensor) -> None:
    """`adamw_update` in place: every leaf of ``params`` and of
    ``state``'s moments takes its new value, ``state["step"]`` the next
    count, with the same bits.  Each grad is first multiplied by
    ``grad_scale`` (a 0-dim tensor) in its own dtype, as
    `clip_by_global_norm` scales it; the update runs `_SLICE` elements of
    a leaf at a time, so only a slice's float32 temporaries are alive at
    once.  The leaves must be contiguous."""
    step, upd = _leaf_update(state, cfg, 1.0)

    def leaf(p, g, mu, nu):
        pf, gf, mf, nf = (t.view(-1) for t in (p, g.contiguous(), mu, nu))
        for lo in range(0, pf.numel(), _SLICE):
            sl = slice(lo, lo + _SLICE)
            new_p, new_mu, new_nu = upd(
                pf[sl], gf[sl] * grad_scale.to(gf.dtype), mf[sl], nf[sl])
            pf[sl].copy_(new_p)
            mf[sl].copy_(new_mu)
            nf[sl].copy_(new_nu)

    tree_map(leaf, params, grads, state["mu"], state["nu"])
    state["step"] = step


def _part(tree, i):
    """The ``i``-th member of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _part(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_part(v, i) for v in tree]
    return tree[i]
