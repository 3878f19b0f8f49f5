"""Factorization Machine (Rendle, ICDM'10) over one concatenated embedding
table (``repro.models.recsys.fm``).

    logit(x) = b + sum_f w[f, x_f] + sum_{i<j} <v_i, v_j>

with the pairwise term by the O(nk) sum-square trick.  `fm_logits` has
two routes on the card (`repro_torch.kernels.ops`), chosen by what the
caller asks for:

- **serving** (no gradient: grad mode off, or none of ``v``, ``w``,
  ``b`` requires one): one ``fm_gather_interaction`` launch takes the
  ids as they come and gathers, sums and pairs in one pass;
- **training** (a gradient): `_gather`, then the ``fm_interaction``
  kernel through `FMInteraction`, whose backward is the reference's
  gradient, and PyTorch's ``w.sum(-1)``.

Both compute the reference's function; the serving route sums ``w`` in a
fixed order, so the two can differ in the last bits of a float32 logit.
`fm_retrieval_scores` takes the user's constant from `fm_logits` over
the user's fields (one fused launch when serving).  The reference calls
the kernel's plain reference at the same places.

The ``n_sparse`` categorical fields share one table of ``sum_f
vocab_f`` rows, field ``f``'s ids offset by ``f * vocab_per_field``.
Parameters are a dict ``{"v": (rows, K), "w": (rows,), "b": ()}`` as in
the reference.  Gradients come from ``torch.autograd``
(`fm_value_and_grad`): the table's gradient is dense, as ``jax.grad``
through ``jnp.take`` gives it, and AdamW then updates every row.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import take_index, take_rows


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    interaction: str = "fm-2way"

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def field_offsets(self, device=None) -> torch.Tensor:
        """``(n_sparse,)`` int64: the first table row of each field."""
        return torch.arange(0, self.total_rows, self.vocab_per_field,
                            dtype=torch.int64, device=device)


def init_fm(cfg: FMConfig, *, generator: torch.Generator, device=None,
            dtype=torch.float32) -> dict:
    """The reference's initialisation: ``v ~ normal * 0.01`` (drawn in
    float32 on ``generator``'s device, then cast), ``w`` and ``b`` zero.
    On ``cuda`` unless ``device`` says otherwise; raises without a GPU."""
    dev = resolve_device(device)
    v = torch.randn((cfg.total_rows, cfg.embed_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return {
        "v": v.mul_(0.01).to(device=dev, dtype=dtype),
        "w": torch.zeros((cfg.total_rows,), dtype=dtype, device=dev),
        "b": torch.zeros((), dtype=dtype, device=dev),
    }


class _DropGrad(torch.autograd.Function):
    """The identity, whose gradient is 0 at the rows where ``invalid``."""

    @staticmethod
    def forward(ctx, x, invalid):
        ctx.save_for_backward(invalid)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (invalid,) = ctx.saved_tensors
        return g.masked_fill(invalid[:, None], 0), None


def _gather(params, rows: torch.Tensor):
    """``(v[rows], w[rows])`` for a flat index tensor, with the results of
    the reference's ``jnp.take``: a row id in ``[-n, 0)`` of a table of
    ``n`` rows wraps (`take_index`), and any other out of range makes its
    request's logit or score NaN while the rest of the batch is served.
    The training route of `fm_logits`, the user's rows and the
    candidates of `fm_retrieval_scores` gather here; a serving logit
    gathers inside its fused kernel instead, with the same results.
    Only ``w``'s row is filled with NaN there: every logit and score adds
    its ``w`` rows, so one NaN is enough, and a NaN fill of ``v`` would be
    a pass over the largest tensor of a call.  ``v``'s row there holds
    row ``id % n``; its gradient is dropped, as ``jax.grad`` through the
    fill mode drops it (``w``'s fill drops its own)."""
    safe, invalid = take_index(rows, params["v"].shape[0])
    v = params["v"].index_select(0, safe)
    if v.requires_grad:
        v = _DropGrad.apply(v, invalid)
    return v, take_rows(params["w"], safe, invalid)


def _wants_grad(params) -> bool:
    return torch.is_grad_enabled() and any(
        params[k].requires_grad for k in ("v", "w", "b"))


def fm_logits(params, cfg: FMConfig, sparse_idx) -> torch.Tensor:
    """``sparse_idx (B, n_sparse)`` per-field ids (int32 or int64) ->
    ``(B,)`` logits: one fused launch unless a gradient is asked for."""
    if not _wants_grad(params):
        return ops.fm_gather_interaction(sparse_idx, cfg.vocab_per_field,
                                         params["v"], params["w"],
                                         params["b"])
    B = sparse_idx.shape[0]
    rows = (sparse_idx.to(torch.int64)
            + cfg.field_offsets(sparse_idx.device)[None, :]).reshape(-1)
    v, w = _gather(params, rows)
    pair = ops.fm_interaction(
        v.view(B, cfg.n_sparse, cfg.embed_dim).to(torch.float32))
    return params["b"] + w.view(B, cfg.n_sparse).sum(dim=-1) + pair


def fm_loss(params, cfg: FMConfig, sparse_idx, labels) -> torch.Tensor:
    """Binary cross entropy on {0, 1} CTR labels."""
    logits = fm_logits(params, cfg, sparse_idx).to(torch.float32)
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def fm_value_and_grad(params, cfg: FMConfig, sparse_idx, labels):
    """``(loss, grads)`` of `fm_loss`, grads a dict like ``params``: the
    counterpart of ``jax.value_and_grad(fm_loss)``.  ``params`` is left
    as it is (its leaves are differentiated through detached aliases)."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = fm_loss(leaves, cfg, sparse_idx, labels)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def fm_retrieval_scores(params, cfg: FMConfig, user_idx,
                        candidate_rows) -> torch.Tensor:
    """``user_idx (n_user_fields,)`` context ids, ``candidate_rows (C,)``
    global row ids of candidate items -> ``(C,)`` scores.  The FM score
    decomposes as ``s(c) = const_user + w_c + <sum_user v, v_c>`` (a
    one-hot candidate has no self-interaction), so scoring C candidates is
    one mat-vec; ``const_user = b + sum wu + user_pair`` is the logit of
    the user's fields alone (`fm_logits`)."""
    Fu = user_idx.shape[0]
    user_rows = (user_idx.to(torch.int64)
                 + cfg.field_offsets(user_idx.device)[:Fu])
    vu, _ = _gather(params, user_rows)                        # (Fu, K)
    su = vu.sum(dim=0)                                         # (K,)
    const = fm_logits(params, dataclasses.replace(cfg, n_sparse=Fu),
                      user_idx[None])[0]
    vc, wc = _gather(params, candidate_rows.to(torch.int64))  # (C, K)
    return const + wc + vc @ su
