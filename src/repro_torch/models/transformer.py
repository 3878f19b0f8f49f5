"""Decoder-only transformer LM (``repro.models.transformer``): RoPE + GQA
+ optional sliding window + optional QKV bias + a dense or MoE FFN, on
one device: the training loss and its gradient, prefill (whole and
chunked) and KV-cache decode.

Parameters are a dict of tensors mirroring the reference's tree, with the
per-layer weights stacked on a leading L axis (``params["layers"]["wq"]``
is ``(L, d, H * hd)``), so `repro_torch.convert.lm_params_from_jax` maps
one onto the other leaf for leaf.  PyTorch runs eagerly: the reference's
``lax.scan`` over layers is a Python loop.  ``remat`` wraps each layer of
`lm_hidden` in ``torch.utils.checkpoint`` when a gradient is being taken,
as ``jax.checkpoint`` does; `lm_loss`'s CE chunks are checkpointed too, so
the ``(B, S, V)`` logits never exist at once.  On the card attention runs
through the ``flash_attention`` kernel and its gradient through the
backward kernel (`repro_torch.kernels.flash_attention.FlashAttention`); a
checkpointed layer launches the forward kernel again when it is
recomputed.

The MoE FFN (``n_experts > 0``) is `_moe_ffn`, the reference's gather
dispatch (`repro_torch.models.moe`); with ``moe_impl="shard_map"`` the
training path takes `repro_torch.models.moe_sharded` on its ``MESH``
instead, while prefill and decode keep `_moe_ffn`, as in the reference.
The activation-sharding fields of `LMConfig` have no effect on one
device.

Unlike the reference, `decode_step` writes the new key and value into the
cache tensors in place (the returned cache holds the same tensors).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import moe, moe_sharded
from repro_torch.models.attention import (attention, blockwise_attention,
                                          rope_tables, rotate)
from repro_torch.models.common import (dense_init, rms_norm, take_index,
                                       take_rows)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1000
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    window: int = 0              # sliding window; 0 = full causal
    rope_theta: float = 10000.0
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # the meshed MoE (moe_impl "shard_map": models/moe_sharded.py on its
    # MESH): the data axes the tokens' batch is split over, and "ep"
    # (experts over "model") or "tpe" (each expert's ff over "model")
    moe_shard_axes: tuple = ()
    moe_partition: str = "tpe"
    moe_impl: str = "dense"
    # the reference's activation-sharding fields: no effect on one device
    act_batch_axes: tuple = ()
    act_seq_axis: str = ""
    # muP-ish scaling (minicpm)
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    dtype: str = "float32"
    remat: bool = True           # checkpoint each layer under a gradient
    # serving
    max_cache_len: int = 0       # 0 -> set per call

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.n_experts:
            ffn = self.n_experts * (d * 2 * self.d_ff + self.d_ff * d) \
                + d * self.n_experts
        else:
            ffn = d * 2 * self.d_ff + self.d_ff * d
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """6·N_active·D accounting for MoE top-k (DESIGN roofline)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        hd = self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = self.top_k * (d * 2 * self.d_ff + self.d_ff * d) \
            + d * self.n_experts
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


# ----------------------------------------------------------------- init ----

def init_lm(gen: torch.Generator, cfg: LMConfig, device=None) -> dict:
    """Random parameters of the reference's shapes and scales: embedding
    ``N(0, 0.02)``, projections ``N(0, 1/fan_in)``, norms one, biases
    zero; with experts a float32 router ``(L, d, E)`` (whatever
    ``cfg.dtype``) and experts ``w_gate_up (L, E, d, 2 ff)``, ``w_down
    (L, E, ff, d)`` drawn ``N(0, 1) / sqrt(fan_in)``.  Drawn in f32 on
    ``gen``'s device, cast to ``cfg.dtype`` and moved to ``device``
    (``cuda`` unless told otherwise; without a GPU that raises unless
    ``device="cpu"``)."""
    target = resolve_device(device)
    dev = gen.device
    dtype = getattr(torch, cfg.dtype)
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H, Hkv = cfg.n_heads, cfg.n_kv_heads

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    embed = torch.randn((cfg.vocab, d), generator=gen, device=dev)
    layers = {
        "ln1": ones(L, d), "ln2": ones(L, d),
        "wq": dense_init(gen, d, H * hd, dtype, lead=(L,)),
        "wk": dense_init(gen, d, Hkv * hd, dtype, lead=(L,)),
        "wv": dense_init(gen, d, Hkv * hd, dtype, lead=(L,)),
        "wo": dense_init(gen, H * hd, d, dtype, lead=(L,)),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        layers.update(
            router=dense_init(gen, d, E, torch.float32, lead=(L,)),
            w_gate_up=moe.expert_init(gen, (L, E), d, 2 * cfg.d_ff, dtype),
            w_down=moe.expert_init(gen, (L, E), cfg.d_ff, d, dtype))
    else:
        layers.update(
            w_gate_up=dense_init(gen, d, 2 * cfg.d_ff, dtype, lead=(L,)),
            w_down=dense_init(gen, cfg.d_ff, d, dtype, lead=(L,)))
    if cfg.qkv_bias:
        layers.update(bq=zeros(L, H * hd), bk=zeros(L, Hkv * hd),
                      bv=zeros(L, Hkv * hd))
    params = {
        "embed": embed.mul_(0.02).to(dtype),
        "layers": layers,
        "ln_f": ones(d),
        "lm_head": dense_init(gen, d, cfg.vocab, dtype),
    }
    return _tree_map(lambda t: t.to(target), params)


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: dict, path=()) -> list:
    """``[(path, tensor)]`` of nested dicts, in `_tree_map`'s order."""
    out = []
    for k, v in tree.items():
        out += (tree_leaves(v, path + (k,)) if isinstance(v, dict)
                else [(path + (k,), v)])
    return out


def _layers(params: dict) -> list:
    """The per-layer weight dicts (views of the stacked leaves)."""
    names = list(params["layers"])
    return [dict(zip(names, ws)) for ws in
            zip(*(params["layers"][n].unbind(0) for n in names))]


def _scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s``; ``s == 1.0`` changes no bit, so it is skipped."""
    return x if s == 1.0 else x * s


# -------------------------------------------------------------- MoE ffn ----

def _moe_ffn(p: dict, x2d: torch.Tensor, cfg: LMConfig):
    """The reference's gather dispatch of ``x2d (T, d)``: ``(y (T, d) in
    x2d's dtype, aux ())``.  Top-k routing with ``C = max(int(cf * k * T
    / E), 1)`` slots an expert, sort-based slot maps, the tokens copied
    into their slots, two batched expert matmuls in the model's dtype,
    the gate-weighted outputs summed back per token in float32, and the
    load-balance loss (`repro_torch.models.moe`)."""
    r = moe.route(x2d, p["router"], cfg.n_experts, cfg.top_k,
                  cfg.capacity_factor)
    ye = moe.experts(moe.dispatch(x2d, r), p["w_gate_up"], p["w_down"])
    return moe.combine(ye, r).to(x2d.dtype), moe.aux_loss(r)


def _dense_ffn(p: dict, x: torch.Tensor):
    """SwiGLU FFN on any leading dims; returns ``(y, aux = 0)``."""
    gu = x @ p["w_gate_up"]
    g, u = gu.chunk(2, dim=-1)
    return (F.silu(g) * u) @ p["w_down"], 0.0


def _ffn(p: dict, h: torch.Tensor, cfg: LMConfig, *, sharded: bool):
    """The FFN sublayer of ``h (B, S, d)``: ``(y (B, S, d), aux)``.
    ``sharded`` lets ``moe_impl="shard_map"`` take the meshed MoE (the
    training path; prefill and decode always run `_moe_ffn`)."""
    if not cfg.n_experts:
        return _dense_ffn(p, h)
    if sharded and cfg.moe_impl == "shard_map":
        return moe_sharded.moe_ffn_sharded(p, h, cfg)
    B, S, d = h.shape
    y, a = _moe_ffn(p, h.reshape(B * S, d), cfg)
    return y.view(B, S, d), a


# -------------------------------------------------------------- forward ----

def _qkv(p: dict, h: torch.Tensor, cfg: LMConfig, rope):
    """Projections of ``h (B, S, d)`` to ``(B, H, S, hd)`` heads, q and k
    rotated by the ``rope`` tables (one rotation of both)."""
    B, S, _ = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    qk = torch.cat([q, k], dim=-1).reshape(B, S, H + Hkv, hd).transpose(1, 2)
    qk = rotate(qk, *rope)
    return (qk[:, :H], qk[:, H:],
            v.reshape(B, S, Hkv, hd).transpose(1, 2))


def _attn_block(p: dict, x: torch.Tensor, cfg: LMConfig, rope):
    """Attention sublayer of ``x (B, S, d)``: ``(out (B, S, d), (k, v))``
    with k and v after RoPE, ``(B, Hkv, S, hd)``."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, rms_norm(x, p["ln1"]), cfg, rope)
    out = attention(q, k, v, causal=True, window=cfg.window)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], (k, v)


def _block(p: dict, x: torch.Tensor, cfg: LMConfig, rope, *,
           sharded: bool = False):
    """One layer of ``x (B, S, d)``: ``(x, aux, (k, v))``."""
    attn_out, kv = _attn_block(p, x, cfg, rope)
    x = x + _scaled(attn_out, cfg.residual_scale)
    y, aux = _ffn(p, rms_norm(x, p["ln2"]), cfg, sharded=sharded)
    return x + _scaled(y, cfg.residual_scale), aux, kv


def _train_block(p: dict, x: torch.Tensor, cfg: LMConfig, rope):
    """`_block` without its cache: what a checkpointed layer recomputes."""
    x, aux, _ = _block(p, x, cfg, rope, sharded=True)
    return x, aux


def _embed(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """The scaled embeddings of ``tokens``; a token outside ``[-vocab,
    vocab)`` embeds as NaN, as the reference's ``jnp.take`` does, and
    ``[-vocab, 0)`` wraps (`take_index`).  The table's gradient sums a
    repeated token's rows in a fixed order (`GatherRows`), so a training
    step has the same bits on every run."""
    table = params["embed"]
    return _scaled(take_rows(table, *take_index(tokens, table.shape[0]),
                             stable_grad=True), cfg.emb_scale)


def _head(params: dict, cfg: LMConfig, x: torch.Tensor):
    return _scaled(rms_norm(x, params["ln_f"]) @ params["lm_head"],
                   cfg.logit_scale)


def _rope(cfg: LMConfig, positions: torch.Tensor):
    return rope_tables(positions[None, None, :], cfg.head_dim,
                       cfg.rope_theta)


def lm_hidden(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (final normed hidden (B, S, d), aux_loss ()), the
    aux loss the layers' mean (0.0 for a dense model).  With
    ``cfg.remat`` and a gradient being taken, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward."""
    x = _embed(params, cfg, tokens)
    rope = _rope(cfg, torch.arange(tokens.shape[1], device=x.device))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for p in _layers(params):
        if remat:
            x, a = checkpoint(_train_block, p, x, cfg, rope,
                              use_reentrant=False)
        else:
            x, a = _train_block(p, x, cfg, rope)
        aux = aux + a
    return rms_norm(x, params["ln_f"]), aux / cfg.n_layers


def lm_forward(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V), aux_loss ())."""
    x, aux = lm_hidden(params, cfg, tokens)
    return _scaled(x @ params["lm_head"], cfg.logit_scale), aux


def _chunk_nll(x: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
               logit_scale: float):
    """The summed next-token NLL of one CE chunk ``x (B, c, d)`` (labels
    below 0 masked): float32 logits, logsumexp minus the gold logit."""
    logits = _scaled((x @ head).to(torch.float32), logit_scale)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return ((logz - gold) * (labels >= 0)).sum()


def lm_loss(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *, ce_chunk: int = 512):
    """Next-token cross entropy (labels = tokens shifted by the caller,
    -1 masked) plus ``aux_loss_weight * aux``.

    The ``(B, S, V)`` logits never exist at once: the CE walks the
    sequence in ``ce_chunk`` slices, each under checkpoint when a
    gradient is being taken, so one ``(B, chunk, V)`` float32 slice is
    live at a time, forward and backward.  The last slice is shorter when
    ``S`` is not a multiple of the chunk (the reference pads it and masks
    the padding: the same sums)."""
    x, aux = lm_hidden(params, cfg, tokens)
    S = x.shape[1]
    chunk = min(ce_chunk, S)
    grad = torch.is_grad_enabled()
    head = params["lm_head"]
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xb, lb = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if grad:
            nll = checkpoint(_chunk_nll, xb, lb, head, cfg.logit_scale,
                             use_reentrant=False)
        else:
            nll = _chunk_nll(xb, lb, head, cfg.logit_scale)
        nll_sum = nll_sum + nll
    n_tok = (labels >= 0).sum().clamp(min=1)
    return nll_sum / n_tok.to(torch.float32) + cfg.aux_loss_weight * aux


def lm_value_and_grad(params: dict, cfg: LMConfig, tokens: torch.Tensor,
                      labels: torch.Tensor, *, ce_chunk: int = 512):
    """``(loss, grads)`` of `lm_loss`, grads a tree like ``params``: the
    counterpart of ``jax.value_and_grad(lm_loss)``.  ``params`` is left
    as it is (its leaves are differentiated through detached aliases)."""
    leaves = _tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = lm_loss(leaves, cfg, tokens, labels, ce_chunk=ce_chunk)
    flat = [t for _, t in tree_leaves(leaves)]
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), _tree_map(lambda _: next(grads), leaves)


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """Serving prefill: last-position logits ``(B, V)`` and the per-layer
    KV, ``{"k", "v": (L, B, Hkv, S, hd), "len": S}``."""
    x = _embed(params, cfg, tokens)
    rope = _rope(cfg, torch.arange(tokens.shape[1], device=x.device))
    ks, vs = [], []
    for p in _layers(params):
        x, _, (k, v) = _block(p, x, cfg, rope)
        ks.append(k)
        vs.append(v)
    logits = _head(params, cfg, x[:, -1:])
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs),
                          "len": tokens.shape[1]}


def prefill_chunked(params: dict, cfg: LMConfig, tokens: torch.Tensor, *,
                    chunk: int = 4096):
    """Chunked (Sarathi-style) prefill: the sequence runs in ``chunk``-token
    slices, so a MoE's dispatch buffers stay bounded by the chunk.  Each
    layer writes the slice's keys and values into a bfloat16 cache of the
    whole length and attends to the cache with `blockwise_attention`
    (``kv_len`` masks the unfilled tail, ``q_offset`` the slice start
    gives in-slice causality), as the reference does; no kernel runs.

    Returns (last-position logits (B, V), cache {k, v, len}) like
    `prefill`."""
    B, S = tokens.shape
    if S % chunk:
        raise ValueError(f"prefill_chunked: S = {S} is not a multiple of "
                         f"the chunk {chunk}")
    H, hd = cfg.n_heads, cfg.head_dim
    dev = params["embed"].device
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, hd)
    ck = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    cv = torch.zeros_like(ck)
    layers = _layers(params)
    x = None
    for c0 in range(0, S, chunk):
        x = _embed(params, cfg, tokens[:, c0:c0 + chunk])
        rope = _rope(cfg, torch.arange(c0, c0 + chunk, device=dev))
        kv_len = torch.full((B,), c0 + chunk, dtype=torch.int32, device=dev)
        for li, p in enumerate(layers):
            q, k, v = _qkv(p, rms_norm(x, p["ln1"]), cfg, rope)
            ck[li, :, :, c0:c0 + chunk] = k
            cv[li, :, :, c0:c0 + chunk] = v
            out = blockwise_attention(
                q, ck[li].to(q.dtype), cv[li].to(q.dtype), causal=True,
                window=cfg.window, kv_len=kv_len, q_offset=c0)
            out = out.transpose(1, 2).reshape(B, chunk, H * hd)
            x = x + _scaled(out @ p["wo"], cfg.residual_scale)
            y, _ = _ffn(p, rms_norm(x, p["ln2"]), cfg, sharded=False)
            x = x + _scaled(y, cfg.residual_scale)
    logits = _head(params, cfg, x[:, -1])
    return logits, {"k": ck, "v": cv, "len": S}


# --------------------------------------------------------------- decode ----

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """An empty cache ``{"k", "v": (L, B, Hkv, max_len, hd), "len": 0}``;
    bf16 whatever the model's dtype, as the reference's."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def decode_step(params: dict, cfg: LMConfig, cache: dict,
                tokens: torch.Tensor):
    """One token for every sequence: tokens (B, 1) -> (next (B, 1), cache),
    the greedy (first) argmax of `decode_logits`."""
    logits, cache = decode_logits(params, cfg, cache, tokens)
    return torch.argmax(logits, dim=-1).to(tokens.dtype), cache


def decode_logits(params: dict, cfg: LMConfig, cache: dict,
                  tokens: torch.Tensor):
    """The decode step's logits: tokens (B, 1) -> (logits (B, 1, V),
    cache).

    ``cache["len"]`` (an int) is the position of this token.  Full
    attention writes slot ``min(pos, max_len - 1)`` (an overflow
    overwrites the last slot); with ``cfg.window > 0`` the cache is a
    ring buffer and slot ``s`` holds position ``pos - ((pos - s) %
    max_len)``.  Attention over the cache is the reference's plain
    masked product, not the kernel: q cast to the cache dtype, scores
    summed in f32 and divided by ``sqrt(hd)``, masked with ``-1e30``, an
    f32 softmax, the probabilities cast to the cache dtype, and P.V summed
    in f32 (both bf16 operands upcast: their products are exact in f32).
    The new key and value are written into ``cache``'s tensors in place.
    """
    B = tokens.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(cache["len"])
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[3]
    slot = pos % max_len if cfg.window > 0 else min(pos, max_len - 1)
    dev = ck.device

    x = _embed(params, cfg, tokens)                      # (B, 1, d)
    slots = torch.arange(max_len, device=dev)
    kpos = pos - ((pos - slots) % max_len) if cfg.window > 0 else slots
    masked = (kpos < 0) | (kpos > pos)
    if cfg.window > 0:
        masked |= kpos <= pos - cfg.window
    rope = rope_tables(torch.full((1, 1, 1), pos, device=dev), hd,
                       cfg.rope_theta)
    for i, p in enumerate(_layers(params)):
        q, k, v = _qkv(p, rms_norm(x, p["ln1"]), cfg, rope)
        ck[i, :, :, slot] = k[:, :, 0]
        cv[i, :, :, slot] = v[:, :, 0]
        qg = q.reshape(B, Hkv, H // Hkv, hd).to(ck.dtype).to(torch.float32)
        s = qg @ ck[i].to(torch.float32).transpose(-1, -2) / math.sqrt(hd)
        probs = torch.softmax(s.masked_fill_(masked, -1e30), dim=-1)
        out = probs.to(cv.dtype).to(torch.float32) @ cv[i].to(torch.float32)
        out = out.reshape(B, 1, H * hd).to(x.dtype) @ p["wo"]
        x = x + _scaled(out, cfg.residual_scale)
        y, _ = _ffn(p, rms_norm(x, p["ln2"]), cfg, sharded=False)
        x = x + _scaled(y, cfg.residual_scale)
    return _head(params, cfg, x), {"k": ck, "v": cv, "len": pos + 1}
