"""Decoder-only transformer LM (``repro.models.transformer``): RoPE + GQA
+ optional sliding window + optional QKV bias, dense FFN, for serving
(prefill and KV-cache decode) on one device.

Parameters are a dict of tensors mirroring the reference's tree, with the
per-layer weights stacked on a leading L axis (``params["layers"]["wq"]``
is ``(L, d, H * hd)``), so `repro_torch.convert.lm_params_from_jax` maps
one onto the other leaf for leaf.  PyTorch runs eagerly: the reference's
``lax.scan`` over layers is a Python loop, and ``remat`` and the sharding
fields of `LMConfig` are accepted and have no effect (serving runs
forward only, on one device).  MoE (``n_experts > 0``) raises naming
ROADMAP A9; ``lm_loss`` and ``prefill_chunked`` wait for the training and
MoE slices.

Unlike the reference, `decode_step` writes the new key and value into the
cache tensors in place (the returned cache holds the same tensors).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.attention import attention, rope_tables, rotate
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
    # MoE (n_experts == 0 -> dense FFN); MoE waits for ROADMAP A9
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # the reference's mesh fields: accepted, no effect on one device
    moe_shard_axes: tuple = ()
    moe_partition: str = "tpe"
    moe_impl: str = "dense"
    act_batch_axes: tuple = ()
    act_seq_axis: str = ""
    # muP-ish scaling (minicpm)
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    dtype: str = "float32"
    remat: bool = True           # no effect: serving runs forward only
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


def _dense_only(cfg: LMConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: n_experts = {cfg.n_experts}; the MoE FFN "
            f"(models/moe.py, moe_sharded.py) is not ported yet (ROADMAP A9)")


# ----------------------------------------------------------------- init ----

def init_lm(gen: torch.Generator, cfg: LMConfig, device=None) -> dict:
    """Random parameters of the reference's shapes and scales: embedding
    ``N(0, 0.02)``, projections ``N(0, 1/fan_in)``, norms one, biases
    zero; drawn in f32 on ``gen``'s device, cast to ``cfg.dtype`` and
    moved to ``device`` (``cuda`` unless told otherwise; without a GPU
    that raises unless ``device="cpu"``)."""
    _dense_only(cfg)
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
        "w_gate_up": dense_init(gen, d, 2 * cfg.d_ff, dtype, lead=(L,)),
        "w_down": dense_init(gen, cfg.d_ff, d, dtype, lead=(L,)),
    }
    if cfg.qkv_bias:
        layers.update(bq=zeros(L, H * hd), bk=zeros(L, Hkv * hd),
                      bv=zeros(L, Hkv * hd))
    params = {
        "embed": embed.mul_(0.02).to(dtype),
        "layers": layers,
        "ln_f": ones(d),
        "lm_head": dense_init(gen, d, cfg.vocab, dtype),
    }
    return _to(params, target)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _layers(params: dict) -> list:
    """The per-layer weight dicts (views of the stacked leaves)."""
    names = list(params["layers"])
    return [dict(zip(names, ws)) for ws in
            zip(*(params["layers"][n].unbind(0) for n in names))]


def _scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s``; ``s == 1.0`` changes no bit, so it is skipped."""
    return x if s == 1.0 else x * s


# -------------------------------------------------------------- forward ----

def _dense_ffn(p: dict, x: torch.Tensor):
    """SwiGLU FFN on any leading dims; returns ``(y, aux = 0)``."""
    gu = x @ p["w_gate_up"]
    g, u = gu.chunk(2, dim=-1)
    return (F.silu(g) * u) @ p["w_down"], 0.0


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


def _block(p: dict, x: torch.Tensor, cfg: LMConfig, rope):
    """One layer of ``x (B, S, d)``: ``(x, (k, v))``."""
    attn_out, kv = _attn_block(p, x, cfg, rope)
    x = x + _scaled(attn_out, cfg.residual_scale)
    y, _ = _dense_ffn(p, rms_norm(x, p["ln2"]))
    return x + _scaled(y, cfg.residual_scale), kv


def _embed(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """The scaled embeddings of ``tokens``; a token outside ``[-vocab,
    vocab)`` embeds as NaN, as the reference's ``jnp.take`` does, and
    ``[-vocab, 0)`` wraps (`take_index`)."""
    table = params["embed"]
    return _scaled(take_rows(table, *take_index(tokens, table.shape[0])),
                   cfg.emb_scale)


def _head(params: dict, cfg: LMConfig, x: torch.Tensor):
    return _scaled(rms_norm(x, params["ln_f"]) @ params["lm_head"],
                   cfg.logit_scale)


def _layer_stack(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """Every layer over ``tokens (B, S)``: ``(x (B, S, d), [(k, v)])``."""
    _dense_only(cfg)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    rope = rope_tables(positions[None, None, :], cfg.head_dim,
                       cfg.rope_theta)
    kvs = []
    for p in _layers(params):
        x, kv = _block(p, x, cfg, rope)
        kvs.append(kv)
    return x, kvs


def lm_hidden(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (final normed hidden (B, S, d), aux_loss 0.0)."""
    x, _ = _layer_stack(params, cfg, tokens)
    return rms_norm(x, params["ln_f"]), 0.0


def lm_forward(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V), aux_loss 0.0)."""
    x, _ = _layer_stack(params, cfg, tokens)
    return _head(params, cfg, x), 0.0


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """Serving prefill: last-position logits ``(B, V)`` and the per-layer
    KV, ``{"k", "v": (L, B, Hkv, S, hd), "len": S}``."""
    x, kvs = _layer_stack(params, cfg, tokens)
    logits = _head(params, cfg, x[:, -1:])
    return logits[:, 0], {"k": torch.stack([k for k, _ in kvs]),
                          "v": torch.stack([v for _, v in kvs]),
                          "len": tokens.shape[1]}


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
    _dense_only(cfg)
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
        y, _ = _dense_ffn(p, rms_norm(x, p["ln2"]))
        x = x + _scaled(y, cfg.residual_scale)
    return _head(params, cfg, x), {"k": ck, "v": cv, "len": pos + 1}
