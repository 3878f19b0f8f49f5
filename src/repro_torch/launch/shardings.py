"""Per-architecture sharding policies for the production mesh
(``repro.launch.shardings``).

Axis roles:
  ("pod","data") — batch / RRRset-theta / edge-parallel axes
  "model"        — tensor/expert/vocab/vertex-counter axis

LM policies (chosen per arch):
  * "tp"        — Megatron tensor parallel on heads/ffn/vocab; params
                  replicated over data (small archs: qwen, danube).
  * "row"       — row-parallel attention (head-count agnostic: minicpm's 36
                  heads don't divide 16) + TP ffn; FSDP-style vocab shard.
  * "moe_ep"    — experts over "model" (E % 16 == 0: moonshot 64e) + FSDP
                  storage shard of the expert d axis over "data".
  * "moe_tpe"   — TP inside experts over "model" (grok 8e) + FSDP storage
                  shard over "data".

A spec is `repro_torch.runtime.elastic`'s: a tuple with one entry a
leading dim, each ``None``, an axis name or a tuple of names.  `P` is
such a tuple, normalized as ``jax.sharding.PartitionSpec`` normalizes it
(a one-name tuple is the name), so a spec here equals
``tuple(PartitionSpec(...))`` of the reference's; its own type tells a
spec from the tuples of a tree that hold specs.  The port's parameter
trees are dicts of tensors with the reference's leaf names (the LM's
layers stacked on a leading L axis), so the tables below map onto them
one to one.
"""
from __future__ import annotations

from repro_torch.launch.mesh import dp_axes
from repro_torch.runtime.elastic import NamedSharding


class P(tuple):
    """A partition spec: ``PartitionSpec(*entries)`` as a tuple."""

    def __new__(cls, *entries):
        out = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else e[0] if len(e) == 1 else e
            out.append(e)
        return super().__new__(cls, out)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


LM_POLICY = {
    "qwen1.5-0.5b": "tp",
    "h2o-danube-3-4b": "tp",
    "minicpm-2b": "row",
    "moonshot-v1-16b-a3b": "moe_ep",
    "grok-1-314b": "moe_tpe",
}

# grad-accumulation microbatches for train_4k (bounds MoE dispatch buffers
# and activation residency); "auto" -> one dp-row of sequences per
# microbatch (B/dp_size), the per-device-minimal setting grok needs
LM_TRAIN_MICROBATCHES = {
    "grok-1-314b": "auto",
    "moonshot-v1-16b-a3b": 8,
    "minicpm-2b": 1,
    "h2o-danube-3-4b": 1,
    "qwen1.5-0.5b": 1,
}

# chunked prefill for MoE archs (bounds per-chunk dispatch size)
LM_PREFILL_CHUNK = {
    "grok-1-314b": 2048,
    "moonshot-v1-16b-a3b": 4096,
}


def _lm_layer_spec(name: str, ndim: int, policy: str, dp: tuple):
    """Spec for a stacked (L, ...) layer param by name."""
    m = "model"
    d = dp[-1] if dp else None          # "data" (storage/FSDP axis)
    if name in ("ln1", "ln2"):
        return P(None, None)
    if policy in ("tp", "row"):
        row = policy == "row"
        table = {
            "wq": P(None, "model", None) if row else P(None, None, m),
            "wk": P(None, "model", None) if row else P(None, None, m),
            "wv": P(None, "model", None) if row else P(None, None, m),
            "wo": P(None, None, "model") if row else P(None, m, None),
            "bq": P(None, None) if row else P(None, m),
            "bk": P(None, None) if row else P(None, m),
            "bv": P(None, None) if row else P(None, m),
            "w_gate_up": P(None, None, m),
            "w_down": P(None, m, None),
            "router": P(None, None, None),
        }
        return table[name]
    if policy == "moe_ep":
        table = {
            "wq": P(None, None, m),
            "wk": P(None, None, m),
            "wv": P(None, None, m),
            "wo": P(None, m, None),
            "bq": P(None, m), "bk": P(None, m), "bv": P(None, m),
            "router": P(None, None, None),
            # (L, E, d, 2ff): experts over model, d over data (storage)
            "w_gate_up": P(None, m, d, None),
            # (L, E, ff, d): experts over model, ff over data (storage)
            "w_down": P(None, m, d, None),
        }
        return table[name]
    if policy == "moe_tpe":
        table = {
            # grok: q heads 48/16 ok; kv heads 8 stay unsharded
            "wq": P(None, d, m),
            "wk": P(None, d, None),
            "wv": P(None, d, None),
            "wo": P(None, m, d),
            "bq": P(None, m), "bk": P(None, None), "bv": P(None, None),
            "router": P(None, None, None),
            # (L, E, d, 2ff): TP on ff over model, storage shard d over data
            "w_gate_up": P(None, None, d, m),
            # (L, E, ff, d): TP on ff (row-parallel) over model, d over data
            "w_down": P(None, None, m, d),
        }
        return table[name]
    raise ValueError(policy)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts and lists
    (``path`` the tuple of keys and indices), keeping the tree's
    structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def lm_param_specs(params_shape, policy: str, mesh):
    """Tree of specs matching an `init_lm` parameter tree."""
    dp = dp_axes(mesh)
    m = "model"

    def spec_of(keys, leaf):
        if keys[0] == "embed":
            # vocab padded to a model-axis multiple by launch/steps.py
            # (Megatron-style) so odd vocabs (minicpm 122753) still
            # row-shard
            return P(m, None)
        if keys[0] == "lm_head":
            return P(None, m)
        if keys[0] == "ln_f":
            return P(None)
        if keys[0] == "layers":
            return _lm_layer_spec(keys[1], leaf.ndim, policy, dp)
        raise KeyError(keys)

    return map_with_path(spec_of, params_shape)


def gnn_param_specs(params_shape, mesh):
    """GNN weights are small: replicated."""
    return map_with_path(lambda _, leaf: P(*([None] * leaf.ndim)),
                         params_shape)


def fm_param_specs(params_shape, mesh):
    """Row-shard the embedding tables over "model"."""
    def spec_of(keys, leaf):
        if keys[0] == "v":
            return P("model", None)
        if keys[0] == "w":
            return P("model")
        return P(*([None] * leaf.ndim))

    return map_with_path(spec_of, params_shape)


def opt_state_specs(param_specs):
    """AdamW moments shard exactly like their parameters."""
    return {"mu": param_specs, "nu": param_specs, "step": P()}


def kv_cache_spec(n_kv_heads: int, mesh, *, batch: int):
    """(L, B, Hkv, S, hd): batch over dp when it divides; heads over model
    when divisible, else the sequence axis."""
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    b_axis = dp if batch % dp_size == 0 and batch >= dp_size else None
    if n_kv_heads % mesh.shape["model"] == 0:
        return P(None, b_axis, "model", None, None)
    return P(None, b_axis, None, "model", None)


def map_specs(fn, tree):
    """``fn(spec)`` over the `P` leaves of a tree of dicts, tuples and
    lists."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {tree!r}")


def named(mesh, spec_tree):
    """The tree's specs as `NamedSharding`s on ``mesh``."""
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)
