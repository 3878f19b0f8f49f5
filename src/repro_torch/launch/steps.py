"""The cells: (arch x shape x mesh) -> a step function, its
input shapes and its shardings (``repro.launch.steps``).

Every assigned cell plus the IMM production cells map here onto a
production mesh (`repro_torch.launch.mesh`).  Policies live in
`repro_torch.launch.shardings`; model math stays in `repro_torch.models`
and `repro_torch.core`.

A `Cell` holds what the reference's holds.  ``input_specs`` are ``meta``
tensors of the inputs' shapes and dtypes (the counterpart of
``jax.ShapeDtypeStruct``): parameter and optimizer shapes come from the
models' own ``init`` functions run under ``FakeTensorMode``, so a cell of
grok-1-314b is built without drawing or allocating its 316 B parameters.
``in_shardings`` and ``out_shardings`` are trees of
`repro_torch.runtime.elastic.NamedSharding`; the dry run
(`repro_torch.launch.dryrun`) reads its bytes per device from them.

The steps take **logical** tensors on the mesh's device.  There is no
``jax.jit`` to split them: the port's meshed bodies split their operands
into tiles themselves (`repro_torch.models.moe_sharded` for the MoE train
path, `repro_torch.sparse.embedding_bag.sharded_embedding_lookup` for the
FM tables, `repro_torch.models.gnn.graphcast.loss_edges_dst_partitioned`
for GraphCast, `repro_torch.core.selection.select_dense_sharded` for the
IMM selection), and the other bodies run whole on the mesh's device.  So
the shardings say how the reference lays a cell out; a step on a mesh of
one card runs the same tiled code as on 256 chips, tile by tile.

A train step updates its state in place (`repro_torch.optim.
adamw_update_`, the clip's scale folded in) and returns it: the
counterpart of the reference's dry run donating the state, so a step's
peak holds no second copy of the parameters, the moments or the
gradients.  Two fields are the port's own: ``make_inputs(gen, device)``
draws a cell's inputs at its shapes from ``gen``, and ``output_specs``
holds its outputs' shapes, which the reference reads off the lowered
function.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_arch
from repro_torch.configs._gnn_common import minibatch_subgraph_dims
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import dp_axes, make_local_mesh
from repro_torch.launch.shardings import P
from repro_torch.models.common import value_and_grad
from repro_torch.models.gnn import egnn as m_egnn
from repro_torch.models.gnn import equiformer as m_equiformer
from repro_torch.models.gnn import graphcast as m_graphcast
from repro_torch.models.gnn import graphsage as m_sage
from repro_torch.models.recsys import fm as m_fm
from repro_torch.models.transformer import (
    LMConfig, decode_step, init_lm, lm_value_and_grad, prefill,
    prefill_chunked,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_
from repro_torch.optim.adamw import tree_map
from repro_torch.optim.clip import global_norm_scale
from repro_torch.sparse.embedding_bag import (
    row_shards, sharded_embedding_lookup,
)
from repro_torch import mesh as M


def _sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: a shape and a dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _meta(tree):
    """Every tensor of ``tree`` as a `_sds` of its shape and dtype."""
    return tree_map(lambda t: _sds(t.shape, t.dtype), tree)


def _abstract(fn, *args, **kwargs):
    """``fn``'s output tree as `_sds` leaves, run under ``FakeTensorMode``
    so that nothing is drawn or allocated (``jax.eval_shape``)."""
    with FakeTensorMode():
        out = fn(*args, **kwargs)
    return _meta(out)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    step_fn: Callable
    input_specs: tuple               # positional meta tensors (trees)
    in_shardings: Any
    out_shardings: Any
    model_flops: float               # analytic "useful" flops (global)
    note: str = ""
    # ideal HBM traffic of a fused (flash) attention, GLOBAL bytes
    attention_ideal_bytes: float = 0.0
    # port-only: ``make_inputs(gen, device)`` -> the step's positional
    # inputs at ``input_specs``' shapes, drawn from ``gen``
    make_inputs: Callable = None
    # port-only: the outputs' shapes and dtypes as meta tensors (what a
    # lowered function's out avals give the reference), a tree like
    # ``out_shardings``
    output_specs: Any = None


def _lm_attention_ideal_bytes(cfg: LMConfig, kind: str, batch: int,
                              q_len: int, kv_len: int) -> float:
    """Q/K/V/O HBM traffic of a fused attention kernel, all layers, bytes.

    fwd: read Q,K,V + write O; bwd: read Q,K,V,O,dO + write dQ,dK,dV;
    remat adds one extra fwd. bf16 elements.
    """
    hd = cfg.head_dim
    qo = batch * q_len * cfg.n_heads * hd
    kv = batch * kv_len * cfg.n_kv_heads * hd
    fwd = 2.0 * (qo * 2 + kv * 2)
    if kind == "train":
        bwd = 2.0 * (qo * 3 + kv * 4)
        per_layer = 2 * fwd + bwd          # fwd + remat-fwd + bwd
    else:
        per_layer = fwd
    return cfg.n_layers * per_layer


def _dp_size(mesh) -> int:
    size = 1
    for a in dp_axes(mesh):
        size *= mesh.shape[a]
    return size


def _pad_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _update(state: dict, grads, opt_cfg: AdamWConfig) -> torch.Tensor:
    """Clip 1 and AdamW, in place on ``state``; the unclipped norm."""
    scale, gnorm = global_norm_scale(grads, 1.0)
    adamw_update_(state["params"], grads, state["opt"], opt_cfg, scale)
    return gnorm


def _train_state(params, opt_cfg: AdamWConfig) -> dict:
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def _metric_shapes() -> dict:
    return {"loss": _sds((), torch.float32),
            "grad_norm": _sds((), torch.float32)}


def _state_specs(p_specs) -> dict:
    return {"params": p_specs, "opt": sh.opt_state_specs(p_specs)}


# =========================================================== LM family ====

@functools.lru_cache(maxsize=64)
def _param_shapes(init_fn, cfg) -> dict:
    """``init_fn(gen, cfg)``'s parameter shapes under ``FakeTensorMode``,
    built once a config (a dry run builds each on two meshes)."""
    return _abstract(init_fn, torch.Generator(), cfg, device="cpu")


def _lm_state_specs(cfg: LMConfig, mesh, opt_cfg: AdamWConfig):
    policy = sh.LM_POLICY.get(cfg.name, "tp")
    p_shapes = _param_shapes(init_lm, cfg)
    o_shapes = _meta(adamw_init(p_shapes, opt_cfg))
    p_specs = sh.lm_param_specs(p_shapes, policy, mesh)
    return ({"params": p_shapes, "opt": o_shapes}, _state_specs(p_specs))


def _lm_model_flops(cfg: LMConfig, kind: str, tokens: int) -> float:
    n_active = cfg.active_param_count()
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_active * tokens


def make_lm_train_step(cfg: LMConfig, opt_cfg: AdamWConfig,
                       microbatches: int):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``:
    the loss's gradient (accumulated in bf16 over ``microbatches`` slices
    of the batch and divided by their count), clip 1 and AdamW, the state
    updated in place."""
    def train_step(state, batch):
        params = state["params"]
        if microbatches <= 1:
            loss, grads = lm_value_and_grad(
                params, cfg, batch["tokens"], batch["labels"])
        else:
            B = batch["tokens"].shape[0]
            mb = B // microbatches
            toks = batch["tokens"].reshape(microbatches, mb, -1)
            labs = batch["labels"].reshape(microbatches, mb, -1)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=toks.device)
            for i in range(microbatches):
                loss_i, grads_i = lm_value_and_grad(params, cfg, toks[i],
                                                    labs[i])
                tree_map(lambda a, g: a.add_(g.to(a.dtype)), grads, grads_i)
                del grads_i
                loss = loss + loss_i
            tree_map(lambda g: g.div_(microbatches), grads)
            loss = loss / microbatches
            # the reference pins the optimizer phase after its scan with
            # jax.lax.optimization_barrier so that XLA does not hoist f32
            # copies of the weights into the loop; eager PyTorch hoists
            # nothing, so it has no counterpart here
        gnorm = _update(state, grads, opt_cfg)
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _on_moe_mesh(step, mesh):
    """``step`` with `repro_torch.models.moe_sharded.MESH` set to ``mesh``
    for each call and restored after: the reference sets the module's
    mesh when it builds a cell, so a cell's MoE layers would run on the
    mesh of whichever cell was built last; the port's step carries its
    own."""
    from repro_torch.models import moe_sharded

    @functools.wraps(step)
    def run(*args):
        prev, moe_sharded.MESH = moe_sharded.MESH, mesh
        try:
            return step(*args)
        finally:
            moe_sharded.MESH = prev
    return run


def _lm_labels(tokens: torch.Tensor) -> torch.Tensor:
    """Next-token labels: ``tokens`` shifted left, the last one masked."""
    labels = torch.full_like(tokens, -1)
    labels[:, :-1] = tokens[:, 1:]
    return labels


def _build_lm_cell(arch, shape, mesh) -> Cell:
    cfg: LMConfig = arch.config
    dims = shape.dims
    dp = dp_axes(mesh)
    B, S = dims["global_batch"], dims["seq_len"]
    policy = sh.LM_POLICY[cfg.name]
    big = cfg.name in ("grok-1-314b", "moonshot-v1-16b-a3b")
    opt_cfg = AdamWConfig(moment_dtype="bfloat16" if big else "float32")

    dp_size = _dp_size(mesh)
    # Megatron-style vocab padding so embed/lm_head always shard evenly
    cfg = dataclasses.replace(
        cfg, vocab=_pad_up(cfg.vocab, mesh.shape["model"]))
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, moe_shard_axes=tuple(dp),
            moe_partition="ep" if policy == "moe_ep" else "tpe",
            # train: the meshed all-to-all MoE pipeline + seq-parallel
            # activations
            moe_impl="shard_map" if shape.kind == "train" else "dense",
            act_batch_axes=tuple(dp) if shape.kind == "train" else (),
            act_seq_axis="model" if shape.kind == "train" else "")
    else:
        # dense archs: sequence-parallel activation constraints
        if shape.kind in ("train", "prefill"):
            cfg = dataclasses.replace(
                cfg, act_batch_axes=tuple(dp), act_seq_axis="model")

    def tokens(gen, device, shape_):
        return torch.randint(0, arch.config.vocab, shape_, generator=gen,
                             device=gen.device, dtype=torch.int32).to(device)

    if shape.kind == "train":
        mbs = sh.LM_TRAIN_MICROBATCHES[cfg.name]
        if mbs == "auto":
            mbs = max(B // dp_size, 1)
        state_shapes, state_specs = _lm_state_specs(cfg, mesh, opt_cfg)
        batch_shapes = {
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
        }
        # dense archs: sequence parallelism (activations sharded over
        # "model" on the seq axis); MoE archs keep seq unsharded and bound
        # buffers via microbatching + capacity sharding instead
        seq_axis = None if cfg.n_experts else "model"
        batch_specs = {"tokens": P(dp, seq_axis),
                       "labels": P(dp, seq_axis)}
        step = make_lm_train_step(cfg, opt_cfg, mbs)
        if cfg.moe_impl == "shard_map":
            step = _on_moe_mesh(step, mesh)
        metrics_specs = {"loss": P(), "grad_norm": P()}

        def make_inputs(gen, device):
            toks = tokens(gen, device, (B, S))
            return (_train_state(init_lm(gen, cfg, device=device), opt_cfg),
                    {"tokens": toks, "labels": _lm_labels(toks)})

        return Cell(
            arch.arch_id, shape.name, "train", step,
            (state_shapes, batch_shapes),
            sh.named(mesh, (state_specs, batch_specs)),
            sh.named(mesh, (state_specs, metrics_specs)),
            _lm_model_flops(cfg, "train", B * S),
            note=f"policy={policy} microbatches={mbs}",
            attention_ideal_bytes=_lm_attention_ideal_bytes(
                cfg, "train", B, S, S),
            make_inputs=make_inputs,
            output_specs=(state_shapes, _metric_shapes()))

    p_shapes = _param_shapes(init_lm, cfg)
    p_specs = sh.lm_param_specs(p_shapes, policy, mesh)

    if shape.kind == "prefill":
        chunk = sh.LM_PREFILL_CHUNK.get(cfg.name)
        if chunk:
            def step(params, tokens):
                return prefill_chunked(params, cfg, tokens, chunk=chunk)
            tok_spec = P(dp, None)     # chunked: seq sliced dynamically
        else:
            def step(params, tokens):
                return prefill(params, cfg, tokens)
            tok_spec = P(dp, "model")  # dense: sequence parallelism
        cache_spec = sh.kv_cache_spec(cfg.n_kv_heads, mesh, batch=B)
        dt = getattr(torch, cfg.dtype)
        # chunked prefill writes a bf16 cache, the whole-sequence one
        # stacks the layers' keys in the model's dtype
        cache_dt = torch.bfloat16 if chunk else dt
        kv = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
        out_specs = (P(dp, None),
                     {"k": cache_spec, "v": cache_spec, "len": P()})

        def make_inputs(gen, device):
            return (init_lm(gen, cfg, device=device),
                    tokens(gen, device, (B, S)))

        return Cell(
            arch.arch_id, shape.name, "prefill", step,
            (p_shapes, _sds((B, S), torch.int32)),
            sh.named(mesh, (p_specs, tok_spec)),
            sh.named(mesh, out_specs),
            _lm_model_flops(cfg, "prefill", B * S),
            note=f"policy={policy}"
                 + (f" chunked_prefill={chunk}" if chunk else " seq-parallel"),
            attention_ideal_bytes=_lm_attention_ideal_bytes(
                cfg, "prefill", B, S, S),
            make_inputs=make_inputs,
            output_specs=(_sds((B, cfg.vocab), dt), {
                "k": _sds(kv, cache_dt), "v": _sds(kv, cache_dt),
                "len": _sds((), torch.int32)}))

    # decode: cache length = window for SWA archs (ring buffer), else context
    cache_len = cfg.window if cfg.window > 0 else S
    cache_spec = sh.kv_cache_spec(cfg.n_kv_heads, mesh, batch=B)
    kv_shape = (cfg.n_layers, B, cfg.n_kv_heads, cache_len, cfg.head_dim)
    cache_shapes = {
        "k": _sds(kv_shape, torch.bfloat16),
        "v": _sds(kv_shape, torch.bfloat16),
        "len": _sds((), torch.int32),
    }
    cache_specs = {"k": cache_spec, "v": cache_spec, "len": P()}
    tok_spec = P(dp if B % dp_size == 0 and B >= dp_size else None, None)

    def step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)

    def make_inputs(gen, device):
        def kv():
            return torch.randn(kv_shape, generator=gen, device=gen.device,
                               dtype=torch.bfloat16).to(device)
        # the context is full: this token sits at position S - 1
        cache = {"k": kv(), "v": kv(),
                 "len": torch.tensor(S - 1, dtype=torch.int32)}
        return (init_lm(gen, cfg, device=device), cache,
                tokens(gen, device, (B, 1)))

    return Cell(
        arch.arch_id, shape.name, "decode", step,
        (p_shapes, cache_shapes, _sds((B, 1), torch.int32)),
        sh.named(mesh, (p_specs, cache_specs, tok_spec)),
        sh.named(mesh, (tok_spec, cache_specs)),
        _lm_model_flops(cfg, "decode", B)
        + 2.0 * B * cfg.n_layers * 2 * cfg.n_kv_heads * cache_len
        * cfg.head_dim,                                 # cache attention
        note=f"policy={policy} cache_len={cache_len}",
        attention_ideal_bytes=_lm_attention_ideal_bytes(
            cfg, "decode", B, 1, cache_len),
        make_inputs=make_inputs,
        output_specs=(_sds((B, 1), torch.int32), cache_shapes))


# ========================================================== GNN family ====

# edge chunk length for the chunked-equiformer path (global)
_EQUI_EDGE_CHUNK = 524_288


def _gnn_edge_spec(mesh):
    """Edges sharded over every mesh axis (flat edge parallelism)."""
    return P(tuple(mesh.axis_names))


def _gnn_cell_config(arch, shape, mesh):
    """Specialize the arch config to the cell's feature width + mesh."""
    dims = shape.dims
    d_feat = dims.get("d_feat", 227)
    dp = tuple(dp_axes(mesh))
    all_axes = tuple(mesh.axis_names)
    big = dims.get("n_edges", 0) > 1_000_000
    if arch.arch_id == "graphcast":
        return dataclasses.replace(
            arch.config, n_vars=d_feat,
            dtype="bfloat16" if big else "float32",
            remat_group=4 if big else 1,
            node_axes=dp, edge_axes=all_axes)
    if arch.arch_id == "equiformer-v2":
        return dataclasses.replace(
            arch.config, d_feat=d_feat,
            dtype="bfloat16" if big else "float32",
            node_axes=dp, channel_axis="model" if big else "")
    if arch.arch_id == "egnn":
        return dataclasses.replace(arch.config, d_feat=d_feat)
    if arch.arch_id == "graphsage-reddit":
        return dataclasses.replace(
            arch.config, d_feat=d_feat,
            n_classes=dims.get("n_classes", arch.config.n_classes))
    raise KeyError(arch.arch_id)


def _gnn_graph_dims(shape, mesh):
    """(n_nodes, n_edges) of the per-step graph, padded to mesh multiples
    (the reference's in_shardings require divisible dims)."""
    dims = shape.dims
    if shape.name == "minibatch_lg":
        n, e = minibatch_subgraph_dims(dims["batch_nodes"], dims["fanout"])
    elif shape.name == "molecule":
        n, e = dims["n_nodes"] * dims["batch"], dims["n_edges"] * dims["batch"]
    else:
        n, e = dims["n_nodes"], dims["n_edges"]
    dp_size = _dp_size(mesh)
    total = dp_size * mesh.shape["model"]
    return _pad_up(n, dp_size), _pad_up(e, total)


def _gnn_loss_fn(arch_id, cfg):
    if arch_id == "graphcast":
        return m_graphcast.loss_edges
    if arch_id == "equiformer-v2":
        return m_equiformer.loss_edges
    if arch_id == "egnn":
        return m_egnn.loss_edges
    if arch_id == "graphsage-reddit":
        return m_sage.loss_edges
    raise KeyError(arch_id)


def _gnn_model_flops(arch_id, cfg, n_nodes, n_edges):
    """Analytic MAC*2 counts of the dominant ops (forward), x3 for train
    (fwd + bwd ~ 2x)."""
    if arch_id == "graphcast":
        d = cfg.d_hidden
        per_layer = n_edges * (3 * d * d + d * d) * 2 \
            + n_nodes * (2 * d * d + d * d) * 2
        f = cfg.n_layers * per_layer
    elif arch_id == "equiformer-v2":
        S = (cfg.l_max + 1) ** 2
        C = cfg.d_hidden
        n_l = cfg.l_max + 1
        so2 = sum(2 * ((cfg.l_max + 1 - m) * C) ** 2 *
                  (1 if m == 0 else 4) for m in range(cfg.m_max + 1))
        rot = 2 * sum((2 * l + 1) ** 2 * C for l in range(n_l)) * 2
        mix = 2 * S * C * C * 3
        f = cfg.n_layers * n_edges * (so2 + rot + mix)
    elif arch_id == "egnn":
        d = cfg.d_hidden
        f = cfg.n_layers * n_edges * (2 * (2 * d + 1) * d + 2 * d * d) * 2
    elif arch_id == "graphsage-reddit":
        d = cfg.d_hidden
        f = cfg.n_layers * n_nodes * (2 * cfg.d_feat * d) * 2 \
            + n_edges * cfg.d_feat * 2
    else:
        raise KeyError(arch_id)
    return 3.0 * f     # train: fwd + ~2x bwd


def make_gnn_train_step(arch_id, cfg, loss_fn, opt_cfg, extra):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``:
    the loss and its gradient, clip 1 and AdamW, the state updated in
    place."""
    def train_step(state, batch):
        loss, grads = value_and_grad(loss_fn, state["params"], cfg, *batch,
                                     **extra)
        gnorm = _update(state, grads, opt_cfg)
        return state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def graphcast_edges(gen, n_nodes: int, n_edges: int, n_dp: int):
    """``(src, dst)`` int64 of ``n_edges`` random edges on ``gen``'s
    device, ``n_edges / n_dp`` of them into each of the ``n_dp`` equal dst
    blocks, so that the dst-partitioned layout holds exactly
    ``n_edges``."""
    nb, eb = n_nodes // n_dp, n_edges // n_dp
    dev = gen.device
    src = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev)
    dst = torch.randint(0, nb, (n_edges,), generator=gen, device=dev)
    dst += torch.arange(n_dp, device=dev).repeat_interleave(eb) * nb
    return src, dst


def _randn(gen, device, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def _randint(gen, device, hi, *shape, dtype=torch.int32):
    return torch.randint(0, hi, shape, generator=gen, device=gen.device,
                         dtype=dtype).to(device)


def _build_gnn_cell(arch, shape, mesh, *, config_shape=None) -> Cell:
    """The GNN cell of ``shape``; its config (latent dtype, remat group,
    channel axis) is chosen by ``config_shape``'s dims, ``shape`` unless
    told otherwise: a cell whose graph is cut to fit one card passes its
    published shape, so that the cut does not change its config."""
    dims = shape.dims
    dp = dp_axes(mesh)
    opt_cfg = AdamWConfig()
    cfg = _gnn_cell_config(arch, config_shape or shape, mesh)
    n_nodes, n_edges = _gnn_graph_dims(shape, mesh)
    edge_spec = _gnn_edge_spec(mesh)
    metrics = {"loss": P(), "grad_norm": P()}

    # graphsage minibatch keeps its native sampled-block form
    if arch.arch_id == "graphsage-reddit" and shape.name == "minibatch_lg":
        B = dims["batch_nodes"]
        f1, f2 = dims["fanout"]
        F = dims["d_feat"]
        p_shapes = _param_shapes(m_sage.init_sage, cfg)
        o_shapes = _meta(adamw_init(p_shapes, opt_cfg))
        p_specs = sh.gnn_param_specs(p_shapes, mesh)
        state_shapes = {"params": p_shapes, "opt": o_shapes}

        def loss_fn(params, cfg, x_seed, x_n1, x_n2, labels):
            return m_sage.loss_blocks(params, cfg, x_seed, x_n1, x_n2, labels)

        step = make_gnn_train_step(
            arch.arch_id, cfg, loss_fn, opt_cfg, {})
        batch_shapes = (
            _sds((B, F), torch.float32),
            _sds((B, f1, F), torch.float32),
            _sds((B * f1, f2, F), torch.float32),
            _sds((B,), torch.int32),
        )
        batch_specs = (P(dp, None), P(dp, None, None),
                       P(dp, None, None), P(dp))
        flops = _gnn_model_flops(
            arch.arch_id, cfg, B * (1 + f1), B * f1 * (1 + f2))

        def make_inputs(gen, device):
            params = m_sage.init_sage(gen, cfg, device=device)
            return (_train_state(params, opt_cfg),
                    (_randn(gen, device, B, F),
                     _randn(gen, device, B, f1, F),
                     _randn(gen, device, B * f1, f2, F),
                     _randint(gen, device, cfg.n_classes, B)))

        return Cell(
            arch.arch_id, shape.name, "train", step,
            (state_shapes, batch_shapes),
            sh.named(mesh, (_state_specs(p_specs), batch_specs)),
            sh.named(mesh, (_state_specs(p_specs), metrics)),
            flops, note="sampled-block mode (native GraphSAGE)",
            make_inputs=make_inputs,
            output_specs=(state_shapes, _metric_shapes()))

    F = dims.get("d_feat", 227)
    p_shapes = _param_shapes(arch.init_fn, cfg)
    o_shapes = _meta(adamw_init(p_shapes, opt_cfg))
    p_specs = sh.gnn_param_specs(p_shapes, mesh)
    state_shapes = {"params": p_shapes, "opt": o_shapes}

    loss_fn = _gnn_loss_fn(arch.arch_id, cfg)
    extra = {"n_nodes": n_nodes}
    n, e = n_nodes, n_edges

    # per-arch batch trees (edge lists; equiformer chunks the edge axis —
    # its per-edge (chunk, 49, C) irrep tensors are the memory hot spot)
    if arch.arch_id == "equiformer-v2" and n_edges > 100_000:
        chunk = min(_EQUI_EDGE_CHUNK,
                    _pad_up(-(-n_edges // 4), mesh.size))
        n_chunks = -(-n_edges // chunk)
        e_shape = (n_chunks, chunk)
        e_spec = P(None, tuple(mesh.axis_names))
    else:
        e_shape = (n_edges,)
        e_spec = edge_spec

    if arch.arch_id == "graphcast":
        # production path: the dst-partitioned processor — edges arrive
        # pre-partitioned by dst block (`m_graphcast.partition_edges`)
        def loss_fn(params, cfg_, nf, ef, es, edl, targets, n_nodes):
            return m_graphcast.loss_edges_dst_partitioned(
                params, cfg_, nf, ef, es, edl, targets, n_nodes,
                mesh=mesh)

        batch_shapes = (
            _sds((n, F), torch.float32),
            _sds((e, cfg.d_edge_in), torch.float32),
            _sds((e,), torch.int32),
            _sds((e,), torch.int32),
            _sds((n, F), torch.float32),
        )
        batch_specs = (P(dp, None), P(edge_spec[0], None),
                       edge_spec, edge_spec, P(dp, None))
        n_dp, n_tp = _dp_size(mesh), mesh.shape["model"]

        def make_batch(gen, device):
            src, dst = graphcast_edges(gen, n, e, n_dp)
            ef, es, edl = m_graphcast.partition_edges(
                src, dst, _randn(gen, gen.device, e, cfg.d_edge_in), n,
                n_dp, n_tp)
            return (_randn(gen, device, n, F), ef.to(device),
                    es.to(device, torch.int32), edl.to(device, torch.int32),
                    _randn(gen, device, n, F))
    elif arch.arch_id == "equiformer-v2":
        batch_shapes = (
            _sds((n, F), torch.float32),
            _sds((n, 3), torch.float32),
            _sds(e_shape, torch.int32),
            _sds(e_shape, torch.int32),
            _sds((n, cfg.n_out), torch.float32),
        )
        batch_specs = (P(dp, None), P(dp, None), e_spec, e_spec,
                       P(dp, None))

        def make_batch(gen, device):
            return (_randn(gen, device, n, F), _randn(gen, device, n, 3),
                    _randint(gen, device, n, *e_shape),
                    _randint(gen, device, n, *e_shape),
                    _randn(gen, device, n, cfg.n_out))
    elif arch.arch_id == "egnn":
        batch_shapes = (
            _sds((n, F), torch.float32),
            _sds((n, 3), torch.float32),
            _sds((e,), torch.int32),
            _sds((e,), torch.int32),
            _sds((n, 3), torch.float32),
        )
        batch_specs = (P(dp, None), P(dp, None), edge_spec, edge_spec,
                       P(dp, None))

        def make_batch(gen, device):
            # positions at a tenth of unit scale and targets near them: an
            # untrained EGNN's coordinate updates grow with the squared
            # distances they read, and unit-scale clouds overflow f32 in
            # four layers
            es, ed = _edges(gen, device, shape, n, e)
            pos = _randn(gen, device, n, 3) * 0.1
            return (_randn(gen, device, n, F), pos, es, ed,
                    pos + 0.01 * _randn(gen, device, n, 3))
    elif arch.arch_id == "graphsage-reddit":
        batch_shapes = (
            _sds((n, F), torch.float32),
            _sds((e,), torch.int32),
            _sds((e,), torch.int32),
            _sds((n,), torch.int32),
        )
        batch_specs = (P(dp, None), edge_spec, edge_spec, P(dp))

        def make_batch(gen, device):
            es, ed = _edges(gen, device, shape, n, e)
            return (_randn(gen, device, n, F), es, ed,
                    _randint(gen, device, cfg.n_classes, n))
    else:
        raise KeyError(arch.arch_id)

    step = make_gnn_train_step(arch.arch_id, cfg, loss_fn, opt_cfg, extra)
    flops = _gnn_model_flops(arch.arch_id, cfg, n_nodes, n_edges)

    def make_inputs(gen, device):
        params = arch.init_fn(gen, cfg, device=device)
        return _train_state(params, opt_cfg), make_batch(gen, device)

    return Cell(
        arch.arch_id, shape.name, "train", step,
        (state_shapes, batch_shapes),
        sh.named(mesh, (_state_specs(p_specs), batch_specs)),
        sh.named(mesh, (_state_specs(p_specs), metrics)),
        flops,
        note=f"edge-parallel over {mesh.axis_names}"
             + (" + edge-chunked scan" if len(e_shape) == 2 else ""),
        make_inputs=make_inputs,
        output_specs=(state_shapes, _metric_shapes()))


def _edges(gen, device, shape, n: int, e: int):
    """Random ``(src, dst)`` int32 edges of an ``n``-node graph: within
    each molecule for ``molecule`` (a disjoint union of
    ``dims["batch"]`` graphs), else over the whole graph."""
    if shape.name != "molecule":
        return _randint(gen, device, n, e), _randint(gen, device, n, e)
    g, nm = shape.dims["batch"], shape.dims["n_nodes"]
    # edge i belongs to graph i * g // e (padding spreads over the graphs)
    base = torch.arange(e, device=gen.device) * g // e * nm
    src = base + torch.randint(0, nm, (e,), generator=gen, device=gen.device)
    dst = base + torch.randint(0, nm, (e,), generator=gen, device=gen.device)
    return (src.to(device, torch.int32), dst.to(device, torch.int32))


# ======================================================== recsys family ====

def _dp_blocks(mesh, x: torch.Tensor):
    """``x``'s dp blocks as the tiles take them (``P(dp, ...)``): an
    object ndarray of the mesh's shape."""
    dp = dp_axes(mesh)
    size = x.shape[0] // _dp_size(mesh)
    return M.tile_map(mesh, lambda c, _: x[
        M.axis_index(mesh, c, dp) * size:
        (M.axis_index(mesh, c, dp) + 1) * size])


def _gather_dp(mesh, tiles, device) -> torch.Tensor:
    """The logical ``P(dp)`` output of per-tile blocks: each dp block's
    first tile, in dp order, on ``device``."""
    dp = dp_axes(mesh)
    first = {}
    for c in np.ndindex(*mesh.devices.shape):
        first.setdefault(M.axis_index(mesh, c, dp), c)
    return torch.cat([tiles[first[i]].to(device) for i in range(len(first))])


def make_fm_sharded_logits(cfg, mesh):
    """FM logits with the paper-technique lookup: row-sharded table, local
    partial gathers, psum combine over "model" (EfficientIMM partial
    counters); the requests split over the data axes."""
    model_size = mesh.shape["model"]
    shard_rows = -(-cfg.total_rows // model_size)

    def logits(v, w, b, idx):
        rows = idx + cfg.field_offsets(idx.device)[None, :]
        ids = _dp_blocks(mesh, rows)
        emb = sharded_embedding_lookup(
            row_shards(mesh, v, "model"), ids, mesh=mesh,
            axis_name="model", shard_rows=shard_rows)
        wrow = sharded_embedding_lookup(
            row_shards(mesh, w[:, None], "model"), ids, mesh=mesh,
            axis_name="model", shard_rows=shard_rows)

        def tile(c, dev):
            s = emb[c].sum(dim=1)
            s2 = (emb[c] * emb[c]).sum(dim=1)
            pair = 0.5 * (s * s - s2).sum(dim=-1)
            return b.to(dev) + wrow[c][..., 0].sum(dim=-1) + pair

        return _gather_dp(mesh, M.tile_map(mesh, tile), idx.device)

    return logits


def _fm_params(cfg, gen, device) -> dict:
    """`init_fm`'s table with ``w ~ N(0, 0.01)`` and ``b ~ N(0, 0.1)``,
    so that every term of a logit is exercised."""
    params = m_fm.init_fm(cfg, generator=gen, device=device)
    params["w"] = (_randn(gen, device, cfg.total_rows) * 0.01)
    params["b"] = (_randn(gen, device) * 0.1)
    return params


def _build_fm_cell(arch, shape, mesh) -> Cell:
    cfg: m_fm.FMConfig = arch.config
    dims = shape.dims
    dp = dp_axes(mesh)
    opt_cfg = AdamWConfig()
    p_shapes = _abstract(m_fm.init_fm, cfg, generator=torch.Generator(),
                         device="cpu")
    p_specs = sh.fm_param_specs(p_shapes, mesh)
    logits_fn = make_fm_sharded_logits(cfg, mesh)

    def ids(gen, device, B):
        return _randint(gen, device, cfg.vocab_per_field, B, cfg.n_sparse)

    if shape.kind == "train":
        B = dims["batch"]
        o_shapes = _meta(adamw_init(p_shapes, opt_cfg))
        state_shapes = {"params": p_shapes, "opt": o_shapes}

        def loss_fn(params, idx, labels):
            logits = logits_fn(
                params["v"], params["w"], params["b"], idx).to(torch.float32)
            return torch.mean(
                torch.clamp(logits, min=0) - logits * labels
                + torch.log1p(torch.exp(-torch.abs(logits))))

        def step(state, batch):
            idx, labels = batch
            loss, grads = value_and_grad(loss_fn, state["params"], idx,
                                         labels)
            gnorm = _update(state, grads, opt_cfg)
            return state, {"loss": loss, "grad_norm": gnorm}

        batch_shapes = (_sds((B, cfg.n_sparse), torch.int32),
                        _sds((B,), torch.float32))
        batch_specs = (P(dp, None), P(dp))
        flops = 3.0 * B * cfg.n_sparse * cfg.embed_dim * 4

        def make_inputs(gen, device):
            labels = _randint(gen, device, 2, B).to(torch.float32)
            return (_train_state(_fm_params(cfg, gen, device), opt_cfg),
                    (ids(gen, device, B), labels))

        return Cell(
            arch.arch_id, shape.name, "train", step,
            (state_shapes, batch_shapes),
            sh.named(mesh, (_state_specs(p_specs), batch_specs)),
            sh.named(mesh, (_state_specs(p_specs),
                          {"loss": P(), "grad_norm": P()})),
            flops, note="sharded-lookup (paper-technique) path",
            make_inputs=make_inputs,
            output_specs=(state_shapes, _metric_shapes()))

    if shape.name == "retrieval_cand":
        C = dims["n_candidates"]
        n_user_fields = 4
        model_size = mesh.shape["model"]
        shard_rows = -(-cfg.total_rows // model_size)

        def step(v, w, b, user_idx, cand):
            user_rows = user_idx + cfg.field_offsets(
                user_idx.device)[:n_user_fields]
            v_t = row_shards(mesh, v, "model")
            w_t = row_shards(mesh, w[:, None], "model")

            def lookup(tables, rows):
                return sharded_embedding_lookup(
                    tables, rows, mesh=mesh, axis_name="model",
                    shard_rows=shard_rows)

            vu, wu = lookup(v_t, user_rows), lookup(w_t, user_rows)
            cands = _dp_blocks(mesh, cand)
            vc, wc = lookup(v_t, cands), lookup(w_t, cands)

            def tile(c, dev):
                su = vu[c].sum(dim=0)
                s2 = (vu[c] * vu[c]).sum(dim=0)
                const = b.to(dev) + wu[c][..., 0].sum() \
                    + 0.5 * ((su * su) - s2).sum()
                return const + wc[c][..., 0] + vc[c] @ su

            return _gather_dp(mesh, M.tile_map(mesh, tile), cand.device)

        specs = (p_shapes["v"], p_shapes["w"], p_shapes["b"],
                 _sds((n_user_fields,), torch.int32),
                 _sds((C,), torch.int32))
        in_specs = (p_specs["v"], p_specs["w"], p_specs["b"], P(), P(dp))
        flops = C * cfg.embed_dim * 2

        def make_inputs(gen, device):
            p = _fm_params(cfg, gen, device)
            return (p["v"], p["w"], p["b"],
                    _randint(gen, device, cfg.vocab_per_field,
                             n_user_fields),
                    _randint(gen, device, cfg.total_rows, C))

        return Cell(
            arch.arch_id, shape.name, "serve", step, specs,
            sh.named(mesh, in_specs), sh.named(mesh, P(dp)), flops,
            note="one query vs 1M candidates, single batched mat-vec",
            make_inputs=make_inputs,
            output_specs=_sds((C,), torch.float32))

    B = dims["batch"]

    def step(v, w, b, idx):
        return logits_fn(v, w, b, idx)

    specs = (p_shapes["v"], p_shapes["w"], p_shapes["b"],
             _sds((B, cfg.n_sparse), torch.int32))
    in_specs = (p_specs["v"], p_specs["w"], p_specs["b"], P(dp, None))
    flops = B * cfg.n_sparse * cfg.embed_dim * 4

    def make_inputs(gen, device):
        p = _fm_params(cfg, gen, device)
        return p["v"], p["w"], p["b"], ids(gen, device, B)

    return Cell(
        arch.arch_id, shape.name, "serve", step, specs,
        sh.named(mesh, in_specs), sh.named(mesh, P(dp)), flops,
        note="sharded-lookup serve path", make_inputs=make_inputs,
        output_specs=_sds((B,), torch.float32))


# ============================================================= IMM cells ====

def imm_rows(gen, theta: int, n: int, n_live: int, per_row: int = 8):
    """``(theta, n)`` uint8 RRR rows on ``gen``'s device: each row holds
    up to ``per_row`` vertices below ``n_live``, drawn skewed towards low
    ids (``n_live * u**3``) as the hubs of a social graph are shared by
    many sets; the columns from ``n_live`` on stay zero."""
    dev = gen.device
    R = torch.zeros((theta, n), dtype=torch.uint8, device=dev)
    u = torch.rand((theta, per_row), generator=gen, device=dev)
    R.scatter_(1, (u ** 3 * n_live).long().clamp_(max=n_live - 1), 1)
    return R


def build_imm_cell(cell_name: str, spec: dict, mesh) -> Cell:
    """Production-scale IMM cells: sharded selection + sampling."""
    from repro_torch.core.sampler import sample_ic_sparse
    from repro_torch.core.selection import select_dense_sharded

    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)
    if cell_name.startswith("imm_select"):
        theta, k = spec["theta"], spec["k"]
        # pad the vertex axis to the counter-shard multiple (pad vertices
        # never appear in any RRRset -> counter 0, never selected)
        n = _pad_up(spec["n"], mesh.shape["model"] * dp_size)

        def step(R, valid):
            return select_dense_sharded(
                mesh, R, valid, k, theta_axes=dp, vertex_axis="model",
                n=R.shape[1])

        def make_inputs(gen, device):
            return (imm_rows(gen, theta, n, spec["n"]).to(device),
                    torch.ones((theta,), dtype=torch.bool, device=device))

        specs = (_sds((theta, n), torch.uint8), _sds((theta,), torch.bool))
        in_specs = (P(dp, "model"), P(dp))
        out_specs = (P(), P(), P())
        flops = 2.0 * k * theta * n        # k rounds of masked mat-vec
        return Cell("imm", cell_name, "select", step, specs,
                    sh.named(mesh, in_specs), sh.named(mesh, out_specs), flops,
                    note=spec.get("note", ""), make_inputs=make_inputs,
                    output_specs=(_sds((k,), torch.int32),
                                  _sds((), torch.float32),
                                  _sds((k,), torch.int32)))

    # sampling cell: fixed-step sparse IC frontier expansion
    n = _pad_up(spec["n"], mesh.shape["model"] * dp_size)
    m = _pad_up(spec["m"], mesh.shape["model"] * dp_size)
    batch = spec["batch"]
    steps = spec["bfs_steps"]

    def step(key, edge_src, edge_dst, edge_prob):
        return sample_ic_sparse(
            key, edge_src, edge_dst, edge_prob, n_nodes=n, batch=batch,
            max_steps=steps)

    def make_inputs(gen, device):
        # a random graph of the spec's size: uniform ends, IC probabilities
        # uniform in [0, 0.1); the pad edges (0 -> 0) never fire
        live = spec["m"]
        src = _randint(gen, device, spec["n"], m)
        dst = _randint(gen, device, spec["n"], m)
        prob = torch.rand((m,), generator=gen, device=gen.device).to(
            device) * 0.1
        src[live:], dst[live:], prob[live:] = 0, 0, 0.0
        key = torch.randint(0, 2**31, (2,), generator=gen,
                            device=gen.device).to(torch.uint32).cpu()
        return key, src, dst, prob

    specs = (_sds((2,), torch.uint32), _sds((m,), torch.int32),
             _sds((m,), torch.int32), _sds((m,), torch.float32))
    in_specs = (P(), P("model"), P("model"), P("model"))
    out_specs = (P(dp, None), P(None), P(dp))
    flops = 2.0 * batch * m * steps / 8    # expected frontier work
    return Cell("imm", cell_name, "sample", step, specs,
                sh.named(mesh, in_specs), sh.named(mesh, out_specs), flops,
                note=spec.get("note", ""), make_inputs=make_inputs,
                output_specs=(_sds((batch, n), torch.uint8),
                              _sds((n,), torch.int32),
                              _sds((batch,), torch.int32)))


# ============================================================ dispatcher ====

def build_cell(arch_id: str, shape_name: str, mesh=None, *,
               device=None) -> Cell:
    """The cell of ``(arch_id, shape_name)`` on ``mesh`` (by default
    `make_local_mesh` over ``device``: ``cuda`` unless told otherwise);
    a skipped cell raises."""
    if mesh is None:
        mesh = make_local_mesh(device=device)
    arch = get_arch(arch_id)
    shape = arch.shape(shape_name)
    if shape.skip:
        raise ValueError(
            f"cell ({arch_id}, {shape_name}) is skipped: {shape.skip_reason}")
    return build_arch_cell(arch, shape, mesh)


def build_arch_cell(arch, shape, mesh, *, config_shape=None) -> Cell:
    """`build_cell` for an `ArchDef` and a `ShapeDef` given whole: a cell
    cut to size (a smaller batch, fewer layers, a smaller graph) is built
    from a replaced arch or shape, and a GNN's from its published shape
    as ``config_shape`` (`_build_gnn_cell`)."""
    if arch.family == "lm":
        return _build_lm_cell(arch, shape, mesh)
    if arch.family == "gnn":
        return _build_gnn_cell(arch, shape, mesh, config_shape=config_shape)
    if arch.family == "recsys":
        return _build_fm_cell(arch, shape, mesh)
    raise KeyError(arch.family)
