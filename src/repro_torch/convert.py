"""State carried across from the JAX package, given as numpy arrays.

``graph_from_arrays`` builds the port's `Graph` from the arrays of a
``repro`` graph; ``engine_state_from_tree`` adopts the numpy tree of
``repro``'s ``InfluenceEngine.snapshot_tree()`` (a bitmap, packed,
compressed or index-list store, the PRNG key and meta).  A JAX engine
stopped at some theta then continues in the port, batch for batch, on
the same key stream, in the store the port engine is configured with
(the port's `InfluenceEngine.restore` reads the reference's snapshot
files directly)::

    tree = jax_engine.snapshot_tree()
    engine = InfluenceEngine(graph_from_arrays(arrays), cfg)
    engine.restore_tree(engine_state_from_tree(tree))
    engine.extend(theta2)

``lm_params_from_jax`` takes the reference's ``init_lm`` parameter tree
(numpy leaves) to the port's LM parameters, leaf for leaf;
``fm_params_from_jax`` does the same for ``init_fm``'s ``{"v", "w", "b"}``
and ``gnn_params_from_jax`` for the four GNNs' trees (lists of layers
kept as lists, stacked layers as stacked tensors).
All three put the parameters on ``cuda`` unless given ``device="cpu"``
(`repro_torch.device.resolve_device`), where the port's servers run.

Nothing here imports JAX: the caller turns device arrays into numpy
(``np.asarray``) first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph

_INT_FIELDS = ("src_offsets", "out_dst", "dst_offsets", "in_src",
               "edge_src", "edge_dst")
_FLOAT_FIELDS = ("in_prob", "in_lt_cum", "in_lt_total")


def graph_from_arrays(arrays, *, device="cpu") -> Graph:
    """A `Graph` from a mapping (or an object with attributes) holding a
    reference graph's fields: ``n``, ``m`` and the CSR/CSC arrays.  It
    stays on the host unless asked otherwise, by design: an engine moves
    its graph to its own device (``InfluenceEngine`` calls
    ``graph.to``)."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda k: getattr(arrays, k))
    fields = {}
    for name in _INT_FIELDS + _FLOAT_FIELDS:
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        a = np.array(get(name), dtype=dtype)   # a writable copy
        fields[name] = torch.from_numpy(a).to(device)
    g = Graph(n=int(get("n")), m=int(get("m")), **fields)
    if g.edge_src.shape[0] != g.m or g.dst_offsets.shape[0] != g.n + 1:
        raise ValueError(f"inconsistent graph arrays for n={g.n}, m={g.m}")
    return g


#: element type of each snapshot kind's at-rest arena
_DTYPES = {"bitmap": np.uint8, "packed": np.uint8, "compressed": np.int32,
           "indices": np.int32, "sharded": np.uint8}


def engine_state_from_tree(tree: dict) -> dict:
    """Validate and normalize a reference ``snapshot_tree()`` (numpy
    leaves) into the tree `InfluenceEngine.restore_tree` adopts: a
    ``"bitmap"`` store with ``(capacity, n) uint8`` rows, a ``"packed"``
    one with ``(capacity, ceil(n/8)) uint8`` rows, a ``"compressed"``
    one with ``(capacity, s_pad) int32`` token rows, an ``"indices"``
    one with ``(capacity, l_pad) int32`` index lists or a ``"sharded"``
    one (a meshed store's) with ``(count, n) uint8`` compact rows and
    its tile codec ``rep``; int32 sizes and counter, bool live bits
    (not on a sharded snapshot), and a ``uint32[2]`` key."""
    st = tree["store"]
    kind = str(np.asarray(st["kind"]))
    if kind not in _DTYPES:
        raise ValueError(f"unknown snapshot store kind {kind!r}; have "
                         f"{sorted(_DTYPES)}")
    n = int(st["n"])
    R = np.ascontiguousarray(np.asarray(st["R"]), dtype=_DTYPES[kind])
    # bitmap and sharded rows hold n bytes, packed ceil(n/8); token rows
    # any s_pad, index rows any l_pad
    width = {"bitmap": n, "sharded": n,
             "packed": -(-n // 8)}.get(kind, R.shape[-1])
    if R.ndim != 2 or R.shape[1] != width:
        raise ValueError(f"{kind} snapshot arena {R.shape} does not have "
                         f"{width} columns for n={n}")
    store = {
        "kind": np.asarray(kind),
        "n": np.int64(n),
        "count": np.int64(int(st["count"])),
        "R": R,
        "sizes": np.asarray(st["sizes"], np.int32),
        "counter": np.asarray(st["counter"], np.int32),
    }
    if kind == "sharded":
        # compact valid rows (no live bits) and the tiles' codec
        store["rep"] = np.asarray(str(np.asarray(st.get("rep", "bitmap"))))
    else:
        store["live"] = np.asarray(
            st.get("live", np.ones(R.shape[0], bool)), bool)
    key = np.asarray(tree["key"])
    if key.shape != (2,):
        raise ValueError(f"snapshot key has shape {key.shape}, expected a "
                         f"raw threefry key of shape (2,)")
    meta = tree["meta"]
    return {
        "store": store,
        "key": key.astype(np.uint32),
        "meta": {"n": np.int64(int(meta["n"])),
                 "model": np.asarray(str(np.asarray(meta["model"]))),
                 "sampler": np.asarray(str(np.asarray(meta["sampler"])))},
    }


def _leaf_tensor(a, device, dtype) -> torch.Tensor:
    """A numpy leaf as a tensor.  bfloat16 (ml_dtypes) arrays go through
    float32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, dtype=np.float32 if bf16 else a.dtype))
    if bf16:
        t = t.to(torch.bfloat16)
    return t.to(device=device, dtype=dtype or t.dtype)


#: LM leaves held in float32 whatever the model's dtype (the MoE router,
#: as the reference's ``init_lm`` holds it)
_F32_LEAVES = ("router",)


def lm_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """The port's LM parameters from the reference's ``init_lm`` tree
    (``{"embed", "layers": {...}, "ln_f", "lm_head"}`` with numpy leaves,
    layer weights stacked on a leading L axis; a MoE's layers add
    ``router``, ``w_gate_up (L, E, d, 2 ff)`` and ``w_down``), in each
    leaf's own dtype or cast to ``dtype`` (the router stays float32), on
    ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        out[name] = (lm_params_from_jax(leaf, device, dtype)
                     if isinstance(leaf, dict)
                     else _leaf_tensor(leaf, device,
                                       None if name in _F32_LEAVES
                                       else dtype))
    return out


def fm_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """The port's FM parameters from the reference's ``init_fm`` tree
    (``{"v": (rows, K), "w": (rows,), "b": ()}``, numpy leaves), on
    ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    return {name: _leaf_tensor(tree[name], device, dtype)
            for name in ("v", "w", "b")}


def gnn_params_from_jax(tree, device=None, dtype=None):
    """The port's GNN parameters from a reference ``init_sage``,
    ``init_egnn``, ``init_graphcast`` or ``init_equiformer`` tree (numpy
    leaves), leaf for leaf: dicts stay dicts, lists of layers stay
    lists, and layers stacked on a leading L axis stay stacked; each leaf
    in its own dtype or cast to ``dtype``, on ``cuda`` unless ``device``
    says otherwise."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: gnn_params_from_jax(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gnn_params_from_jax(v, device, dtype) for v in tree]
    return _leaf_tensor(tree, device, dtype)
