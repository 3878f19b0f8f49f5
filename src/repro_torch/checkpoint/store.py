"""Checkpoints with atomic commit, rolling retention and auto-resume
(``repro.checkpoint.store``), in the reference's file format.

  * every leaf of a tree is saved as one npz entry keyed by its path, and
    the tree's structure as a JSON spec under ``__spec__``, so a file
    written by either package loads in the other;
  * the npz files are written and read at the disk's speed
    (`repro_torch.checkpoint.npz`: the CRCs on a thread pool, each
    member straight from and into its array);
  * writes go to a ``.tmp.npz`` name in the target directory, then
    ``os.replace`` moves them to their final name: a half-written
    checkpoint is never visible under it;
  * a ``latest`` pointer file is written after the rename; a restart
    reads it and falls back to scanning when it is stale or corrupt;
  * rolling retention keeps the newest ``keep`` checkpoints;
  * under an initialised ``torch.distributed`` only rank 0 writes.

A tree holds tensors, numpy arrays, Python and numpy scalars and strings
in nested dicts, lists and tuples.  Leaves are saved as host numpy: a
tensor goes through ``.cpu().numpy()``, and bfloat16 (which numpy lacks)
is saved as the reference's numpy saves it, as the raw 2-byte words
(dtype ``|V2``).  Loading returns host numpy leaves, as in the
reference; callers move them to their device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import warnings

import numpy as np
import torch

from repro_torch.checkpoint.npz import read_npz, write_npz

_SEP = "/"


def _host(leaf) -> np.ndarray:
    """A leaf as host numpy; bfloat16 as its raw 2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def to_tensor(leaf, *, dtype=None, device=None) -> torch.Tensor:
    """A leaf of a loaded tree as a tensor in ``dtype`` on ``device``
    (the leaf's own where not given): raw 2-byte words (``|V2``, how
    bfloat16 is saved) come back as bfloat16, a 0-dim array as a 0-dim
    tensor.  A tensor on the host never shares the loaded array's
    (read-only) buffer."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device=device, dtype=dtype)
    a = np.asarray(leaf)
    bf16 = a.dtype == np.dtype("V2")
    if bf16:
        a = a.view(np.int16)
    dev = torch.device("cpu" if device is None else device)
    if not a.flags.c_contiguous or (dev.type == "cpu"
                                    and not a.flags.writeable):
        a = a.copy()
    with warnings.catch_warnings():
        # a read-only array bound for the card is only read, by the copy
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(a)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device=dev, dtype=dtype)


def _flatten(tree, prefix=""):
    """-> (structure spec, dict[path, host leaf]), in sorted key order."""
    out = {}
    if isinstance(tree, dict):
        spec = {"__kind__": "dict", "keys": sorted(tree.keys())}
        children = {}
        for k in sorted(tree.keys()):
            sub_spec, sub_leaves = _flatten(tree[k], f"{prefix}{k}{_SEP}")
            children[k] = sub_spec
            out.update(sub_leaves)
        spec["children"] = children
        return spec, out
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        spec = {"__kind__": kind, "n": len(tree)}
        children = []
        for i, v in enumerate(tree):
            sub_spec, sub_leaves = _flatten(v, f"{prefix}{i}{_SEP}")
            children.append(sub_spec)
            out.update(sub_leaves)
        spec["children"] = children
        return spec, out
    key = prefix[:-1] if prefix.endswith(_SEP) else prefix
    out[key] = _host(tree)
    return {"__kind__": "leaf", "key": key}, out


def _unflatten(spec, leaves):
    kind = spec["__kind__"]
    if kind == "leaf":
        return leaves[spec["key"]]
    if kind == "dict":
        return {k: _unflatten(spec["children"][k], leaves)
                for k in spec["keys"]}
    children = [_unflatten(c, leaves) for c in spec["children"]]
    return children if kind == "list" else tuple(children)


def clone_tree(tree):
    """An independent host copy of a snapshot tree: every leaf a fresh
    numpy array, so engines restored from it share no buffer with the
    tree's owner (replica fan-out)."""
    spec, leaves = _flatten(tree)
    return _unflatten(spec, {k: np.array(v) for k, v in leaves.items()})


def tree_bytes(tree) -> int:
    """Total host bytes of a tree's leaves."""
    _, leaves = _flatten(tree)
    return sum(int(v.nbytes) for v in leaves.values())


def _is_writer() -> bool:
    """Rank 0 of an initialised process group writes; so does a lone
    process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _write_npz(directory: str, fname: str, tree) -> str:
    """Atomic npz write of a flattened tree to ``<directory>/<fname>``."""
    os.makedirs(directory, exist_ok=True)
    spec, leaves = _flatten(tree)
    dest = os.path.join(directory, fname)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    try:
        write_npz(tmp, {"__spec__": np.asarray(json.dumps(spec)), **leaves})
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return dest


def _read_npz(path: str):
    leaves = read_npz(path)
    spec = json.loads(str(leaves.pop("__spec__")))
    return _unflatten(spec, leaves)


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3):
    """Atomic write of ``tree`` at ``step``; prunes to the ``keep``
    newest.  Returns the file's path (None on a non-writing rank)."""
    if not _is_writer():
        return None
    fname = _write_npz(directory, f"step_{step:010d}.npz", tree)
    with open(os.path.join(directory, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "latest.tmp"),
               os.path.join(directory, "latest"))
    _prune(directory, keep)
    return fname


def save_named(directory: str, name: str, tree):
    """Atomic write of ``tree`` under a stable name (no step counter, no
    retention): single-slot snapshots such as
    `InfluenceEngine.snapshot`, overwritten in place."""
    if not _is_writer():
        return None
    if _SEP in name or name.startswith("step_"):
        raise ValueError(f"invalid snapshot name {name!r}")
    return _write_npz(directory, f"{name}.npz", tree)


def load_named(directory: str, name: str):
    """Read a `save_named` snapshot; None when absent."""
    path = os.path.join(directory, f"{name}.npz")
    if not os.path.exists(path):
        return None
    return _read_npz(path)


def _list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for f in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)\.npz", f)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def _prune(directory: str, keep: int):
    steps = _list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(directory, f"step_{s:010d}.npz"))
        except OSError:
            pass


def latest_step(directory: str):
    """Newest complete checkpoint step, or None."""
    ptr = os.path.join(directory, "latest")
    steps = _list_steps(directory)
    if not steps:
        return None
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                s = int(f.read().strip())
            if s in steps:
                return s
        except (ValueError, OSError):
            pass
    return steps[-1]


def load_checkpoint(directory: str, step: int | None = None):
    """-> ``(step, tree of numpy leaves)``, or ``(None, None)`` when there
    is nothing to restore."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None, None
    return step, _read_npz(os.path.join(directory, f"step_{step:010d}.npz"))


class CheckpointManager:
    """Rolling save/restore manager: saves every ``save_every`` steps,
    keeps the newest ``keep``; ``restore_or_init`` returns ``(step,
    tree)`` from the newest checkpoint, else ``(0, init_fn())``."""

    def __init__(self, directory: str, *, save_every: int = 100,
                 keep: int = 3):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep

    def maybe_save(self, step: int, tree):
        if step % self.save_every == 0 and step > 0:
            return save_checkpoint(self.directory, step, tree, keep=self.keep)
        return None

    def save(self, step: int, tree):
        return save_checkpoint(self.directory, step, tree, keep=self.keep)

    def restore_or_init(self, init_fn):
        step, tree = load_checkpoint(self.directory)
        if step is None:
            return 0, init_fn()
        return step, tree

    def wipe(self):
        if os.path.isdir(self.directory):
            shutil.rmtree(self.directory)
