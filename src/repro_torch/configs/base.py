"""Architecture registry (``repro.configs.base``).

Each architecture contributes an `ArchDef`: ``config``, its exact
published configuration; ``smoke_config``, a reduced configuration of the
same family for CPU tests; and ``shapes``, its input-shape cells.  The
reference's dry-run and smoke hooks (``init_fn``, ``smoke_step``) may
stay ``None`` until the slice that runs them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str                  # "train" | "prefill" | "decode" | "serve"
    dims: dict                 # free-form dims (seq_len, batch, n_nodes, ...)
    note: str = ""
    skip: bool = False         # e.g. long_500k on pure full-attention archs
    skip_reason: str = ""


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                # "lm" | "gnn" | "recsys"
    source: str                # citation tag
    config: Any
    smoke_config: Any
    shapes: dict
    init_fn: Optional[Callable] = None
    smoke_step: Optional[Callable] = None
    technique_applicable: bool = False
    technique_note: str = ""

    def shape(self, name: str) -> ShapeDef:
        return self.shapes[name]


_REGISTRY: dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.arch_id] = arch
    return arch


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchDef]:
    return dict(_REGISTRY)


def all_cells(include_skipped: bool = False):
    """[(arch_id, shape_name)] for every assigned cell, in the reference's
    order: archs sorted by id, each arch's shapes in its table's order."""
    cells = []
    for aid, arch in sorted(_REGISTRY.items()):
        for sname, sdef in arch.shapes.items():
            if sdef.skip and not include_skipped:
                continue
            cells.append((aid, sname))
    return cells
