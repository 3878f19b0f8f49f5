"""Dry run of every (arch x shape x mesh) cell, and one step of a cell on
the card (``repro.launch.dryrun``).

Usage::

  python -m repro_torch.launch.dryrun --arch fm --shape serve_p99 \\
      --mesh both --out /tmp/cell.json
  python -m repro_torch.launch.dryrun --all --mesh both   # every cell
  python -m repro_torch.launch.dryrun --imm --mesh single # the IMM cells

`run_cell` builds a cell on a production mesh of the ``meta`` device
(`repro_torch.launch.mesh.make_production_mesh`): its parameter shapes
come from ``FakeTensorMode`` and its inputs are ``meta`` tensors, so a
cell of any size is built in seconds and nothing is allocated on the host
or on a card.  Per cell it records the reference's keys where the port
has a counterpart:

  * ``build_s`` in place of ``lower_s``/``compile_s``;
  * ``bytes_per_device``: the bytes of one tile's block of every argument
    and every output, read from the cell's shardings, less the donated
    state (train) or cache (decode) — the reference's ``argument + output
    - alias``; ``fits_hbm`` against the ``h100`` row's 80 GiB;
  * ``roofline``: `repro_torch.launch.roofline.roofline_terms` of the
    cell's model flops, those bytes and the ``h100`` row.

``temp_bytes`` and the HLO's flops and bytes are ``null``: PyTorch runs
eagerly and lowers nothing, so a step's temporaries and executed
operations exist only when it runs.  `execute_cell` runs a built cell on
the card and records what the reference read from ``memory_analysis``
and its HLO census: the step's time (CUDA events), its peak memory
(``torch.cuda.max_memory_allocated``, temporaries included), the
executed flops (``torch.utils.flop_counter.FlopCounterMode``, every loop
counted by its trips, so no ``known_trip_count`` is needed) and the
collective census (`collective_census`, the counters every collective
of `repro_torch.mesh` keeps).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import H100, roofline_terms
from repro_torch.launch.shardings import P

#: the collectives of `repro_torch.mesh`, as the census names them
COLLECTIVES = ("psum", "psum_or", "all_gather", "all_gather_cols",
               "all_to_all")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _pairs(tree, specs):
    """``[(tensor, NamedSharding)]`` of a tree of tensors and the tree of
    shardings of the same structure laid over it."""
    if isinstance(specs, dict):
        return [x for k in specs for x in _pairs(tree[k], specs[k])]
    if isinstance(specs, (list, tuple)) and not isinstance(specs, P):
        return [x for t, s in zip(tree, specs) for x in _pairs(t, s)]
    return [(tree, specs)]


def shard_bytes(tree, shardings) -> int:
    """The bytes one tile holds of a tree of tensors laid out by a tree of
    `NamedSharding`s."""
    total = 0
    for t, s in _pairs(tree, shardings):
        total += math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
    return total


def cell_bytes(cell) -> dict:
    """``{"argument", "output", "alias", "live"}`` bytes of one tile."""
    arg = shard_bytes(cell.input_specs, cell.in_shardings)
    out = shard_bytes(cell.output_specs, cell.out_shardings)
    # the state (train) or the cache (decode) is donated: updated in place
    donated = {"train": 0, "decode": 1}.get(cell.kind)
    alias = 0 if donated is None else shard_bytes(
        cell.input_specs[donated], cell.in_shardings[donated])
    return {"argument": arg, "output": out, "alias": alias,
            "live": arg + out - alias}


def build(arch_id: str, shape_name: str, mesh):
    """The cell of ``(arch_id, shape_name)``; ``arch_id == "imm"`` builds
    one of `IMM_DRYRUN_CELLS`."""
    from repro_torch.configs import IMM_DRYRUN_CELLS
    from repro_torch.launch.steps import build_cell, build_imm_cell

    if arch_id == "imm":
        return build_imm_cell(shape_name, IMM_DRYRUN_CELLS[shape_name], mesh)
    return build_cell(arch_id, shape_name, mesh)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             device="meta") -> dict:
    """Build one cell on the (16, 16) or (2, 16, 16) production mesh of
    ``device`` and record its size and roofline (see the docstring)."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_dev = mesh.size
    t0 = time.perf_counter()
    cell = build(arch_id, shape_name, mesh)
    build_s = time.perf_counter() - t0
    nbytes = cell_bytes(cell)
    live = nbytes["live"]
    terms = roofline_terms(
        cell.model_flops / n_dev, live, 0.0, cell.model_flops, n_dev,
        hw=H100, extra={"wire_bytes": None,
                        "note": "model flops and argument+output bytes; "
                                "no HLO census without running"})
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "n_devices": n_dev,
        "kind": cell.kind,
        "note": cell.note,
        "ok": True,
        "build_s": build_s,
        "memory": {"argument_size_in_bytes": nbytes["argument"],
                   "output_size_in_bytes": nbytes["output"],
                   "alias_size_in_bytes": nbytes["alias"],
                   "temp_size_in_bytes": None},
        "bytes_per_device": live,
        "fits_hbm": bool(live <= H100["hbm_bytes"]),
        "model_flops": cell.model_flops,
        "attention_ideal_bytes": cell.attention_ideal_bytes,
        "roofline": terms,
    }


# ------------------------------------------------------------ execution --

def census_of(snapshot: dict) -> dict:
    """``{kind: {"calls", "bytes", "cross_bytes"}}`` of the collectives in
    an obs snapshot (kinds with no call left out)."""
    out = {}
    for key, value in snapshot["counters"].items():
        name, _, label = key.partition("{")
        if not name.startswith("mesh.collective."):
            continue
        kind = label.rstrip("}").partition("=")[2]
        out.setdefault(kind, {"calls": 0, "bytes": 0, "cross_bytes": 0})
        out[kind][name[len("mesh.collective."):]] = value
    return {k: out[k] for k in COLLECTIVES if k in out}


@contextlib.contextmanager
def collective_census():
    """Count the collectives run inside the block into a fresh obs
    registry; yields a dict that holds `census_of` it afterwards.  Obs is
    left on or off and on its registry as it was."""
    was_on, prev = obs.enabled(), obs.get_metrics()
    reg = obs.MetricsRegistry()
    obs.enable(registry=reg)
    out = {}
    try:
        yield out
    finally:
        obs.enable(registry=prev)
        if not was_on:
            obs.disable()
        out.update(census_of(reg.snapshot()))


def execute_cell(cell, inputs, mesh=None, *, steps: int = 1,
                 device=None) -> tuple:
    """Run ``cell``'s step on ``inputs`` on the card ``1 + steps`` times:
    once under ``FlopCounterMode`` and the census, then ``steps`` calls
    timed with CUDA events.  Returns ``(outputs, record)``: every call's
    outputs in order, and ``{"step_ms": [...], "max_memory_allocated"
    (the peak since the first call), "executed_flops", "collectives"}``.
    A train step updates its state in place, so each call is a step."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"execute_cell times a step on the card, not {dev}")
    if mesh is not None and any(d.type != dev.type
                                for d in mesh.distinct_devices()):
        raise ValueError(f"the mesh {mesh} is not on {dev}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    outputs = []
    with collective_census() as census:
        with FlopCounterMode(display=False) as flops:
            outputs.append(cell.step_fn(*inputs))
    ms = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outputs.append(cell.step_fn(*inputs))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return outputs, {"executed_flops": int(flops.get_total_flops()),
                     "model_flops": cell.model_flops,
                     "collectives": dict(census), "step_ms": ms,
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated(dev),
                     "device": torch.cuda.get_device_name(dev)}


# ------------------------------------------------------------------ CLI --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="all assigned cells (in-process)")
    ap.add_argument("--imm", action="store_true", help="IMM cells")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import IMM_DRYRUN_CELLS, all_cells

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        todo = list(all_cells())
    elif args.imm:
        todo = [("imm", name) for name in IMM_DRYRUN_CELLS]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("need --arch+--shape, --all, or --imm")

    results = []
    n_fail = 0
    for arch_id, shape_name in todo:
        for mp in meshes:
            tag = f"{arch_id}/{shape_name}/{'multi' if mp else 'single'}"
            print(f"=== dryrun {tag} ===", flush=True)
            try:
                res = run_cell(arch_id, shape_name, mp)
            except Exception as e:  # noqa: BLE001 — record + continue
                traceback.print_exc()
                res = {"arch": arch_id, "shape": shape_name,
                       "mesh": _mesh_name(mp), "ok": False,
                       "error": f"{type(e).__name__}: {e}"}
                n_fail += 1
            results.append(res)
            print(json.dumps(
                {k: res.get(k) for k in
                 ("arch", "shape", "mesh", "ok", "bytes_per_device",
                  "fits_hbm", "build_s")}), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
