"""The port's dry run and cell execution (``repro_torch.launch.dryrun``).

``bytes_per_device`` of a cell on a production mesh is held to the
reference's layout: the sum over its inputs and outputs of
``NamedSharding(AbstractMesh, spec).shard_shape(shape)`` bytes, less the
donated state (train) or cache (decode), the outputs' shapes from
``jax.eval_shape`` of the reference's step.  grok-1-314b's train cell
dry-runs in a process whose peak resident memory stays below 4 GiB (its
parameters alone are 633 GB in bf16).  The collective census counts a
2x2 host mesh's collectives: calls and bytes by kind, none crossing
devices.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding as JNamed  # noqa: E402

from repro.configs import IMM_DRYRUN_CELLS as J_IMM  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe_sharded as j_moe_sharded  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe_sharded  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_and_moe_mesh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = (moe_sharded.MESH, j_moe_sharded.MESH)
    yield
    moe_sharded.MESH, j_moe_sharded.MESH = saved
    torch.set_num_threads(threads)


def _jmesh(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _ref_bytes(tree, shardings):
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, JNamed))
    assert len(leaves) == len(shs)
    return sum(math.prod(s.shard_shape(tuple(x.shape)))
               * np.dtype(x.dtype).itemsize for x, s in zip(leaves, shs))


def _ref_cell(arch_id, shape_name, multi_pod):
    if arch_id == "imm":
        return jsteps.build_imm_cell(shape_name, J_IMM[shape_name],
                                     _jmesh(multi_pod))
    return jsteps.build_cell(arch_id, shape_name, _jmesh(multi_pod))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch_id,shape_name", [
    ("fm", "serve_p99"), ("fm", "retrieval_cand"), ("fm", "train_batch"),
    ("qwen1.5-0.5b", "decode_32k"), ("h2o-danube-3-4b", "long_500k"),
    ("moonshot-v1-16b-a3b", "train_4k"), ("egnn", "molecule"),
    ("graphsage-reddit", "minibatch_lg"), ("graphcast", "ogb_products"),
    ("imm", "imm_select_lj_ic"), ("imm", "imm_sample_google_ic")])
def test_bytes_per_device_equal_the_reference_layout(arch_id, shape_name,
                                                     multi_pod):
    ref = _ref_cell(arch_id, shape_name, multi_pod)
    if ref.kind == "train":
        metrics = {"loss": jax.ShapeDtypeStruct((), np.float32),
                   "grad_norm": jax.ShapeDtypeStruct((), np.float32)}
        outs = (ref.input_specs[0], metrics)
    else:
        outs = jax.eval_shape(ref.step_fn, *ref.input_specs)
    arg = _ref_bytes(ref.input_specs, ref.in_shardings)
    out = _ref_bytes(outs, ref.out_shardings)
    donated = {"train": 0, "decode": 1}.get(ref.kind)
    alias = 0 if donated is None else _ref_bytes(
        ref.input_specs[donated], ref.in_shardings[donated])
    rec = dryrun.run_cell(arch_id, shape_name, multi_pod)
    assert rec["ok"] and rec["kind"] == ref.kind and rec["note"] == ref.note
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["memory"]["argument_size_in_bytes"] == arg
    assert rec["memory"]["output_size_in_bytes"] == out
    assert rec["memory"]["alias_size_in_bytes"] == alias
    assert rec["bytes_per_device"] == arg + out - alias
    assert rec["fits_hbm"] == (arg + out - alias <= 80 * 2**30)
    assert rec["memory"]["temp_size_in_bytes"] is None
    assert rec["model_flops"] == ref.model_flops
    assert rec["roofline"]["model_flops_global"] == ref.model_flops
    # the port's output shapes are the reference's
    cell = dryrun.build(arch_id, shape_name, steps_mesh(multi_pod))
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in _leaves(cell.output_specs)]
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(outs)]
    assert got == want


def steps_mesh(multi_pod):
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=multi_pod, device="meta")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


_GROK = r"""
import json, resource, torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
rec = dryrun.run_cell("grok-1-314b", "train_4k", False)
print(json.dumps({"ok": rec["ok"], "bytes": rec["bytes_per_device"],
                  "maxrss_kb": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss}))
"""


def test_grok_train_dry_runs_without_allocating():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _GROK], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["bytes"] > 0
    assert res["maxrss_kb"] < 4 * 2**20, res


def test_collective_census_on_a_2x2_host_mesh():
    """FM serving on a 2x2 mesh of the host: each of the two lookups
    (``v`` and ``w``) psums its two model tiles in each of the two data
    rows; nothing crosses a device."""
    arch = get_arch("fm")
    shape = dataclasses.replace(arch.shape("serve_p99"), dims={"batch": 8})
    cfg = arch.smoke_config
    arch = dataclasses.replace(arch, config=cfg)
    mesh = Mesh([["cpu"] * 2] * 2, ("data", "model"))
    cell = steps.build_arch_cell(arch, shape, mesh)
    inputs = cell.make_inputs(torch.Generator().manual_seed(0), "cpu")
    with dryrun.collective_census() as census:
        out = cell.step_fn(*inputs)
    assert torch.equal(cell.step_fn(*inputs), out)
    bl, F, K = 4, cfg.n_sparse, cfg.embed_dim
    assert list(census) == ["psum"]
    assert census["psum"]["calls"] == 2 * 2
    assert census["psum"]["bytes"] == 2 * 2 * (bl * F * K + bl * F) * 4
    assert census["psum"]["cross_bytes"] == 0
    # obs is left as it was
    from repro_torch import obs
    assert not obs.enabled()


def test_census_counts_bytes_that_cross_devices():
    """Tiles on two devices (``meta`` and the host) brought to ``meta``:
    the host's bytes cross, ``meta``'s stay."""
    from repro_torch import mesh as M
    with dryrun.collective_census() as census:
        M.psum([torch.ones(4, device="meta"), torch.ones(4)], "meta")
        M.all_gather([torch.ones(4), torch.ones(4)], "meta")
        M.psum_or([torch.ones(2, dtype=torch.bool)] * 2, "cpu")
    assert census["psum"] == {"calls": 1, "bytes": 32, "cross_bytes": 16}
    assert census["all_gather"] == {"calls": 1, "bytes": 32,
                                    "cross_bytes": 32}
    assert census["psum_or"] == {"calls": 1, "bytes": 4, "cross_bytes": 0}


def test_main_writes_two_ok_records(tmp_path):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "fm", "--shape", "serve_p99", "--mesh",
                        "both", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["ok"] and r["fits_hbm"] for r in recs)


def test_main_records_a_failed_cell(tmp_path, capsys):
    out = tmp_path / "bad.json"
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k",
                        "--out", str(out)]) == 1
    rec = json.loads(out.read_text())[0]
    assert not rec["ok"] and "is skipped" in rec["error"]
