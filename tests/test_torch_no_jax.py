"""repro_torch stands alone: importing every module loads neither JAX nor
the JAX package, and entry points run on CUDA unless told otherwise."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import examples_torch
examples = [m.name for m in pkgutil.iter_modules(examples_torch.__path__,
                                                 "examples_torch.")]
for name in examples:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "examples"))
print(json.dumps({"modules": names, "examples": examples,
                  "leaked": leaked}))
"""

#: the port's examples (``examples_torch/``), one for each of the
#: reference's ``examples/*.py``
EXAMPLES = ("gnn_node_classification", "influence_campaign",
            "multi_tenant_campaign", "quickstart", "recsys_ctr",
            "streaming_campaign", "train_lm")


def _imported_roots(path) -> set:
    """The top-level packages a file's import statements name."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_imports_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.engine" in res["modules"]
    assert "repro_torch.kernels.coins" in res["modules"]
    assert "repro_torch.launch.im_run" in res["modules"]
    for name in ("core.pack.codec", "core.pack.stores", "core.pack.selection",
                 "kernels.packed_count", "kernels.commit",
                 "kernels.ic_frontier", "core.sampler", "core.ties",
                 "models.transformer", "models.attention",
                 "kernels.flash_attention", "launch.serve",
                 "configs.qwen1_5_0_5b", "models.recsys.fm",
                 "kernels.fm_interaction", "configs.fm", "optim.adamw",
                 "data.clicks", "checkpoint", "checkpoint.store",
                 "core.adaptive", "core.store", "core.selection",
                 "launch.roofline", "obs.metrics", "sparse",
                 "sparse.segment", "sparse.scatter", "convert",
                 "mesh", "graphs.partition", "configs.imm_snap",
                 "stream", "stream.engine", "stream.invalidate",
                 "stream.delta", "serve", "serve.tier", "serve.tenant",
                 "serve.replica", "core.engine", "core.store",
                 "models.moe", "models.moe_sharded",
                 "configs.moonshot_v1_16b_a3b", "configs.grok_1_314b",
                 "configs._lm_common", "runtime", "runtime.loop",
                 "runtime.straggler", "runtime.elastic",
                 "runtime.compression", "data", "data.tokens",
                 "data.prefetch", "launch.train", "models.gnn",
                 "models.gnn.mpnn", "models.gnn.graphsage",
                 "models.gnn.egnn", "models.gnn.graphcast",
                 "models.gnn.irreps", "models.gnn.equiformer",
                 "sparse.embedding_bag", "graphs.sampler",
                 "data.graph_feats", "configs._gnn_common", "configs.egnn",
                 "configs.equiformer_v2", "configs.graphcast",
                 "configs.graphsage_reddit", "launch.steps",
                 "launch.shardings", "launch.mesh", "launch.dryrun"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["examples"] == [f"examples_torch.{n}" for n in EXAMPLES]
    assert res["leaked"] == []
    for name in EXAMPLES:
        roots = _imported_roots(os.path.join(ROOT, "examples_torch",
                                             f"{name}.py"))
        assert not roots & {"jax", "jaxlib", "repro", "examples"}, name


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_run_on_cuda_unless_told_otherwise(name, capsys):
    """Each port example's ``--device`` defaults to ``cuda``, which raises
    on a host without a card before any work."""
    from repro_torch.device import resolve_device

    sys.path.insert(0, ROOT)
    try:
        import importlib
        mod = importlib.import_module(f"examples_torch.{name}")
    finally:
        sys.path.remove(ROOT)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if name in ("recsys_ctr", "gnn_node_classification"):
            mod.main()
        else:
            mod.main(["--tiny"] if name == "train_lm" else [])


def test_entry_points_default_to_cuda():
    from repro_torch.core.engine import InfluenceEngine, resolve_device
    from repro_torch.graphs import generators

    g = generators.rmat_graph(5000, 20000, seed=0)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InfluenceEngine(g)
    from repro_torch.core.imm import imm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imm(g)
    from repro_torch.launch import im_run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        im_run.run("com-Amazon", scale=0.02, log=lambda s: None)
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import LMServer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMServer(get_arch("qwen1.5-0.5b").smoke_config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_arch("qwen1.5-0.5b").init_fn(torch.Generator(),
                                         get_arch("qwen1.5-0.5b").smoke_config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_arch("fm").init_fn(get_arch("fm").smoke_config,
                               generator=torch.Generator())
    from repro_torch import convert
    import numpy as np
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_jax({"w": np.ones(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.fm_params_from_jax({"v": np.ones((4, 2), np.float32),
                                    "w": np.ones(4, np.float32),
                                    "b": np.float32(0)})
    # the GNNs (A9c): every init and the converter refuse without a card
    for arch in ("graphsage-reddit", "egnn", "graphcast", "equiformer-v2"):
        a = get_arch(arch)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            a.init_fn(torch.Generator(), a.smoke_config)
        assert a.init_fn(torch.Generator(), a.smoke_config,
                         device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.gnn_params_from_jax({"layers": [{"w": np.ones(3,
                                                               np.float32)}]})
    tree = convert.gnn_params_from_jax(
        {"layers": [{"w": np.ones(3, np.float32)}]}, device="cpu")
    assert tree["layers"][0]["w"].device.type == "cpu"
    from repro_torch.core.store import ShardedStore, make_store
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_store("indices", 16)
    # the meshed solve (A8): a mesh of the card refuses without one, a
    # mesh of the host runs there
    from repro_torch.configs.imm_snap import make_im_mesh
    from repro_torch.mesh import Mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_im_mesh("2x2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_store("sharded", 16, mesh=Mesh([["cuda"]], ("data", "vertex")),
                   vertex_axis="vertex")
    mesh = make_im_mesh("2x2", device="cpu")
    assert isinstance(make_store("sharded", 16, mesh=mesh,
                                 vertex_axis="vertex"), ShardedStore)
    assert InfluenceEngine(g, mesh=mesh, vertex_axis="vertex"
                           ).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InfluenceEngine(g, store=make_store("indices", g.n, device="cpu"))
    # the meshed stream and tier (A8b): a mesh of the card refuses
    # without one, a mesh of the host runs there
    from repro_torch.serve import IMServe
    from repro_torch.stream import StreamEngine
    small = generators.rmat_graph(64, 256, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(small, mesh=Mesh([["cuda"]], ("data", "vertex")),
                     vertex_axis="vertex")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IMServe(mesh_kwargs={"mesh": mesh, "vertex_axis": "vertex"})
    meshed = StreamEngine(small, mesh=mesh, vertex_axis="vertex")
    assert meshed.store.device.type == "cpu"
    assert IMServe(mesh_kwargs={"mesh": mesh, "vertex_axis": "vertex"},
                   device="cpu").device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"
    # the launchers (A9d): a cell, its step and a local mesh run on the
    # card unless told otherwise; the dry run's meta mesh touches none
    from repro_torch.launch.dryrun import execute_cell
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.launch.steps import build_cell
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cell("fm", "serve_p99")
    cell = build_cell("fm", "serve_p99", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute_cell(cell, ())
    assert make_local_mesh(device="cpu").size == 1
    assert make_production_mesh(device="meta").size == 256


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without CUDA, or outside the repo, the smoke prints no ok line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_stream_modules_import_alone_and_default_to_cuda():
    """The streaming slice's modules load no JAX (the probe above walks
    every module; these are named so a missing one fails here), and its
    entry points run on the card unless given ``device="cpu"``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("stream", "stream.delta", "stream.invalidate",
                 "stream.engine", "graphs.generators", "obs.tracer"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["leaked"] == []
    if torch.cuda.is_available():
        return
    from repro_torch.core.store import StorePressurePolicy, make_store
    from repro_torch.graphs import generators
    from repro_torch.launch import serve
    from repro_torch.stream import StreamEngine

    g = generators.rmat_graph(64, 256, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_store("packed", 64, policy=StorePressurePolicy(max_rows=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--workload", "im", "--scale", "0.002"])


def test_serve_tier_modules_import_alone_and_default_to_cuda():
    """The IMServe tier's modules load no JAX, and the tier builds its
    tenant engines on the card unless given ``device="cpu"``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("serve", "serve.admission", "serve.cache", "serve.replica",
                 "serve.scheduler", "serve.tenant", "serve.tier",
                 "serve.trace"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["leaked"] == []
    from repro_torch.serve import IMServe

    assert IMServe(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert IMServe().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IMServe()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--workload", "tier", "--tenants", "1", "--tier-n", "64"])


def test_fm_serving_kernel_imports_alone():
    """The fused FM serving kernel (its wrapper, plain version, dispatch
    and the model's serving route) loads no JAX, and serves on the CPU
    only when its tensors are there."""
    probe = r"""
import json, sys, torch
from repro_torch.kernels import fm_interaction as fmk, ops, ref
from repro_torch.models.recsys import fm
cfg = fm.FMConfig(n_sparse=3, embed_dim=4, vocab_per_field=8)
p = fm.init_fm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
idx = torch.tensor([[0, 1, 2], [7, 7, 8]], dtype=torch.int32)
out = fm.fm_logits(p, cfg, idx)
same = torch.equal(out.isnan(), ops.fm_gather_interaction(
    idx, 8, p["v"], p["w"], p["b"]).isnan())
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"nan": out.isnan().tolist(), "same": same,
                  "ref": ref.fm_gather_interaction_ref is
                  fmk.fm_gather_interaction_plain, "leaked": leaked}))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"nan": [False, True], "same": True, "ref": True,
                   "leaked": []}
