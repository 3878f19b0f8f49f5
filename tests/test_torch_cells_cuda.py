"""The launchers' cells on the card, held to the same cells on the host at
smoke width: FM serving and training within ``4e-6`` of a logit's
magnitude (the card sums a row's fields in another order), an LM train
step and GraphCast's dst-partitioned step within ``1e-4 * (1 + |cpu|)``,
the IMM selection and sampler exact; `execute_cell` records its device
numbers and a census with no byte crossing on a 2x2 mesh of one card.

Every test needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package:
``python -m pytest -q -m cuda tests/test_torch_cells_cuda.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe_sharded  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-4
FM_TOL = 4e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = moe_sharded.MESH
    yield torch.device("cuda")
    moe_sharded.MESH = saved


def _mesh(dev, shape=(1, 1)):
    return Mesh([[dev] * shape[1]] * shape[0], ("data", "model"))


def _cell(arch_id, shape_name, dims, mesh):
    arch = get_arch(arch_id)
    cfg = arch.smoke_config
    if arch.family == "lm":
        cfg = dataclasses.replace(cfg, name=arch.config.name)
    return steps.build_arch_cell(
        dataclasses.replace(arch, config=cfg),
        dataclasses.replace(arch.shape(shape_name), dims=dims), mesh)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    # a 0-dim integer (the AdamW step, a cache's length) stays on the host
    if tree.dim() == 0 and not tree.is_floating_point():
        return tree.clone()
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close(got, want, tol=TOL):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape
    err = ((got - want).abs() / (1 + want.abs())).max()
    assert float(err) <= tol, float(err)


def _both(arch_id, shape_name, dims, dev, shape=(1, 1)):
    """The cell on the host and on the card, its inputs drawn once on the
    host."""
    host = _cell(arch_id, shape_name, dims, _mesh("cpu", shape))
    card = _cell(arch_id, shape_name, dims, _mesh(dev, shape))
    inputs = host.make_inputs(torch.Generator().manual_seed(0), "cpu")
    return host, card, inputs, _to(inputs, dev)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_fm_serve_cell_cuda_equals_cpu(cuda, shape):
    host, card, hin, cin = _both("fm", "serve_p99", {"batch": 64}, cuda,
                                 shape)
    want, got = host.step_fn(*hin), card.step_fn(*cin)
    v, w, b, idx = hin
    cfg = get_arch("fm").smoke_config
    rows = idx.long() + cfg.field_offsets()[None, :]
    mag = (b.abs() + w.abs()[rows].sum(-1)
           + (v.abs()[rows].sum(-2) ** 2).sum(-1))
    assert bool(((got.cpu() - want).abs() <= FM_TOL * mag).all())


def test_fm_train_cell_cuda_equals_cpu(cuda):
    host, card, hin, cin = _both("fm", "train_batch", {"batch": 64}, cuda)
    for _ in range(2):
        hs, hm = host.step_fn(*hin)
        cs, cm = card.step_fn(*cin)
        _close(cm["loss"], hm["loss"], FM_TOL)
        for g, w in zip(_leaves(cs["params"]), _leaves(hs["params"])):
            _close(g, w, FM_TOL)


def test_lm_train_cell_cuda_equals_cpu(cuda):
    dims = {"seq_len": 32, "global_batch": 2}
    host, card, hin, cin = _both("qwen1.5-0.5b", "train_4k", dims, cuda)
    for _ in range(2):
        hs, hm = host.step_fn(*hin)
        cs, cm = card.step_fn(*cin)
        _close(cm["loss"], hm["loss"])
        _close(cm["grad_norm"], hm["grad_norm"])
        for g, w in zip(_leaves(cs["params"]), _leaves(hs["params"])):
            _close(g, w)


def test_graphcast_cell_on_2x2_cuda_equals_cpu(cuda):
    dims = {"n_nodes": 40, "n_edges": 128, "d_feat": 8, "n_classes": 5}
    host, card, hin, cin = _both("graphcast", "full_graph_sm", dims, cuda,
                                 (2, 2))
    for _ in range(2):
        hs, hm = host.step_fn(*hin)
        cs, cm = card.step_fn(*cin)
        _close(cm["loss"], hm["loss"])
        for g, w in zip(_leaves(cs["params"]), _leaves(hs["params"])):
            _close(g, w)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_imm_cells_cuda_equal_cpu(cuda, shape):
    specs = {"imm_select_youtube_ic": {"n": 300, "theta": 512, "k": 8},
             "imm_sample_google_ic": {"n": 200, "m": 800, "batch": 16,
                                      "bfs_steps": 6}}
    for name, spec in specs.items():
        host = steps.build_imm_cell(name, spec, _mesh("cpu", shape))
        card = steps.build_imm_cell(name, spec, _mesh(cuda, shape))
        hin = host.make_inputs(torch.Generator().manual_seed(1), "cpu")
        for g, w in zip(card.step_fn(*_to(hin, cuda)), host.step_fn(*hin)):
            assert torch.equal(g.cpu(), w)


def test_execute_cell_on_the_card_records_device_numbers(cuda):
    mesh = _mesh(cuda, (2, 2))
    cell = _cell("fm", "serve_p99", {"batch": 64}, mesh)
    inputs = cell.make_inputs(torch.Generator(device=cuda).manual_seed(0),
                              cuda)
    outs, rec = dryrun.execute_cell(cell, inputs, mesh, steps=2)
    assert len(rec["step_ms"]) == 2 and all(ms > 0 for ms in rec["step_ms"])
    assert rec["max_memory_allocated"] > 0 and rec["device"]
    assert rec["collectives"]["psum"]["calls"] == 4
    assert rec["collectives"]["psum"]["cross_bytes"] == 0
    assert all(torch.equal(o, outs[0]) for o in outs)
