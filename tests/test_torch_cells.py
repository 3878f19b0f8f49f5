"""The port's cells (``repro_torch.launch.steps``) held to the reference's
(``repro.launch.steps``) on both production meshes, field by field.

The reference builds its cells on ``jax.sharding.AbstractMesh`` (no
devices needed); the two Equiformer cells that read ``mesh.devices``
get an abstract mesh whose ``devices`` has the mesh's shape.  The port
builds its cells on production meshes of the ``meta`` device.  Every
cell's kind, note, model flops and ideal attention bytes are equal as
floats; every input leaf's shape and dtype, in path order (dicts in key
order, as ``jax.tree`` walks them); every in and out spec, a
``PartitionSpec`` read as a tuple.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding as JNamed  # noqa: E402

from repro.configs import (  # noqa: E402
    IMM_DRYRUN_CELLS as J_IMM, all_cells as j_all_cells,
)
from repro.launch import shardings as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe_sharded as j_moe_sharded  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    IMM_DRYRUN_CELLS, all_archs, all_cells, get_arch,
)
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    dp_axes, make_production_mesh, tp_axis,
)
from repro_torch.models import moe_sharded  # noqa: E402
from repro_torch.runtime.elastic import NamedSharding  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _one_thread_and_moe_mesh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = (moe_sharded.MESH, j_moe_sharded.MESH)
    yield
    moe_sharded.MESH, j_moe_sharded.MESH = saved
    torch.set_num_threads(threads)


class _DevMesh(AbstractMesh):
    """An abstract mesh with a ``devices`` array of its shape, which the
    reference's chunked Equiformer cell reads the tile count from."""

    @property
    def devices(self):
        return np.zeros(tuple(self.axis_sizes), object)


def _jmesh(name):
    shape, axes = MESHES[name]
    return _DevMesh(shape, axes)


def _mesh(name):
    return make_production_mesh(multi_pod=name == "2x16x16", device="meta")


def _flat(tree, path=()):
    """``[(path, leaf)]`` with dicts in key order, lists and tuples in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, sh.P):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, path + (i,))]
    return [(path, tree)]


def _jpath(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jflat(tree, is_leaf=None):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(_jpath(p), x) for p, x in leaves]


def _specs(flat):
    return [(p, tuple(s.spec)) for p, s in flat]


def _assert_same_cell(cell, ref):
    assert cell.kind == ref.kind
    assert cell.note == ref.note
    assert float(cell.model_flops) == float(ref.model_flops)
    assert float(cell.attention_ideal_bytes) == float(
        ref.attention_ideal_bytes)
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in _flat(cell.input_specs)]
    want = [(p, tuple(x.shape), str(x.dtype))
            for p, x in _jflat(ref.input_specs)]
    assert got == want
    for mine, theirs in ((cell.in_shardings, ref.in_shardings),
                         (cell.out_shardings, ref.out_shardings)):
        flat = _flat(mine)
        assert all(isinstance(s, NamedSharding) for _, s in flat)
        assert _specs(flat) == _specs(_jflat(
            theirs, is_leaf=lambda x: isinstance(x, JNamed)))


def test_all_cells_equal_the_reference():
    assert all_cells() == j_all_cells()
    assert all_cells(include_skipped=True) == j_all_cells(True)
    assert len(all_cells()) == 36 and len(all_cells(True)) == 40
    assert list(IMM_DRYRUN_CELLS) == list(J_IMM)
    assert IMM_DRYRUN_CELLS == J_IMM


def test_policy_tables_equal_the_reference():
    assert sh.LM_POLICY == jsh.LM_POLICY
    assert sh.LM_TRAIN_MICROBATCHES == jsh.LM_TRAIN_MICROBATCHES
    assert sh.LM_PREFILL_CHUNK == jsh.LM_PREFILL_CHUNK


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch_id,shape_name", j_all_cells())
def test_cell_equals_the_reference(arch_id, shape_name, mesh_name):
    ref = jsteps.build_cell(arch_id, shape_name, _jmesh(mesh_name))
    cell = steps.build_cell(arch_id, shape_name, _mesh(mesh_name))
    assert (cell.arch_id, cell.shape_name) == (arch_id, shape_name)
    _assert_same_cell(cell, ref)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("cell_name", list(J_IMM))
def test_imm_cell_equals_the_reference(cell_name, mesh_name):
    ref = jsteps.build_imm_cell(cell_name, J_IMM[cell_name],
                                _jmesh(mesh_name))
    cell = steps.build_imm_cell(cell_name, IMM_DRYRUN_CELLS[cell_name],
                                _mesh(mesh_name))
    assert cell.arch_id == "imm"
    _assert_same_cell(cell, ref)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch_id,shape_name", [
    ("equiformer-v2", "minibatch_lg"), ("equiformer-v2", "ogb_products"),
    ("graphcast", "ogb_products"), ("egnn", "molecule"),
    ("graphsage-reddit", "minibatch_lg")])
def test_gnn_config_and_graph_dims_equal_the_reference(arch_id, shape_name,
                                                       mesh_name):
    from repro.configs import get_arch as jget_arch
    jarch, arch = jget_arch(arch_id), get_arch(arch_id)
    jmesh, mesh = _jmesh(mesh_name), _mesh(mesh_name)
    assert steps._gnn_graph_dims(arch.shape(shape_name), mesh) == \
        jsteps._gnn_graph_dims(jarch.shape(shape_name), jmesh)
    got = dataclasses.asdict(steps._gnn_cell_config(
        arch, arch.shape(shape_name), mesh))
    want = dataclasses.asdict(jsteps._gnn_cell_config(
        jarch, jarch.shape(shape_name), jmesh))
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 32, 128])
def test_kv_cache_spec_equals_the_reference(batch, mesh_name):
    heads = sorted({a.config.n_kv_heads for a in all_archs().values()
                    if a.family == "lm"})
    for h in heads:
        assert sh.kv_cache_spec(h, _mesh(mesh_name), batch=batch) == tuple(
            jsh.kv_cache_spec(h, _jmesh(mesh_name), batch=batch))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_axes_equal_the_reference(mesh_name):
    mesh = _mesh(mesh_name)
    shape, axes = MESHES[mesh_name]
    assert mesh.axis_names == axes
    assert tuple(mesh.devices.shape) == shape
    assert {str(d) for d in mesh.distinct_devices()} == {"meta"}
    assert dp_axes(mesh) == axes[:-1] and tp_axis(mesh) == "model"


@pytest.mark.parametrize("arch_id,shape_name", [
    (a, s) for a, s in j_all_cells(include_skipped=True)
    if (a, s) not in j_all_cells()])
def test_build_cell_refuses_a_skipped_cell(arch_id, shape_name):
    with pytest.raises(ValueError, match="is skipped"):
        steps.build_cell(arch_id, shape_name, _mesh("16x16"))


def test_the_spec_normalizes_as_partition_spec_does():
    from jax.sharding import PartitionSpec as JP
    for entries in [(("data",), None), (("pod", "data"), "model"), ((),),
                    (None, "model"), ()]:
        assert tuple(sh.P(*entries)) == tuple(JP(*entries))


def _chip_smoke():
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


_SMOKE_GNN_CUTS = [("graphcast", "ogb_products"),
                   ("equiformer-v2", "minibatch_lg"),
                   ("equiformer-v2", "ogb_products"),
                   ("egnn", "ogb_products"),
                   ("graphsage-reddit", "ogb_products")]


@pytest.mark.parametrize("arch_id,shape_name", _SMOKE_GNN_CUTS)
def test_smoke_cut_gnn_cells_keep_the_published_config(arch_id,
                                                       shape_name):
    """The smoke's GNN cells cut to one card (`chip_smoke.cut_cell` on a
    1x1 mesh: the batch, then the layers, then the graph) keep the
    reference's config of the published shape on a 1x1 mesh: latent
    dtype, remat group, channel axis; and its layout (the edge-chunked
    scan at Equiformer's two large cells)."""
    from repro.configs import get_arch as jget_arch
    cs = _chip_smoke()
    cuts = cs.CELL_CUTS[(arch_id, shape_name)]
    order = ["batch_nodes", "n_layers", "graph"]
    assert sorted(cuts, key=order.index) == list(cuts)
    assert "n_layers" in cuts
    from repro_torch.mesh import Mesh
    cell, reduced, config = cs.cut_cell(arch_id, shape_name,
                                        Mesh([["meta"]], ("data", "model")))
    jarch = jget_arch(arch_id)
    ref = jsteps._gnn_cell_config(jarch, jarch.shape(shape_name),
                                  _DevMesh((1, 1), ("data", "model")))
    assert config == {k: getattr(ref, k) for k in ("dtype", "remat_group",
                                                    "channel_axis")
                      if hasattr(ref, k)}
    assert reduced["n_layers"] == [ref.n_layers, cuts["n_layers"]]
    chunked = arch_id == "equiformer-v2"
    assert cell.note.endswith("edge-chunked scan") == chunked
