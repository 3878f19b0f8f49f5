"""repro_torch.checkpoint against the JAX package's on the CPU: the npz +
JSON-spec format read and written by both packages, retention, the
``latest`` pointer, the manager; and InfluenceEngine snapshot / restore /
replicate across the packages, on every store, bitwise."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jckpt  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.checkpoint import store as ckpt  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.launch import im_run  # noqa: E402

STORES = ("bitmap", "packed", "compressed", "indices")
SEED_SETS = [[1, 2, 3], [5], [0, 7, 9, 11, 13], list(range(0, 300, 9))]
N, M = 384, 1536


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bf16_bits(x) -> np.ndarray:
    """The 16-bit words of a bfloat16 tensor, or of a saved ``|V2`` leaf."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _port_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn(3, 4, generator=g),
        "layers": [torch.randn(5, generator=g).to(torch.bfloat16),
                   (torch.arange(6, dtype=torch.int32).reshape(2, 3),
                    "relu", np.int64(7))],
        "meta": {"name": np.asarray("engine"), "step": 12,
                 "flag": torch.tensor([True, False])},
        "empty": [],
    }


def _jax_tree():
    rng = np.random.default_rng(0)
    return {
        "w": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32),
        "layers": [jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
                   (jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
                    "relu", np.int64(7))],
        "meta": {"name": np.asarray("engine"), "step": 12,
                 "flag": jnp.asarray([True, False])},
        "empty": [],
    }


def _check_loaded(got, want_w, want_bf16, want_ints, want_flag):
    """A loaded tree: structure, dtypes and bits of every leaf."""
    assert isinstance(got, dict) and sorted(got) == ["empty", "layers",
                                                     "meta", "w"]
    assert isinstance(got["layers"], list) and got["empty"] == []
    assert isinstance(got["layers"][1], tuple)
    np.testing.assert_array_equal(got["w"], want_w)
    assert got["w"].dtype == np.float32
    assert got["layers"][0].dtype == np.dtype("V2")
    np.testing.assert_array_equal(_bf16_bits(got["layers"][0]), want_bf16)
    np.testing.assert_array_equal(got["layers"][1][0], want_ints)
    assert got["layers"][1][0].dtype == np.int32
    assert str(got["layers"][1][1]) == "relu"
    assert int(got["layers"][1][2]) == 7
    assert str(got["meta"]["name"]) == "engine"
    assert int(got["meta"]["step"]) == 12
    np.testing.assert_array_equal(got["meta"]["flag"], want_flag)


def test_nested_tree_round_trips_in_the_port(tmp_path):
    tree = _port_tree()
    path = ckpt.save_named(str(tmp_path), "t", tree)
    assert path == os.path.join(str(tmp_path), "t.npz")
    assert sorted(os.listdir(tmp_path)) == ["t.npz"]     # no .tmp left
    got = ckpt.load_named(str(tmp_path), "t")
    _check_loaded(got, tree["w"].numpy(), _bf16_bits(tree["layers"][0]),
                  tree["layers"][1][0].numpy(), [True, False])
    assert ckpt.load_named(str(tmp_path), "absent") is None
    with pytest.raises(ValueError, match="invalid snapshot name"):
        ckpt.save_named(str(tmp_path), "step_3", tree)
    with pytest.raises(ValueError, match="invalid snapshot name"):
        ckpt.save_named(str(tmp_path), "a/b", tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_load_in_the_other_package(tmp_path, writer):
    """A file written by either package loads in the other, leaf for
    leaf, with bfloat16 as the same 16-bit words."""
    if writer == "jax":
        tree = _jax_tree()
        jckpt.save_named(str(tmp_path), "t", tree)
        jckpt.save_checkpoint(str(tmp_path), 5, tree)
        got = ckpt.load_named(str(tmp_path), "t")
        step, got_step = ckpt.load_checkpoint(str(tmp_path))
        want_bf16 = np.asarray(tree["layers"][0]).view(np.uint16)
    else:
        tree = _port_tree()
        ckpt.save_named(str(tmp_path), "t", tree)
        ckpt.save_checkpoint(str(tmp_path), 5, tree)
        got = jckpt.load_named(str(tmp_path), "t")
        step, got_step = jckpt.load_checkpoint(str(tmp_path))
        want_bf16 = _bf16_bits(tree["layers"][0])
    assert step == 5
    for t in (got, got_step):
        _check_loaded(t, np.asarray(tree["w"]), want_bf16,
                      np.asarray(tree["layers"][1][0]), [True, False])
    # both packages see the same leaf bytes
    assert ckpt.tree_bytes(got) == jckpt.tree_bytes(got)


def test_retention_and_the_latest_pointer_match_the_reference(tmp_path):
    """``keep`` retention, a corrupt and a stale ``latest`` pointer, and
    ``load_checkpoint`` at a step, the same in both packages."""
    dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    mods = {"port": ckpt, "jax": jckpt}
    for who, mod in mods.items():
        for step in (1, 2, 3, 4):
            mod.save_checkpoint(dirs[who], step, {"x": np.full(3, step)},
                                keep=2)
    assert sorted(os.listdir(dirs["port"])) == sorted(
        os.listdir(dirs["jax"])) == ["latest", "step_0000000003.npz",
                                     "step_0000000004.npz"]
    for who, mod in mods.items():
        assert mod.latest_step(dirs[who]) == 4
        with open(os.path.join(dirs[who], "latest"), "w") as f:
            f.write("garbage")                      # corrupt pointer
        assert mod.latest_step(dirs[who]) == 4
        with open(os.path.join(dirs[who], "latest"), "w") as f:
            f.write("2")                            # stale: step 2 pruned
        assert mod.latest_step(dirs[who]) == 4
        with open(os.path.join(dirs[who], "latest"), "w") as f:
            f.write("3")
        step, tree = mod.load_checkpoint(dirs[who])
        assert step == 3
        np.testing.assert_array_equal(tree["x"], [3, 3, 3])
        step, tree = mod.load_checkpoint(dirs[who], step=4)
        np.testing.assert_array_equal(tree["x"], [4, 4, 4])
        assert mod.load_checkpoint(str(tmp_path / "none")) == (None, None)
        assert mod.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_manager_restore_or_init(tmp_path):
    d = str(tmp_path / "run")
    mgr = ckpt.CheckpointManager(d, save_every=2, keep=2)
    step, tree = mgr.restore_or_init(lambda: {"w": np.zeros(2)})
    assert step == 0 and tree["w"].tolist() == [0.0, 0.0]
    for s in range(1, 8):
        saved = mgr.maybe_save(s, {"w": torch.full((2,), float(s))})
        assert (saved is not None) == (s % 2 == 0)
    assert sorted(os.listdir(d)) == ["latest", "step_0000000004.npz",
                                     "step_0000000006.npz"]
    step, tree = mgr.restore_or_init(lambda: None)
    assert step == 6 and tree["w"].tolist() == [6.0, 6.0]
    jstep, jtree = jckpt.CheckpointManager(d).restore_or_init(lambda: None)
    assert jstep == 6 and jtree["w"].tolist() == [6.0, 6.0]
    mgr.save(9, {"w": np.ones(2)})
    assert ckpt.latest_step(d) == 9
    mgr.wipe()
    assert not os.path.exists(d)


def test_clone_tree_shares_no_buffer():
    tree = {"a": np.arange(4), "b": [torch.ones(3), (np.float32(2.0),)]}
    clone = ckpt.clone_tree(tree)
    assert not np.shares_memory(clone["a"], tree["a"])
    clone["a"][0] = 99
    assert tree["a"][0] == 0
    tb = clone["b"][0]
    assert isinstance(tb, np.ndarray)
    tb[:] = 5.0
    assert float(tree["b"][0].sum()) == 3.0
    assert isinstance(clone["b"][1], tuple)
    assert ckpt.tree_bytes(tree) == jckpt.tree_bytes(
        {"a": tree["a"], "b": [np.ones(3, np.float32), (np.float32(2.0),)]})


# ------------------------------------------------------- engine snapshots --

def _cfg(cls, store):
    return cls(k=6, backend="sparse", store=store, max_theta=4096, seed=7)


def _same_engines(eng, jeng):
    assert eng.theta == jeng.theta
    assert eng.store.representation == jeng.store.representation
    np.testing.assert_array_equal(eng.store.R.numpy(),
                                  np.asarray(jeng.store.R))
    np.testing.assert_array_equal(eng.store.counter.numpy(),
                                  np.asarray(jeng.store.counter))
    np.testing.assert_array_equal(eng.store.sizes.numpy(),
                                  np.asarray(jeng.store.sizes))
    np.testing.assert_array_equal(eng.key, np.asarray(jeng.key))
    sel, jsel = eng.select(6), jeng.select(6)
    np.testing.assert_array_equal(sel.seeds, jsel.seeds)
    assert sel.covered_frac == jsel.covered_frac
    np.testing.assert_array_equal(eng.influences(SEED_SETS),
                                  jeng.influences(SEED_SETS))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("store", STORES)
def test_engine_snapshot_continues_across_packages(tmp_path, store, writer):
    """An engine of one package snapshotted at theta 256 continues in the
    other to theta 1,024 exactly as the writer continues itself."""
    jeng = JEngine(jgen.rmat_graph(N, M, seed=4), _cfg(JConfig, store))
    eng = InfluenceEngine(generators.rmat_graph(N, M, seed=4),
                          _cfg(IMMConfig, store), device="cpu")
    src, dst = (jeng, eng) if writer == "jax" else (eng, jeng)
    src.extend(256)
    src.snapshot(str(tmp_path))
    assert dst.restore(str(tmp_path))
    assert dst.theta == 256
    assert dst.store.representation == src.store.representation
    if store == "indices":
        assert eng._emit_l == jeng._emit_l > 0
    src.extend(1024)
    dst.extend(1024)
    _same_engines(eng, jeng)


@pytest.mark.parametrize("store", STORES)
def test_restore_and_replicate_in_the_port(tmp_path, store):
    """restore into a fresh engine and replicate(): identical answers, no
    tensor shared with the primary, and the PRNG stream resumes."""
    g = generators.rmat_graph(N, M, seed=5)
    eng = InfluenceEngine(g, _cfg(IMMConfig, store), device="cpu")
    eng.extend(512)
    assert not InfluenceEngine(g, _cfg(IMMConfig, store),
                               device="cpu").restore(str(tmp_path))
    eng.snapshot(str(tmp_path))
    fresh = InfluenceEngine(g, _cfg(IMMConfig, store), device="cpu")
    assert fresh.restore(str(tmp_path))
    rep = eng.replicate()
    want = eng.select(6)
    ptrs = {t.untyped_storage().data_ptr() for t in
            (eng.store._arena, eng.store.counter, eng.store.sizes,
             eng.store.live)}
    for other in (fresh, rep):
        got = other.select(6)
        np.testing.assert_array_equal(got.seeds, want.seeds)
        assert got.covered_frac == want.covered_frac
        np.testing.assert_array_equal(other.influences(SEED_SETS),
                                      eng.influences(SEED_SETS))
        for t in (other.store._arena, other.store.counter,
                  other.store.sizes, other.store.live):
            assert t.untyped_storage().data_ptr() not in ptrs
    eng.extend(1024)
    fresh.extend(1024)
    assert torch.equal(fresh.store.counter, eng.store.counter)
    assert rep.theta == 512                      # the primary moved alone
    np.testing.assert_array_equal(rep.select(6).seeds, want.seeds)
    with pytest.raises(ValueError, match="n="):
        InfluenceEngine(generators.rmat_graph(64, 256, seed=0),
                        _cfg(IMMConfig, store),
                        device="cpu").restore(str(tmp_path))


@pytest.mark.parametrize("store", ["auto", "indices"])
def test_im_run_snapshot_dir_twice(tmp_path, store):
    """The second run restores the first run's store: identical seeds,
    influence and theta."""
    kw = dict(scale=0.0015, k=5, max_theta=1024, backend="sparse",
              store=store, snapshot_dir=str(tmp_path), device="cpu",
              log=lambda s: None)
    first = im_run.run("com-Amazon", **kw)
    assert os.listdir(tmp_path) == ["engine.npz"]
    second = im_run.run("com-Amazon", **kw)
    assert first["n"] <= 512
    for key in ("seeds", "influence", "theta", "covered_frac",
                "representation"):
        assert first[key] == second[key]
