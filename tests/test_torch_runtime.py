"""The port's training runtime (``repro_torch.runtime``: the loop, the
straggler monitor, int8 compression, elastic resharding) against the JAX
package on the same inputs, and the reference's own runtime tests
(``tests/test_runtime.py``) ported.

Bitwise throughout: the straggler monitor is the same Python arithmetic;
compression is the same float32 operations one at a time (``torch.round``
and ``jnp.round`` both round half to even), so ``q``, ``scale`` and the
error-feedback residuals carry the same bits; the loops, driven by the
same fault schedule over the same step function, give the same history
(step, retries, restores) and the same final state; a resharded tree
gathers back to the bits it was made from, a JAX checkpoint's too.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import save_checkpoint as jax_save  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro.runtime import loop as jloop  # noqa: E402
from repro.runtime.straggler import StragglerMonitor as JMonitor  # noqa: E402
from repro_torch.checkpoint.store import (  # noqa: E402
    latest_step, load_checkpoint, save_checkpoint,
)
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ElasticPlan, LoopConfig, StragglerMonitor, TrainLoop, compress_int8,
    compress_with_feedback, compressed_allreduce_spec, decompress_int8,
    gather_tree, init_error_feedback, reshard_tree,
)
from repro_torch.runtime.elastic import (  # noqa: E402
    NamedSharding, ShardedLeaf, place, replicated_plan,
)
from repro_torch.runtime.loop import RemeshRequested  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(x):
    """A float32 array's (or tensor's) bit patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------ fault loop ----
# the reference's three loop tests, on a torch scalar state

def _faults(at: int, n: int):
    left = {"n": n}

    def inject(step, retries):
        if step == at and left["n"] > 0:
            left["n"] -= 1
            return True
        return False

    return inject


def test_loop_retries_transient_fault(tmp_path):
    loop = TrainLoop(
        LoopConfig(total_steps=6, checkpoint_dir=str(tmp_path), save_every=2,
                   max_retries=2),
        lambda s, b: (s + b, {"v": s}), lambda step: torch.tensor(1.0),
        lambda: torch.tensor(0.0), inject_fault=_faults(3, 1))
    final = loop.run()
    assert float(final) == 6.0
    assert loop.recoveries == 0          # the retry worked, no restore
    assert [r.retried for r in loop.history] == [0, 0, 0, 1, 0, 0]


def test_loop_restores_from_checkpoint_and_replays(tmp_path):
    loop = TrainLoop(
        LoopConfig(total_steps=8, checkpoint_dir=str(tmp_path), save_every=2,
                   max_retries=2),
        lambda s, b: (s + b, {"v": s}), lambda step: torch.tensor(1.0),
        lambda: torch.tensor(0.0), inject_fault=_faults(4, 3))
    final = loop.run()
    assert isinstance(final, torch.Tensor) and float(final) == 8.0
    assert loop.recoveries == 1
    assert [r.restored for r in loop.history] == [False] * 4 + [True] + \
        [False] * 3


def test_loop_requests_remesh_on_persistent_straggle(tmp_path):
    import time as _t

    def slow_step(s, b):
        if float(s) >= 6.0:
            _t.sleep(0.05)
        return s + b, {"v": s}

    loop = TrainLoop(
        LoopConfig(total_steps=30, checkpoint_dir=str(tmp_path),
                   save_every=100, straggler_threshold=1.5),
        slow_step, lambda step: torch.tensor(1.0),
        lambda: torch.tensor(0.0))
    with pytest.raises(RemeshRequested):
        loop.run()
    # the checkpoint is written before the raise
    assert latest_step(str(tmp_path)) is not None


# schedules of (step, number of faults): a transient fault, retries used
# up after a checkpoint, two restores, a restore before any checkpoint
# (back to init_fn), a fault on the last step
SCHEDULES = {
    "transient": [(3, 1)],
    "restore": [(4, 3)],
    "two_restores": [(3, 3), (6, 5)],
    "before_checkpoint": [(1, 3)],
    "last_step": [(7, 4), (2, 2)],
}


def _schedule(pairs):
    left = dict(pairs)

    def inject(step, retries):
        if left.get(step, 0) > 0:
            left[step] -= 1
            return True
        return False

    return inject


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_loop_history_and_state_match_jax(tmp_path, name):
    """The same fault schedule over the same step function: the same
    history, recoveries, checkpoint files and final state, bitwise."""
    w0 = np.linspace(-1, 1, 5, dtype=np.float32)

    def jstep(s, b):
        return ({"w": s["w"] * np.float32(0.5) + b, "n": s["n"] + 1},
                {"loss": jnp.max(s["w"])})

    def tstep(s, b):
        return ({"w": s["w"] * 0.5 + b, "n": s["n"] + 1},
                {"loss": torch.max(s["w"])})

    cfg = dict(total_steps=8, save_every=3, max_retries=2, keep=2)
    jl = jloop.TrainLoop(
        jloop.LoopConfig(checkpoint_dir=str(tmp_path / "jax"), **cfg), jstep,
        lambda step: jnp.float32(step) / 7,
        lambda: {"w": jnp.asarray(w0), "n": jnp.int32(0)},
        inject_fault=_schedule(SCHEDULES[name]))
    tl = TrainLoop(
        LoopConfig(checkpoint_dir=str(tmp_path / "torch"), **cfg), tstep,
        lambda step: torch.tensor(np.float32(step) / 7),
        lambda: {"w": torch.from_numpy(w0.copy()),
                 "n": torch.tensor(0, dtype=torch.int32)},
        inject_fault=_schedule(SCHEDULES[name]))
    jfinal, tfinal = jl.run(), tl.run()
    assert tl.recoveries == jl.recoveries
    assert [(r.step, r.retried, r.restored) for r in tl.history] == \
        [(r.step, r.retried, r.restored) for r in jl.history]
    for jr, tr in zip(jl.history, tl.history):
        assert _bits(tr.metrics["loss"]) == _bits(jr.metrics["loss"])
    np.testing.assert_array_equal(_bits(tfinal["w"]), _bits(jfinal["w"]))
    assert int(tfinal["n"]) == int(jfinal["n"]) == 8
    assert tfinal["n"].dtype == torch.int32
    assert sorted(os.listdir(tmp_path / "torch")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_restored_leaves_take_the_state_dtypes(tmp_path):
    """A bf16 leaf (saved as raw 2-byte words) and AdamW's int32 ``step``
    come back as tensors of the live state's dtype and device, on a
    restore after a fault and on a resume; the step never sees numpy."""
    seen = []

    def step_fn(s, b):
        seen.append({k: (type(v), v.dtype) for k, v in s.items()})
        return ({"p": (s["p"].float() + b).to(torch.bfloat16),
                 "mu": s["mu"] * 0.5 + b, "step": s["step"] + 1},
                {"loss": s["p"].float().sum()})

    def init_fn():
        return {"p": torch.linspace(-2, 2, 7).to(torch.bfloat16),
                "mu": torch.zeros(7), "step": torch.zeros((),
                                                          dtype=torch.int32)}

    cfg = LoopConfig(total_steps=6, checkpoint_dir=str(tmp_path),
                     save_every=2, max_retries=1)
    loop = TrainLoop(cfg, step_fn, lambda step: 0.25, init_fn,
                     inject_fault=_faults(3, 2))
    final = loop.run()
    assert loop.recoveries == 1
    want = {"p": (torch.Tensor, torch.bfloat16),
            "mu": (torch.Tensor, torch.float32),
            "step": (torch.Tensor, torch.int32)}
    assert all(s == want for s in seen)
    _, host = load_checkpoint(str(tmp_path))
    assert host["p"].dtype == np.dtype("V2") and host["step"].shape == ()
    # a resume: the newest checkpoint as the live state's tensors
    more = TrainLoop(dataclasses.replace(cfg, total_steps=8), step_fn,
                     lambda step: 0.25, init_fn)
    resumed = more.run()
    assert more.history[0].step == 6
    assert all(s == want for s in seen)
    clean = TrainLoop(dataclasses.replace(
        cfg, total_steps=8, checkpoint_dir=str(tmp_path / "clean")),
        step_fn, lambda step: 0.25, init_fn)
    ref = clean.run()
    for k in ("p", "mu", "step"):
        assert resumed[k].dtype == ref[k].dtype
        assert torch.equal(resumed[k], ref[k]), k
    assert final["step"].dtype == torch.int32


def test_final_save_is_not_repeated(tmp_path, monkeypatch):
    """A run whose last step falls on ``save_every`` writes that step once;
    the files left are the reference's."""
    from repro_torch.checkpoint import store

    writes = []
    real = store.save_checkpoint

    def counting(d, step, tree, *, keep=3):
        writes.append(step)
        return real(d, step, tree, keep=keep)

    monkeypatch.setattr(store, "save_checkpoint", counting)
    TrainLoop(LoopConfig(total_steps=6, checkpoint_dir=str(tmp_path),
                         save_every=3),
              lambda s, b: (s + b, {}), lambda step: torch.tensor(1.0),
              lambda: torch.tensor(0.0)).run()
    assert writes == [3, 6]
    TrainLoop(LoopConfig(total_steps=7, checkpoint_dir=str(tmp_path / "b"),
                         save_every=3),
              lambda s, b: (s + b, {}), lambda step: torch.tensor(1.0),
              lambda: torch.tensor(0.0)).run()
    assert writes == [3, 6, 3, 6, 7]


def test_restore_accepts_a_step_state_pair(tmp_path):
    """The reference's ``(step, {"state": ...})`` checkpoint form."""
    save_checkpoint(str(tmp_path), 2, (2, {"state": torch.tensor(5.0)}))
    loop = TrainLoop(
        LoopConfig(total_steps=4, checkpoint_dir=str(tmp_path),
                   save_every=100, max_retries=0),
        lambda s, b: (s + b, {"v": s}), lambda step: torch.tensor(1.0),
        lambda: torch.tensor(0.0), inject_fault=_faults(3, 1))
    final = loop.run(start_state=torch.tensor(0.0), start_step=2)
    # step 2 from 0.0, then a fault at 3: the pair's state 5.0 replays
    # step 2 and runs step 3
    assert float(final) == 7.0 and loop.recoveries == 1


# -------------------------------------------------------------- straggler ----

def test_straggler_monitor_flags_outlier():
    m = StragglerMonitor(threshold=2.0, warmup_steps=2)
    for i in range(5):
        assert not m.observe(i, 0.1)
    assert m.observe(5, 0.5)
    assert not m.unhealthy
    assert m.observe(6, 0.5) and m.observe(7, 0.5)
    assert m.unhealthy


def test_straggler_ewma_excludes_outliers():
    m = StragglerMonitor(threshold=2.0, warmup_steps=1)
    m.observe(0, 0.1)
    m.observe(1, 10.0)   # flagged; must not poison the EWMA
    assert m.ewma == pytest.approx(0.1)


def test_straggler_events_match_jax():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=200, deadline=None)
    @hyp.given(st.lists(st.floats(1e-4, 10.0), max_size=60),
               st.floats(1.1, 4.0), st.integers(0, 5),
               st.floats(0.05, 0.9))
    def check(times, threshold, warmup, alpha):
        a = StragglerMonitor(alpha=alpha, threshold=threshold,
                             warmup_steps=warmup)
        b = JMonitor(alpha=alpha, threshold=threshold, warmup_steps=warmup)
        for i, t in enumerate(times):
            assert a.observe(i, t) == b.observe(i, t)
            assert a.unhealthy == b.unhealthy
        assert a.events == b.events
        assert (a.ewma, a.seen, a.consecutive_flags) == \
            (b.ewma, b.seen, b.consecutive_flags)

    check()


# ------------------------------------------------------------ compression ----

def test_compress_roundtrip_error_bound():
    hyp = pytest.importorskip("hypothesis")

    @hyp.settings(max_examples=20, deadline=None)
    @hyp.given(hyp.strategies.integers(0, 1000))
    def check(seed):
        x = torch.randn(64, generator=torch.Generator().manual_seed(seed)) * 3
        q, s = compress_int8(x)
        err = (decompress_int8(q, s) - x).abs()
        assert float(err.max()) <= float(s) / 2 + 1e-6   # half a step

    check()


def test_error_feedback_reduces_bias():
    """With error feedback the sum of the quantized stream follows the sum
    of the true one (the residual stays bounded)."""
    g = torch.full((8,), 0.01)
    ef = init_error_feedback({"g": g})
    acc = np.zeros(8)
    for _ in range(100):
        qt, ef = compress_with_feedback({"g": g}, ef)
        q, s = qt["g"]
        acc += decompress_int8(q, s).numpy()
    np.testing.assert_allclose(acc, np.full(8, 1.0), rtol=0.05)


def _compress_inputs():
    rng = np.random.default_rng(11)
    cases = {f"normal_{i}_{scale:g}": (rng.standard_normal(
        int(rng.integers(1, 5000))) * scale).astype(np.float32)
        for i, scale in enumerate((1e-6, 1e-3, 1.0, 10.0, 1e4))}
    cases["zeros"] = np.zeros((3, 4), np.float32)
    cases["neg_zero"] = np.array([-0.0, 0.0], np.float32)
    # max 127 -> scale 1: every x / scale exact, the .5 ties to even
    cases["ties"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                              -126.5, 3.5, 4.5], np.float32)
    cases["tiny"] = np.array([1e-38, -3e-39, 0.0], np.float32)
    cases["matrix"] = rng.standard_normal((64, 33)).astype(np.float32)
    return cases


@pytest.mark.parametrize("name", sorted(_compress_inputs()))
def test_compress_int8_bitwise_jax(name):
    x = _compress_inputs()[name]
    q, s = compress_int8(torch.from_numpy(x))
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == x.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _bits(s) == _bits(js)
    np.testing.assert_array_equal(
        _bits(decompress_int8(q, s)), _bits(jcomp.decompress_int8(jq, js)))


def test_compress_int8_bf16_input():
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q, s = compress_int8(xb)
    jq, js = jcomp.compress_int8(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _bits(s) == _bits(js)
    out = decompress_int8(q, s, torch.bfloat16)
    jout = jcomp.decompress_int8(jq, js, jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))


def test_compress_with_feedback_matches_jax_for_100_steps():
    """A tree of three leaves over 100 steps of changing gradients: the
    pairs and the residuals bitwise at every step."""
    rng = np.random.default_rng(5)
    shapes = {"a": (17,), "b": {"c": (4, 6), "d": (3,)}}

    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        return (rng.standard_normal(shape) * rng.uniform(1e-4, 3)).astype(
            np.float32)

    grads0 = draw(shapes)
    ef = init_error_feedback(jax.tree.map(torch.from_numpy, grads0))
    jef = jcomp.init_error_feedback(jax.tree.map(jnp.asarray, grads0))
    for _ in range(100):
        g = draw(shapes)
        qt, ef = compress_with_feedback(jax.tree.map(torch.from_numpy, g), ef)
        jqt, jef = jcomp.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                                jef)
        for path in (("a",), ("b", "c"), ("b", "d")):
            t, j, r, jr = qt, jqt, ef["residual"], jef["residual"]
            for k in path:
                t, j, r, jr = t[k], j[k], r[k], jr[k]
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
            assert _bits(t[1]) == _bits(j[1])
            np.testing.assert_array_equal(_bits(r), _bits(jr))


def test_compressed_allreduce_spec_matches_jax():
    assert compressed_allreduce_spec(4_000_003) == \
        jcomp.compressed_allreduce_spec(4_000_003)


# ---------------------------------------------------------------- elastic ----

def test_reshard_tree_roundtrip():
    mesh = Mesh(["cpu"], ("data",))
    tree = {"w": np.arange(8.0), "b": [np.ones((2, 2))]}
    out = reshard_tree(tree, replicated_plan(mesh))
    np.testing.assert_array_equal(np.asarray(out["w"]), tree["w"])
    assert out["w"].sharding.mesh.shape["data"] == 1
    assert isinstance(out["b"], list)


def test_checkpoint_then_reshard_elasticity(tmp_path):
    """Save under one mesh, restore into another (1-device meshes with
    different axis layouts: the whole path)."""
    save_checkpoint(str(tmp_path), 1,
                    {"w": torch.arange(16.0).reshape(4, 4)})
    _, host_tree = load_checkpoint(str(tmp_path))
    mesh2 = Mesh([["cpu"]], ("data", "model"))
    out = reshard_tree(host_tree, replicated_plan(mesh2))
    np.testing.assert_array_equal(np.asarray(out["w"]),
                                  np.arange(16.0).reshape(4, 4))


MESH22 = (("data", "model"), [["cpu"] * 2] * 2)


def _spec(path):
    """Split ``embed``'s rows over ``data``, ``w``'s columns over both
    axes, replicate the rest."""
    if path == ("params", "embed"):
        return ("data",)
    if path == ("params", "w"):
        return (None, ("data", "model"))
    return ()


def test_reshard_2x2_tiles_and_gather_bitwise(tmp_path):
    """A JAX checkpoint (a bf16 leaf, an int32 step) restored by the port
    onto a 2x2 mesh of the host: every tile on its device with its block,
    and the logical arrays back bit for bit."""
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((12, 4)).astype(np.float32)
    w = rng.standard_normal((3, 8)).astype(np.float32)
    jax_save(str(tmp_path), 5, {
        "params": {"embed": jnp.asarray(embed).astype(jnp.bfloat16),
                   "w": jnp.asarray(w)},
        "step": jnp.int32(5)})
    step, host = load_checkpoint(str(tmp_path))
    assert step == 5
    mesh = Mesh(MESH22[1], MESH22[0])
    out = reshard_tree(host, ElasticPlan(mesh, _spec))
    e = out["params"]["embed"]
    assert isinstance(e, ShardedLeaf) and e.dtype == torch.bfloat16
    assert e.sharding.mesh is mesh and e.sharding.spec == ("data",)
    want_e = torch.from_numpy(embed).to(torch.bfloat16)
    for (i, j), tile in np.ndenumerate(e.tiles):
        assert tile.device == mesh.devices[i, j]
        assert torch.equal(tile, want_e[6 * i:6 * i + 6])
    for (i, j), tile in np.ndenumerate(out["params"]["w"].tiles):
        k = 2 * i + j
        assert torch.equal(tile, torch.from_numpy(w)[:, 2 * k:2 * k + 2])
    for tile in out["step"].tiles.reshape(-1):
        assert tile.shape == () and int(tile) == 5
    # tiles own their memory
    tiles = e.tiles.reshape(-1)
    assert len({t.untyped_storage().data_ptr() for t in tiles}) == 4
    back = gather_tree(out)
    assert torch.equal(back["params"]["embed"], want_e)
    assert torch.equal(back["params"]["w"], torch.from_numpy(w))
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 5
    np.testing.assert_array_equal(
        np.asarray(out["params"]["embed"]).view(np.uint16),
        np.asarray(host["params"]["embed"]).view(np.uint16))


def test_place_refuses_bad_specs():
    mesh = Mesh(MESH22[1], MESH22[0])
    x = torch.arange(6.0).reshape(3, 2)
    with pytest.raises(ValueError, match="does not split"):
        place(x, NamedSharding(mesh, ("data",)))
    with pytest.raises(ValueError, match="not in mesh axes"):
        place(x, NamedSharding(mesh, ("rows",)))
    with pytest.raises(ValueError, match="splits two dims"):
        place(x, NamedSharding(mesh, ("data", "data")))
    with pytest.raises(ValueError, match="more entries"):
        place(x, NamedSharding(mesh, (None, None, None)))
    assert torch.equal(place(x, NamedSharding(mesh, (None, "model"))
                             ).gather(), x)
