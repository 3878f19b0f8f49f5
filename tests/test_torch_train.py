"""The port's training entry point and token stream
(``repro_torch.launch.train``, ``repro_torch.data``) against the JAX
package, and the reference's own tests of them ported
(``tests/test_configs_and_data.py``,
``tests/test_sharded_and_integration.py``).

- ``TokenPipeline`` is numpy in both packages: bitwise.
- ``make_step`` from the same weights (the reference's ``init_lm``
  carried across) on the same batches for 5 steps: the loss and the
  gradient norm within ``1e-4 * (1 + |ref|)`` (the f32 LM tolerance,
  PERF.md section 2: the same arithmetic summed in other orders);
  parameters and moments after the steps within ``tests/test_torch_optim.py``'s
  tolerance for a training run (rtol 1e-4, atol 1e-5).
- A run restored from a checkpoint after its retries are used up replays
  to the uninterrupted run's final state bit for bit (the embedding's
  gradient sums repeated tokens in a fixed order).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import (  # noqa: E402
    Prefetcher, TokenPipeline, synthetic_token_batches,
)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_remesh(monkeypatch):
    """``train_lm``'s loops without the straggler's re-mesh: on a host
    shared with other test workers three steps in a row can take twice
    the average (the re-mesh path has its own tests in
    ``tests/test_torch_runtime.py``)."""
    from repro_torch.runtime.loop import LoopConfig

    monkeypatch.setattr(train, "LoopConfig", lambda **kw: LoopConfig(
        straggler_threshold=float("inf"), **kw))


# ------------------------------------------------------------------ data ----

def test_token_pipeline_deterministic_and_sharded():
    p0 = TokenPipeline(vocab=64, batch=4, seq_len=16, seed=1, shard=0)
    p1 = TokenPipeline(vocab=64, batch=4, seq_len=16, seed=1, shard=1)
    t0a, l0a = p0.batch_at(5)
    t0b, _ = p0.batch_at(5)
    t1, _ = p1.batch_at(5)
    np.testing.assert_array_equal(t0a, t0b)        # deterministic
    assert (t0a != t1).any()                       # shards differ
    assert (l0a[:, :-1] == t0a[:, 1:]).all()       # labels shifted
    assert (l0a[:, -1] == -1).all()


@pytest.mark.parametrize("vocab,batch,seq,seed,step,shard", [
    (64, 4, 16, 0, 0, 0), (64, 4, 16, 1, 5, 1), (512, 3, 33, 7, 11, 2),
    (32_000, 8, 256, 0, 199, 0), (151_936, 2, 300, 3, 4, 1),
    (151_936, 4, 64, 0, 0, 3)])
def test_token_batches_equal_the_reference(vocab, batch, seq, seed, step,
                                           shard):
    got = TokenPipeline(vocab=vocab, batch=batch, seq_len=seq, seed=seed,
                        shard=shard, num_shards=4).batch_at(step)
    want = jtokens.TokenPipeline(vocab=vocab, batch=batch, seq_len=seq,
                                 seed=seed, shard=shard,
                                 num_shards=4).batch_at(step)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_synthetic_token_batches_and_prefetch_equal_the_reference():
    got = list(Prefetcher(synthetic_token_batches(100, 2, 8, 5, seed=3,
                                                  shard=1), depth=2))
    want = list(jtokens.synthetic_token_batches(100, 2, 8, 5, seed=3,
                                                shard=1))
    assert len(got) == len(want) == 5
    for (gt, gl), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


# ------------------------------------------------------------- make_step ----

#: XLA's cheaper compile (the reference's arithmetic either way)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
STEPS, BATCH, SEQ = 5, 2, 24


def _schedules(steps):
    """(name, port schedule, reference schedule): train_lm's two."""
    def cos(mod):
        return lambda s: mod.cosine_schedule(s, warmup=steps // 10 + 1,
                                             total=steps)

    def wsd(mod):
        return lambda s: mod.wsd_schedule(
            s, warmup=steps // 10 + 1, stable=int(steps * 0.6),
            decay=max(int(steps * 0.3), 1))

    return {"cosine": (cos(schedule), cos(jsched)),
            "wsd": (wsd(schedule), wsd(jsched))}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("sched", ["cosine", "wsd"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "moonshot-v1-16b-a3b"])
def test_make_step_matches_jax(arch, sched):
    jcfg = jax_arch(arch).smoke_config
    cfg = get_arch(arch).smoke_config
    jp = jax.jit(lambda k: jt.init_lm(k, jcfg)).lower(
        jax.random.PRNGKey(0)).compile(compiler_options=FAST)(
        jax.random.PRNGKey(0))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    port_sched, ref_sched = _schedules(STEPS)[sched]
    opt, jopt = AdamWConfig(lr=1e-3), JAdamWConfig(lr=1e-3)
    step_fn = train.make_step(cfg, opt, port_sched)
    jstep_fn = jtrain.make_step(jcfg, jopt, ref_sched)
    state = {"params": params, "opt": adamw_init(params, opt)}
    jstate = {"params": jp, "opt": jadamw_init(jp, jopt)}
    pipe = TokenPipeline(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ, seed=2)
    compiled = None
    for step in range(STEPS):
        t, lab = pipe.batch_at(step)
        jbatch = (jnp.asarray(t), jnp.asarray(lab))
        if compiled is None:
            compiled = jstep_fn.lower(jstate, jbatch).compile(
                compiler_options=FAST)
        before = state
        state, m = step_fn(state, (torch.from_numpy(t).long(),
                                   torch.from_numpy(lab).long()))
        jstate, jm = compiled(jstate, jbatch)
        for k in ("loss", "grad_norm"):
            got, want = float(m[k]), float(jm[k])
            assert abs(got - want) <= TOL * (1 + abs(want)), (step, k, got,
                                                               want)
        assert state["params"] is not before["params"]
    assert int(state["opt"]["step"]) == STEPS
    assert state["opt"]["step"].dtype == torch.int32
    for path, leaf in tree_leaves(state["params"]):
        np.testing.assert_allclose(_np(leaf), _np(_at(jstate["params"], path)),
                                   rtol=1e-4, atol=1e-5, err_msg=str(path))
        for m in ("mu", "nu"):
            np.testing.assert_allclose(
                _np(_at(state["opt"][m], path)),
                _np(_at(jstate["opt"][m], path)), rtol=1e-4, atol=1e-5,
                err_msg=f"{m} {path}")


def test_make_step_leaves_its_input_alone():
    """A retry restarts from the state the step was given: the step
    returns new tensors and changes none of its input's."""
    cfg = get_arch("qwen1.5-0.5b").smoke_config
    params = get_arch("qwen1.5-0.5b").init_fn(
        torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    state = {"params": params, "opt": adamw_init(params, opt)}
    before = [(p, t.clone()) for p, t in tree_leaves(state)]
    t, lab = TokenPipeline(vocab=cfg.vocab, batch=2, seq_len=16).batch_at(0)
    new, _ = train.make_step(cfg, opt, lambda s: 1.0)(
        state, (torch.from_numpy(t).long(), torch.from_numpy(lab).long()))
    for path, leaf in before:
        assert torch.equal(_at(state, path), leaf), path
        assert _at(new, path) is not _at(state, path), path
    assert int(new["opt"]["step"]) == 1
    assert not torch.equal(new["params"]["lm_head"], params["lm_head"])


# -------------------------------------------------------------- the loop ----

def _tokens_loop(tmp, *, inject=None, steps=6):
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").smoke_config,
                              vocab=4096)
    return train.lm_loop(cfg, steps=steps, batch=4, seq_len=64,
                         checkpoint_dir=str(tmp), save_every=3, seed=1,
                         device="cpu", inject_fault=inject)


def test_restore_and_replay_is_bitwise(tmp_path, no_remesh):
    """Run B's step 4 fails until its two retries are used up; it
    restores step 3's checkpoint and replays: the final params, moments
    and step equal run A's bit for bit."""
    a = _tokens_loop(tmp_path / "a")
    state_a = a.run()
    left = {"n": 3}

    def inject(step, retries):
        if step == 4 and left["n"]:
            left["n"] -= 1
            return True
        return False

    b = _tokens_loop(tmp_path / "b", inject=inject)
    state_b = b.run()
    assert a.recoveries == 0 and b.recoveries == 1
    assert [(r.step, r.restored) for r in b.history] == \
        [(s, s == 4) for s in range(6)]
    leaves = tree_leaves(state_b)
    assert len(leaves) == len(tree_leaves(state_a))
    for path, leaf in leaves:
        assert leaf.dtype == _at(state_a, path).dtype, path
        assert torch.equal(leaf, _at(state_a, path)), path
    assert [float(r.metrics["loss"]) for r in b.history] == \
        [float(r.metrics["loss"]) for r in a.history]


def test_train_loop_lm_loss_decreases(tmp_path, no_remesh):
    state, losses, loop = train.train_lm(
        "qwen1.5-0.5b", smoke=True, steps=40, batch=8, seq_len=32,
        checkpoint_dir=str(tmp_path), save_every=20, log=lambda *a: None,
        device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_resume_from_checkpoint(tmp_path, no_remesh):
    _, losses1, _ = train.train_lm(
        "qwen1.5-0.5b", smoke=True, steps=10, batch=4, seq_len=32,
        checkpoint_dir=str(tmp_path), save_every=5, log=lambda *a: None,
        device="cpu")
    # the second run resumes at step 10 and goes on to 20
    state, losses2, loop2 = train.train_lm(
        "qwen1.5-0.5b", smoke=True, steps=20, batch=4, seq_len=32,
        checkpoint_dir=str(tmp_path), save_every=5, log=lambda *a: None,
        device="cpu")
    assert loop2.history[0].step == 10
    assert len(losses2) == 10
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 20
    assert state["params"]["embed"].dtype == torch.float32


def test_minicpm_trains_on_wsd(tmp_path, no_remesh):
    """``minicpm-2b`` takes the WSD schedule: its rate at step 0 is the
    warmup's, and its loss falls."""
    _, losses, loop = train.train_lm(
        "minicpm-2b", smoke=True, steps=12, batch=4, seq_len=32,
        checkpoint_dir=str(tmp_path), save_every=50, log=lambda *a: None,
        device="cpu")
    assert len(loop.history) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_cli_on_the_host(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--steps", "3",
           "--batch", "2", "--seq-len", "16", "--checkpoint-dir",
           str(tmp_path), "--device", "cpu"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, check=True)
    assert "[train] qwen1.5-0.5b: steps=3" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["latest", "step_0000000003.npz"]


def test_train_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_lm("qwen1.5-0.5b", steps=1, checkpoint_dir=str(tmp_path),
                       log=lambda *a: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--checkpoint-dir", str(tmp_path)])
