"""``examples_torch/train_lm.py`` against ``examples/train_lm.py`` on the
CPU.

``--tiny`` (Qwen1.5-0.5B's smoke config, batch 8 x 64) for a few
``--steps`` on both sides, each in a checkpoint directory of its own:
from the reference's initial parameters (``init_lm(PRNGKey(0))``, as its
``train_lm`` draws them, carried across by ``lm_params_from_jax``) on
the same token stream, the port's first 10 losses are within ``1e-4 *
(1 + |ref|)`` of the reference example's (the f32 LM tolerance of
``tests/test_torch_train.py``); the reference's losses are read from
what its ``train_lm`` returns.  The example's own assertion (the last
10 losses below the first 10) holds on the port from its own draw too.
``register_100m`` gives the reference example's ``qwen-100m`` config,
field for field, and registering it twice in one process is fine.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _examples import jax_example, one_thread, port_example  # noqa: E402,F401
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402

TOL = 1e-4
STEPS = 12


def test_train_lm_tiny_losses_match_the_reference(tmp_path, monkeypatch):
    ref = jax_example("train_lm")
    runs = []

    def recording_train_lm(*a, **kw):
        runs.append(ref_train_lm(*a, **kw))
        return runs[-1]

    ref_train_lm, ref.train_lm = ref.train_lm, recording_train_lm
    monkeypatch.setattr(sys, "argv", [
        "train_lm.py", "--tiny", "--steps", str(STEPS),
        "--checkpoint-dir", str(tmp_path / "jax")])
    ref.main()
    (_, want, _), = runs
    jcfg = jax_arch("qwen1.5-0.5b").smoke_config
    params = lm_params_from_jax(jax.tree.map(
        np.asarray, jt.init_lm(jax.random.PRNGKey(0), jcfg)), device="cpu")
    got = port_example("train_lm").main(
        ["--tiny", "--steps", str(STEPS), "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "port")], params=params)
    assert got["arch"] == "qwen1.5-0.5b"
    assert got["steps"] == len(got["losses"]) == len(want) == STEPS
    w = np.array(want[:10])
    err = np.abs(np.array(got["losses"][:10]) - w) / (1 + np.abs(w))
    assert (err <= TOL).all(), err
    assert got["last10"] < got["first10"]


def test_train_lm_tiny_learns_from_its_own_draw(tmp_path):
    got = port_example("train_lm").main(
        ["--tiny", "--steps", str(STEPS), "--device", "cpu",
         "--checkpoint-dir", str(tmp_path)])
    assert got["steps"] == STEPS and got["last10"] < got["first10"]
    assert got["checkpoint_dir"] == str(tmp_path)


def test_register_100m_is_the_reference_config():
    want = jax_example("train_lm").register_100m()
    mod = port_example("train_lm")
    got = mod.register_100m()
    assert mod.register_100m().config == got.config      # twice is fine
    assert get_arch("qwen-100m").config == got.config
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert (got.arch_id, got.family, got.source) == (
        want.arch_id, want.family, want.source)
    assert got.smoke_config == got.config
    assert sorted(got.shapes) == sorted(want.shapes)
    assert got.config.param_count() == want.config.param_count()
