"""Fault-tolerant training loop: checkpoint and restart, retry, straggler
watch (``repro.runtime.loop``).

The loop owns nothing model-specific: it drives a ``step_fn(state, batch)
-> (state, metrics)``, a batch source ``batch_fn(step) -> batch`` (a pure
function of the step, so a restart needs no loader state) and a
`repro_torch.checkpoint.CheckpointManager`.

Failure handling:
  * a step that raises (out of memory, a lost peer, an injected fault) is
    retried up to ``max_retries`` times from the last good state, so
    ``step_fn`` must leave its input state as it is;
  * when the retries are used up, the loop restores the newest checkpoint
    and replays forward to the failed step (batches are pure functions of
    the step and the step's arithmetic is deterministic, so the replay
    gives the same bits on the same mesh);
  * the `StragglerMonitor` flags slow steps; after three in a row the loop
    checkpoints and raises ``RemeshRequested``, so the launcher can build
    a mesh without the slow device (`repro_torch.runtime.elastic` restores
    into it).

A checkpoint loads as host numpy (`repro_torch.checkpoint.store`), so
every restored leaf is put back as a tensor of the live state's dtype on
its device before ``step_fn`` sees it (`_placed`): the state in hand
shows them on a restore after a fault, ``init_fn``'s tree on a resume.
``step_time`` is the device's: the clock stops after a sync on the
metrics' devices.  The final save is skipped when the periodic one has
just written the same step.

``inject_fault(step, retries) -> bool`` makes the recovery paths testable
on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager, to_tensor
from repro_torch.runtime.straggler import StragglerMonitor


class RemeshRequested(RuntimeError):
    """Raised when persistent straggling suggests a sick device; the
    launcher should rebuild the mesh and resume from the checkpoint just
    written."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_dir: str
    save_every: int = 100
    keep: int = 3
    max_retries: int = 2
    log_every: int = 10
    straggler_threshold: float = 2.0


@dataclasses.dataclass
class StepResult:
    step: int
    metrics: dict
    step_time: float
    retried: int = 0
    restored: bool = False


def _has_host_leaves(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_host_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_host_leaves(v) for v in tree)
    return isinstance(tree, (np.ndarray, np.generic))


def _like(tree, live):
    """``tree`` with every leaf whose counterpart in ``live`` is a tensor
    made a tensor of that one's dtype on its device."""
    if isinstance(live, dict):
        return {k: _like(tree[k], v) for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        out = [_like(t, v) for t, v in zip(tree, live)]
        return out if isinstance(live, list) else tuple(out)
    if isinstance(live, torch.Tensor):
        return to_tensor(tree, dtype=live.dtype, device=live.device)
    return tree


def _sync(metrics) -> None:
    """Wait for the devices the metrics' tensors live on."""
    devices = set()

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
            devices.add(x.device)

    walk(metrics)
    for dev in devices:
        torch.cuda.synchronize(dev)


class TrainLoop:
    def __init__(self, cfg: LoopConfig, step_fn: Callable,
                 batch_fn: Callable, init_fn: Callable,
                 inject_fault: Optional[Callable] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.init_fn = init_fn
        self.inject_fault = inject_fault
        self.manager = CheckpointManager(
            cfg.checkpoint_dir, save_every=cfg.save_every, keep=cfg.keep)
        self.monitor = StragglerMonitor(threshold=cfg.straggler_threshold)
        self.history: list[StepResult] = []
        self.recoveries = 0

    def _placed(self, tree, live=None):
        """A restored tree as the live state's tensors (``live``, else
        ``init_fn()``'s); a tree without host leaves as it is."""
        if not _has_host_leaves(tree):
            return tree
        return _like(tree, self.init_fn() if live is None else live)

    # -- single step with retry + restore-from-checkpoint ------------------
    def _run_step(self, step: int, state):
        retries = 0
        restored = False
        while True:
            try:
                if self.inject_fault is not None and \
                        self.inject_fault(step, retries):
                    raise RuntimeError(f"injected fault at step {step}")
                batch = self.batch_fn(step)
                t0 = time.perf_counter()
                new_state, metrics = self.step_fn(state, batch)
                _sync(metrics)
                dt = time.perf_counter() - t0
                return new_state, metrics, dt, retries, restored
            except RemeshRequested:
                raise
            except Exception:
                retries += 1
                if retries <= self.cfg.max_retries:
                    continue
                # retries used up: restore the newest checkpoint
                ck_step, tree = self.manager.restore_or_init(self.init_fn)
                if isinstance(tree, tuple) and len(tree) == 2 and \
                        isinstance(tree[1], dict) and "state" in tree[1]:
                    restored_state = tree[1]["state"]
                else:
                    restored_state = tree if ck_step else self.init_fn()
                state = self._placed(restored_state, state)
                self.recoveries += 1
                retries = 0
                restored = True
                if ck_step < step:
                    # replay forward deterministically to ``step``
                    for s in range(ck_step, step):
                        state, _ = self.step_fn(state, self.batch_fn(s))

    # -- main loop ----------------------------------------------------------
    def run(self, start_state=None, start_step: int = 0):
        if start_state is None:
            start_step, start_state = self.manager.restore_or_init(
                self.init_fn)
            start_state = self._placed(start_state)
        state = start_state
        saved = None
        for step in range(start_step, self.cfg.total_steps):
            state, metrics, dt, retried, restored = self._run_step(step, state)
            flagged = self.monitor.observe(step, dt)
            self.history.append(StepResult(step, metrics, dt, retried,
                                           restored))
            if self.manager.maybe_save(step + 1, state) is not None:
                saved = step + 1
            if flagged and self.monitor.unhealthy:
                self.manager.save(step + 1, state)
                raise RemeshRequested(
                    f"persistent straggling at step {step} "
                    f"(ewma {self.monitor.ewma:.4f}s)")
        if saved != self.cfg.total_steps:
            self.manager.save(self.cfg.total_steps, state)
        return state
