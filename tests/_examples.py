"""Shared helpers of the example parity tests
(``tests/test_torch_example_*.py``): load a reference example
(``examples/<name>.py``) and its port (``examples_torch/<name>.py``),
compare what they print, and classify a dense-sampler difference between
them.

What both print is compared line by line once the host timings are
masked (``[0.15s]``, ``in 0.54 ms``, ``(944826 preds/s)``) and numpy's
scalar reprs (``np.int32(43)``) are read as their values.
"""
import importlib
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TIMING = re.compile(r"\d+(\.\d+)?\s?(s|ms)\b|\(\d+ preds/s\)")
_NP_SCALAR = re.compile(r"np\.(?:int|float|uint)\d+\(([^)]*)\)")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one CPU thread for a test file (imported there)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_example(name: str):
    """``examples/<name>.py`` as a fresh module (the reference's examples
    are scripts, not a package)."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name: str):
    """``examples_torch.<name>``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(f"examples_torch.{name}")


def masked(text: str) -> list:
    """The printed lines with host timings masked and numpy scalar reprs
    read as their values."""
    return [_TIMING.sub("<t>", _NP_SCALAR.sub(r"\1", line))
            for line in text.splitlines()]


def dense_near_ties(jgraph, graph, model: str, *, seed: int, batch: int,
                    theta: int, stable: bool = False) -> dict:
    """The first ``theta // batch`` batches of an engine's dense sampler
    (the key chain of ``IMMConfig.seed``), run by the reference and the
    port from the same keys, every row on which they differ traced to its
    first differing BFS step and classified by
    `repro_torch.core.ties.classify_runs`.  The summed report (``rows``,
    ``cells``, ``ties``, ``faults``)."""
    import jax.numpy as jnp

    from repro.core import sampler as jsampler
    from repro_torch import prng
    from repro_torch.core import sampler, ties

    jl = jnp.asarray(jsampler.logq_from_probs(
        jgraph, jsampler.get_model(model).edge_probs(jgraph)))
    pl = sampler.logq_from_probs(graph, sampler._edge_probs(
        sampler.get_model(model), graph))
    total = {"rows": 0, "cells": 0, "ties": 0, "faults": []}
    key = prng.PRNGKey(seed)
    for _ in range(theta // batch):
        key, sub = prng.split(key)

        def run_ref(t, sub=sub):
            return np.asarray(jsampler._dense_loop(
                jnp.asarray(sub), jl, batch=batch, max_steps=t,
                stable=stable)[0])

        def run_port(t, sub=sub):
            return sampler._dense_loop(sub, pl, batch=batch, max_steps=t,
                                       stable=stable)[0].numpy()

        def coins(t, sub=sub):
            return sampler.dense_coins(sub, t, batch=batch, n_nodes=graph.n,
                                       stable=stable).numpy()

        roots = sampler._dense_loop(sub, pl, batch=batch, max_steps=1,
                                    stable=stable)[2].numpy()
        rep = ties.classify_runs(run_ref, run_port, coins, pl.numpy(), roots,
                                 max_steps=graph.n)
        for k in ("rows", "cells", "ties", "faults"):
            total[k] += rep[k]
    return total


def same_or_near_ties(jax_lines, port_lines, classify) -> None:
    """The dense contract: the two examples printed the same lines, or
    ``classify()`` (a `dense_near_ties` report) finds rows on which the
    samplers differ and every such difference a near-tie."""
    if port_lines == jax_lines:
        return
    rep = classify()
    assert rep["rows"] > 0 and rep["faults"] == [], (
        rep, [(a, b) for a, b in zip(jax_lines, port_lines) if a != b])
