"""``examples_torch/gnn_node_classification.py`` against
``examples/gnn_node_classification.py`` on the CPU.

From the reference's initial parameters (its ``init_sage(PRNGKey(0))``
carried across by ``gnn_params_from_jax``) the port samples the same
seeds and neighbours (`repro_torch.prng` and the sampler are
``jax.random`` bit for bit) and its first 10 training losses are within
``1e-4 * (1 + |ref|)`` of the reference example's, the GNN parity tests'
tolerance (``tests/_gnn_ref.py``); the reference's per-step losses and
accuracies are read where its loop converts them with ``float``.  The
example's own assertion (minibatch accuracy up by more than 0.1) holds
on the port at its defaults, from its own draw as from the
reference's.
"""
import builtins

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _examples import jax_example, one_thread, port_example  # noqa: E402,F401
from _gnn_ref import TOL  # noqa: E402
from repro.models.gnn import graphsage as jsage  # noqa: E402
from repro_torch.convert import gnn_params_from_jax  # noqa: E402


def test_gnn_example_losses_match_the_reference():
    ref = jax_example("gnn_node_classification")
    floats = []

    def recording_float(x):
        floats.append(builtins.float(x))
        return floats[-1]

    ref.float = recording_float
    ref.main()
    losses = floats[0::2]                  # the loop converts loss, acc
    assert len(losses) == 150
    cfg = jsage.SageConfig(n_layers=2, d_hidden=64, d_feat=32, n_classes=5,
                           sample_sizes=(10, 5))
    params = gnn_params_from_jax(jax.tree.map(
        np.asarray, jsage.init_sage(jax.random.PRNGKey(0), cfg)),
        device="cpu")
    got = port_example("gnn_node_classification").main(device="cpu",
                                                       params=params)
    assert got["steps"] == len(got["losses"]) == 150
    want = np.array(losses[:10])
    err = np.abs(np.array(got["losses"][:10]) - want) / (1 + np.abs(want))
    assert (err <= TOL).all(), err
    assert got["acc_last10"] > got["acc_first10"] + 0.1
