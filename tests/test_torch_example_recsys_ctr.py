"""``examples_torch/recsys_ctr.py`` against ``examples/recsys_ctr.py`` on
the CPU.

From the reference's initial parameters (its ``init_fm(PRNGKey(0))``
carried across by ``fm_params_from_jax``) on the same click stream, the
port's first 10 training losses are within ``1e-6`` absolute of the
reference example's, the FM parity tests' loss tolerance
(``tests/test_torch_fm.py``: a mean of terms near 0.7).  The reference's
per-step losses are read where its loop converts each one with
``float``.  The example's own assertion (the last 10 losses' mean below
the first 10's) holds on the port at its defaults, from its own
initial draw as from the reference's.  The serving batches draw the
reference's ids (`repro_torch.prng.randint` is ``jax.random.randint``
bit for bit) and every logit is finite.
"""
import builtins

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _examples import jax_example, one_thread, port_example  # noqa: E402,F401
from repro.models.recsys import fm as jfm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.convert import fm_params_from_jax  # noqa: E402

LOSS_TOL = 1e-6


def test_recsys_ctr_losses_match_the_reference():
    ref = jax_example("recsys_ctr")
    floats = []

    def recording_float(x):
        floats.append(builtins.float(x))
        return floats[-1]

    ref.float = recording_float
    ref.main()
    assert len(floats) == 200
    cfg = jfm.FMConfig(n_sparse=8, embed_dim=8, vocab_per_field=500)
    params = fm_params_from_jax(jax.tree.map(
        np.asarray, jfm.init_fm(jax.random.PRNGKey(0), cfg)), device="cpu")
    got = port_example("recsys_ctr").main(device="cpu", params=params)
    assert got["steps"] == len(got["losses"]) == 200
    err = np.abs(np.array(got["losses"][:10]) - np.array(floats[:10]))
    assert (err <= LOSS_TOL).all(), err
    assert got["loss_last10"] < got["loss_first10"]


def test_recsys_ctr_learns_and_serves_from_its_own_draw():
    got = port_example("recsys_ctr").main(device="cpu")
    assert got["loss_last10"] < got["loss_first10"]
    for name, B in (("serve_p99", 512), ("serve_bulk", 8192)):
        assert got[name]["batch"] == B and got[name]["finite"]
    top = got["retrieval_cand"]["top5"]
    assert len(set(top)) == 5 and all(0 <= r < 100_000 for r in top)
    ids = prng.randint(prng.PRNGKey(2), (100_000,), 0, 8 * 500)
    want = jax.random.randint(jax.random.PRNGKey(2), (100_000,), 0, 8 * 500)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
