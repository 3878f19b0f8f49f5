"""Out-of-range and negative ids in the port's gathers, against the JAX
package: the reference gathers with ``jnp.take``'s default mode
(``fill``), so an id in ``[-n, 0)`` wraps and any other id outside
``[0, n)`` reads a NaN row (jax 0.9: ``jnp.take(a, [0, 3, 4, -1, -5])``
on 4 rows gives rows 0, 3, NaN, 3, NaN).  The port matches it with
``models.common.take_index`` / ``take_rows`` in the FM gathers and the LM
embedding, so a bad id gives NaN in its own request where the reference
does and the rest of the batch is served as before.

Every cell runs one mixed batch (valid, wrapped and out-of-range ids) and
holds the NaN positions equal to the reference's and every finite value
to the tolerance of the file that tests the same function with valid ids
(``tests/test_torch_fm.py``, ``tests/test_torch_lm.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.recsys import fm as jfm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    fm_params_from_jax, lm_params_from_jax,
)
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import take_index, take_rows  # noqa: E402
from repro_torch.models.recsys import fm  # noqa: E402

SMOKE = get_arch("fm").smoke_config
ROADMAP_C = fm.FMConfig(n_sparse=3, embed_dim=4, vocab_per_field=8)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_nans_and_close(got, want, *, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(11,), (11, 5)])
def test_take_rows_is_jnp_take(shape, dtype):
    table = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)
    ids = np.array([[0, 10, 11, -1, -11, -12, 25], [3, -30, 7, 11, 2, 0, 9]])
    want = jnp.take(jnp.asarray(table, getattr(jnp, dtype)),
                    jnp.asarray(ids), axis=0)
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    got = take_rows(t, *take_index(torch.from_numpy(ids), shape[0]))
    assert got.dtype == t.dtype and tuple(got.shape) == tuple(want.shape)
    _same_nans_and_close(got.float().numpy(), np.asarray(want, np.float32),
                         rtol=0, atol=0)


def _fm_pair(cfg, seed=0):
    """(jax params, port params) as ``tests/test_torch_fm.py`` makes them:
    ``init_fm``'s table, ``w ~ N(0, 0.1)``, ``b = 0.3``."""
    jp = jfm.init_fm(jax.random.PRNGKey(seed),
                     jfm.FMConfig(**dataclasses.asdict(cfg)))
    rng = np.random.default_rng(seed)
    tree = {"v": np.asarray(jp["v"]),
            "w": (rng.standard_normal(cfg.total_rows) * 0.1
                  ).astype(np.float32),
            "b": np.float32(0.3)}
    return ({k: jnp.asarray(a) for k, a in tree.items()},
            fm_params_from_jax(tree, device="cpu"))


def _mixed_ids(cfg, B, seed):
    """Valid ids with, in a few rows, a wrapped negative id, an id past the
    table and an id below ``-total_rows``."""
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_per_field, (B, cfg.n_sparse)).astype(np.int32)
    ids[1, 0] = -1                              # row -1 + 0: wraps
    ids[2, -1] = cfg.vocab_per_field            # past the table
    ids[3, 0] = -cfg.total_rows - 1             # below -n
    return ids


@pytest.mark.parametrize("name", ["smoke", "roadmap_c"])
def test_fm_logits_with_out_of_range_ids(name):
    cfg = {"smoke": SMOKE, "roadmap_c": ROADMAP_C}[name]
    jp, tp = _fm_pair(cfg)
    if name == "roadmap_c":
        ids = np.array([[0, 1, 2], [7, 7, 8], [-1, 2, 3], [-25, 0, 1]],
                       np.int32)
    else:
        ids = _mixed_ids(cfg, 64, seed=1)
    jcfg = jfm.FMConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jfm.fm_logits(jp, jcfg, jnp.asarray(ids)))
    got = fm.fm_logits(tp, cfg, torch.from_numpy(ids)).numpy()
    assert np.isnan(want).sum() == 2
    # finite logits are O(1): 4e-6 of the terms' magnitudes, as in
    # tests/test_torch_fm.py, is within 1e-5
    _same_nans_and_close(got, want, rtol=0, atol=1e-5)


def test_fm_retrieval_with_out_of_range_rows():
    cfg = SMOKE
    jp, tp = _fm_pair(cfg)
    jcfg = jfm.FMConfig(**dataclasses.asdict(cfg))
    n = cfg.total_rows
    cand = np.array([0, n - 1, n, -1, -n, -n - 1, 5, 2 * n], np.int32)
    for user in (np.array([3, 7, 11, 19], np.int32),
                 np.array([3, 7, 11, n], np.int32)):
        want = np.asarray(jfm.fm_retrieval_scores(
            jp, jcfg, jnp.asarray(user), jnp.asarray(cand)))
        got = fm.fm_retrieval_scores(tp, cfg, torch.from_numpy(user),
                                     torch.from_numpy(cand)).numpy()
        _same_nans_and_close(got, want, rtol=0, atol=1e-5)
    assert np.isnan(want).all()            # a user field past the table


def test_fm_loss_and_grads_with_one_out_of_range_id():
    """One id past the table: the reference's loss is NaN, and jax.grad
    gives NaN to the table rows the bad request read and to ``b``, and
    nothing for the bad id itself (the port's gather reads row
    ``id % n`` there, and its gradient must not reach that row)."""
    cfg = SMOKE
    jp, tp = _fm_pair(cfg)
    jcfg = jfm.FMConfig(**dataclasses.asdict(cfg))
    ids = np.random.default_rng(3).integers(
        0, cfg.vocab_per_field, (64, cfg.n_sparse)).astype(np.int32)
    ids[5, -1] = cfg.vocab_per_field
    labels = (np.random.default_rng(4).random(64) < 0.5).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(jfm.fm_loss)(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(labels))
    loss, grads = fm.fm_value_and_grad(tp, cfg, torch.from_numpy(ids),
                                       torch.from_numpy(labels))
    assert np.isnan(float(jloss)) and np.isnan(float(loss))
    for k in ("v", "w", "b"):
        want = np.asarray(jgrads[k])
        assert np.isnan(want).any()
        fin = want[~np.isnan(want)]
        scale = np.abs(fin).max() if fin.size else 0.0
        _same_nans_and_close(grads[k].numpy(), want, rtol=1e-5,
                             atol=1e-6 * scale)
    # the bad row id is total_rows, read as row 0, which no request of
    # this batch reads: its gradient stays finite in both
    assert not np.isnan(np.asarray(jgrads["v"])[0]).any()
    assert not np.isnan(grads["v"][0].numpy()).any()


def _lm_pair():
    arch = "qwen1.5-0.5b"
    jcfg, cfg = jax_arch(arch).smoke_config, get_arch(arch).smoke_config
    jp = jt.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")


def test_lm_prefill_and_decode_with_an_out_of_range_token():
    """A token equal to ``vocab`` in row 1: its logits are NaN in prefill
    and in the decode step that reads it, as the reference's; rows 0 and 2
    hold the tolerances of tests/test_torch_lm.py (f32 logits and caches
    rtol 1e-4, atol 1e-5; equal greedy tokens; decode caches within one
    bf16 step)."""
    jcfg, cfg, jp, tp = _lm_pair()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 12)).astype(
        np.int32)
    toks[1, 5] = cfg.vocab
    toks[2, 3] = -1                             # wraps to vocab - 1
    jl, jc = jt.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tc = tt.prefill(tp, cfg, torch.from_numpy(toks))
    assert np.isnan(np.asarray(jl)).any(-1).tolist() == [False, True, False]
    _same_nans_and_close(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    for name in ("k", "v"):
        _same_nans_and_close(tc[name].numpy(), jc[name], rtol=1e-4,
                             atol=1e-5)

    jcache, tcache = jt.init_kv_cache(jcfg, 3, 8), tt.init_kv_cache(cfg, 3, 8)
    dec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    nan_rows = []
    for step in ([[4], [9], [2]], [[1], [cfg.vocab], [-1]], [[7], [7], [7]]):
        t = np.asarray(step, np.int32)
        jn, jcache = dec(jp, jcache, jnp.asarray(t))
        logits, tcache = tt.decode_logits(tp, cfg, tcache,
                                          torch.from_numpy(t))
        nan_rows.append(torch.isnan(logits[:, 0]).any(-1).tolist())
        tn = torch.argmax(logits, dim=-1).to(torch.int32)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        for name in ("k", "v"):
            got = tcache[name].float().numpy()
            want = np.asarray(jcache[name], np.float32)
            assert np.array_equal(np.isnan(got), np.isnan(want))
            assert _bf16_steps(got, want) <= 1
    # row 1's logits are NaN from the step that read the bad token on
    # (its cache slot is NaN), the other rows' never
    assert nan_rows == [[False, False, False], [False, True, False],
                        [False, True, False]]


def _bf16_steps(a, b):
    """Max distance in bf16 steps between the finite entries of two
    bf16-valued arrays (``tests/test_torch_lm.py``'s ``_bf16_ulps``)."""
    ok = np.isfinite(b)

    def ordered(x):
        bits = (x[ok].view(np.int32) >> 16).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())
