"""The port's ``fm_interaction`` (``repro_torch.kernels.fm_interaction``)
against the JAX package's reference and its Pallas kernel in interpret
mode, against the explicit pairwise sum, and against a numpy float32
emulation of the fixed order of summation that is the kernel's contract.

Tolerance against JAX: the sum-square trick subtracts two nearly equal
sums, so a relative bound on the result is wrong (at the model's init
scale two orders of summation can differ by far more than float32's
epsilon of the result).  The bound is ``|port - jax| <= 4e-6 * (mag + 1e-30)`` with ``mag = 0.5 *
sum_k (s_k**2 + sum_f v_fk**2)`` in float64: about 30 float32 roundings of
terms no larger than ``mag``.  bf16 inputs are read as float32 by both
sides, so the same bound holds with the reference fed the same
bf16-rounded values.  Gradients: ``|port - jax| <= 1e-6 * |g_b| * (sum_f
|v_bfk| + 1e-30)``, the same reasoning for ``s - v``.  Within the port
the plain version equals the numpy emulation bit for bit (and the CUDA
kernel the plain version: ``tests/test_torch_fm_cuda.py``, on the card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import fm_interaction as fmk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REL = 4e-6
SHAPES = [(32, 39, 10), (100, 8, 4), (1025, 16, 8)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, scale, dtype, seed=0):
    """``(torch tensor, float32 numpy of the same values)``: normal *
    scale from a numpy seed, rounded to ``dtype``."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, t.to(torch.float32).numpy()


def _mag(v32):
    v = v32.astype(np.float64)
    s = v.sum(axis=1)
    return 0.5 * (s * s + (v * v).sum(axis=1)).sum(axis=-1)


def _emulate(v32):
    """The fixed order in numpy float32, one rounding per operation."""
    B, F, K = v32.shape
    s = np.zeros((B, K), np.float32)
    s2 = np.zeros((B, K), np.float32)
    for f in range(F):
        x = v32[:, f]
        s = s + x
        s2 = s2 + x * x
    t = (s * s - s2) * np.float32(0.5)
    out = np.zeros(B, np.float32)
    for k in range(K):
        out = out + t[:, k]
    return out


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("B,F,K", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.01, 0.3])
def test_plain_matches_jax_reference_and_pallas(B, F, K, dtype, scale):
    t, v32 = _inputs((B, F, K), scale, dtype, seed=B + F)
    got = fmk.fm_interaction_plain(t).numpy()
    jv = jnp.asarray(v32).astype(getattr(jnp, dtype))
    want_ref = np.asarray(jref.fm_interaction_ref(jv.astype(jnp.float32)))
    want_pallas = np.asarray(jops.fm_interaction(jv, interpret=True))
    bound = REL * (_mag(v32) + 1e-30)
    assert got.dtype == np.float32 and got.shape == (B,)
    for want in (want_ref, want_pallas):
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("B,F,K", [(16, 6, 4), (8, 39, 10), (3, 2, 1)])
def test_plain_matches_explicit_pairwise(B, F, K):
    t, v32 = _inputs((B, F, K), 0.5, "float32", seed=F)
    v = v32.astype(np.float64)
    inner = np.einsum("bik,bjk->bij", v, v)
    iu = np.triu_indices(F, k=1)
    want = inner[:, iu[0], iu[1]].sum(-1)
    got = fmk.fm_interaction_plain(t).numpy().astype(np.float64)
    assert (np.abs(got - want) <= REL * (_mag(v32) + 1e-30)).all()


@pytest.mark.parametrize("B,F,K", [(1, 1, 1), (7, 39, 10), (300, 6, 4),
                                   (65, 16, 8), (5, 3, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_is_the_fixed_order_bitwise(B, F, K, dtype):
    t, v32 = _inputs((B, F, K), 0.01, dtype, seed=K)
    v32[0, 0] = -0.0                     # signed zeros follow the order
    t[0, 0] = -0.0
    np.testing.assert_array_equal(_bits(fmk.fm_interaction_plain(t)),
                                  _bits(_emulate(v32)))


@pytest.mark.parametrize("B,F,K", [(32, 39, 10), (100, 8, 4)])
@pytest.mark.parametrize("scale", [0.01, 0.3])
def test_backward_matches_jax_grad(B, F, K, scale):
    t, v32 = _inputs((B, F, K), scale, "float32", seed=7)
    c = np.random.default_rng(8).standard_normal(B).astype(np.float32)
    v = t.clone().requires_grad_()
    (ops.fm_interaction(v) * torch.from_numpy(c)).sum().backward()
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        jref.fm_interaction_ref(x) * c))(jnp.asarray(v32)))
    bound = 1e-6 * np.abs(c)[:, None, None] * (
        np.abs(v32).sum(axis=1, keepdims=True) + 1e-30)
    err = np.abs(v.grad.numpy() - want)
    assert (err <= bound).all(), float((err / bound).max())


def test_backward_keeps_the_input_dtype():
    t, _ = _inputs((4, 5, 3), 0.3, "bfloat16")
    v = t.clone().requires_grad_()
    ops.fm_interaction(v).sum().backward()
    assert v.grad.dtype == torch.bfloat16
    want = (fmk.field_sum(t.float())[:, None, :] - t.float()).to(
        torch.bfloat16)
    assert torch.equal(v.grad, want)


def test_dispatch_counts_and_refuses():
    t, _ = _inputs((3, 4, 2), 0.3, "float32")
    obs.reset()
    obs.enable()
    try:
        before = dict(ops.launch_counts())
        ops.fm_interaction(t)
        snap = obs.snapshot()["counters"]
    finally:
        obs.reset()
    assert snap["kernels.dispatch{impl=reference,kernel=fm_interaction}"] == 1
    assert ops.launch_counts() == before            # no launch on the cpu
    with pytest.raises(ValueError, match="operands on"):
        ops.fm_interaction(torch.zeros((2, 3, 4), device="meta"))
    with pytest.raises(ValueError, match=r"\(B, F, K\)"):
        fmk.fm_interaction_cuda(t[0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fmk.fm_interaction_cuda(t.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fmk.fm_interaction_plain(t.to(torch.int32))
    with pytest.raises(ValueError, match="does not fit"):
        fmk.fm_interaction_cuda(torch.zeros((1, 2000, 8)))
