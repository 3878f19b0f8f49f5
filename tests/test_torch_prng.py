"""repro_torch.prng and the coin kernel's plain version, bitwise against
jax.random (partitionable threefry, as installed)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

KEYS = [0, 1, 42, 2**31 - 1, -1]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", KEYS)
def test_prngkey_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(got, want)


def test_split_chain_matches_jax():
    """The engine's key chain: one split per batch, reusing key 0."""
    k, jk = prng.PRNGKey(9), jax.random.PRNGKey(9)
    for _ in range(20):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        np.testing.assert_array_equal(sub, np.asarray(jsub))
    np.testing.assert_array_equal(k, np.asarray(jk))


@pytest.mark.parametrize("seed", [0, 7, -1])
@pytest.mark.parametrize("shape", [(1,), (7,), (256, 4099), (70_001,),
                                   (3, 5, 2)])
def test_uniform_matches_jax(seed, shape):
    got = prng.uniform(prng.PRNGKey(seed), shape)
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_uniform_row_block_matches_full_draw():
    key = prng.PRNGKey(4)
    full = prng.uniform(key, (16, 1001))
    block = prng.uniform(key, (16, 1001), start=5 * 1001, count=3 * 1001)
    assert torch.equal(block.view(3, 1001), full[5:8])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("high", [1, 2, 7, 2048, 334_863])
@pytest.mark.parametrize("shape", [(256,), (1000,)])
def test_randint_matches_jax(seed, high, shape):
    got = prng.randint(prng.PRNGKey(seed), shape, 0, high)
    want = jax.random.randint(jax.random.PRNGKey(seed), shape, 0, high)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B,m", [(1, 3), (16, 1001), (256, 2048)])
def test_ic_sparse_hits_plain_matches_jax(B, m):
    rng = np.random.default_rng(B + m)
    p = rng.uniform(size=m).astype(np.float32)
    key = prng.split(prng.PRNGKey(B))[1]
    got = ops.ic_sparse_hits(key, torch.from_numpy(p), B)
    want = jax.random.uniform(jax.numpy.asarray(key), (B, m)) < p[None, :]
    assert got.dtype == torch.bool and tuple(got.shape) == (B, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = ref.ic_sparse_hits_ref(key, torch.from_numpy(p), B,
                                  rows=(B // 2, B))
    assert torch.equal(rows, got[B // 2:])


def test_seed_out_of_int32_range_raises():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**31)
