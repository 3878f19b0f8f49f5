"""Plain versions of the port's IMPack kernels — the packed arena commit,
packed_count and token_count — against the JAX package's kernels (Pallas
in interpret mode) on the CPU: exact, on ragged widths, saturated runs,
float, mask and all-zero alive."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.pack import codec as jc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.pack import codec as pc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(rng, theta, n):
    """Rows of mixed density, with an empty row and saturated runs."""
    dens = rng.uniform(0.0, 0.9, size=(theta, 1))
    bits = (rng.uniform(size=(theta, n)) < dens).astype(np.uint8)
    bits[0] = 0
    if theta > 2:
        bits[1] = 1
        bits[2, :min(n, 512)] = 1
    return bits


def _padded(a: np.ndarray) -> torch.Tensor:
    """A (rows, w) view of a zeroed row-padded uint8 buffer holding ``a``."""
    rows, w = a.shape
    buf = torch.zeros((rows, ops.padded_width(w)), dtype=torch.uint8)
    buf[:, :w] = torch.from_numpy(a)
    return buf[:, :w]


def _alive(rng, theta, kind):
    alive = rng.uniform(size=theta) < 0.7
    if kind == "zeros":
        alive[:] = False
    a = torch.from_numpy(alive)
    return alive, (a.to(torch.float32) if kind == "float" else a)


# ---------------------------------------------------- arena_commit packed ----

@pytest.mark.parametrize("B,n", [(1, 1), (3, 7), (5, 9), (4, 17), (70, 513),
                                 (256, 4099)])
def test_arena_commit_packed_matches_jax(B, n):
    rng = np.random.default_rng(B * 13 + n)
    rows = (rng.uniform(size=(B, n)) < 0.3).astype(np.uint8)
    stored, colsum = jops.arena_commit(jnp.asarray(rows), kind="packed",
                                       interpret=True)
    nb = -(-n // 8)
    arena = torch.zeros((2 * B, ops.padded_width(nb)), dtype=torch.uint8)
    counter = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    before = counter.clone()
    ops.arena_commit(_padded(rows), arena[B:, :nb], counter, kind="packed")
    np.testing.assert_array_equal(arena[B:, :nb].numpy(), np.asarray(stored))
    np.testing.assert_array_equal(arena[B:, :nb].numpy(),
                                  jc.pack_bits_np(rows))
    np.testing.assert_array_equal((counter - before).numpy(),
                                  np.asarray(colsum))
    assert int(arena[:B].sum()) == 0 and int(arena[:, nb:].sum()) == 0


def test_arena_commit_rejects_unknown_kinds():
    z = torch.zeros((1, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="bitmap|packed"):
        ops.arena_commit(z, z, torch.zeros(16, dtype=torch.int32),
                         kind="compressed")


# ---------------------------------------------------------- packed_count ----

@pytest.mark.parametrize("theta,n", [(64, 100), (300, 777), (257, 1000),
                                     (1, 9), (40, 4099)])
@pytest.mark.parametrize("alive_kind", ["mask", "float", "zeros"])
def test_packed_count_matches_jax(theta, n, alive_kind):
    rng = np.random.default_rng(theta * 7 + n)
    packed = jc.pack_bits_np(_bits(rng, theta, n))
    alive, a = _alive(rng, theta, alive_kind)
    want = jops.packed_count(jnp.asarray(packed), jnp.asarray(alive), n=n,
                             interpret=True)
    got = ops.packed_count(_padded(packed), a, n=n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- token_count ----

@pytest.mark.parametrize("theta,n", [(16, 9), (33, 300), (64, 600)])
@pytest.mark.parametrize("alive_kind", ["mask", "float", "zeros"])
def test_token_count_matches_jax(theta, n, alive_kind):
    """Interpret-mode token_count is O(theta * s_pad * n): tiny shapes."""
    rng = np.random.default_rng(theta * 3 + n)
    bits = _bits(rng, theta, n)
    s_pad = 8
    while s_pad < int(pc.tokens_needed(torch.from_numpy(bits)).max()):
        s_pad *= 2
    # the port's encoder, held bitwise to the reference's in
    # test_torch_pack_codec.py
    tokens = pc.token_encode(torch.from_numpy(bits), s_pad).numpy()
    alive, a = _alive(rng, theta, alive_kind)
    want = jops.token_count(jnp.asarray(tokens), jnp.asarray(alive), n=n,
                            interpret=True)
    got = ops.token_count(torch.from_numpy(tokens), a, n=n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), (bits * alive[:, None]).sum(0))


# -------------------------------------------------------------- dispatch ----

def test_dispatch_records_the_new_kernels_on_cpu():
    obs.reset()
    obs.enable()
    try:
        alive = torch.ones(4, dtype=torch.bool)
        ops.packed_count(_padded(np.ones((4, 2), np.uint8)), alive, n=9)
        ops.token_count(torch.full((4, 8), 2 * 512, dtype=torch.int32),
                        alive, n=9)
        z = np.zeros((4, 9), np.uint8)
        ops.arena_commit(_padded(z), _padded(np.zeros((4, 2), np.uint8)),
                         torch.zeros(9, dtype=torch.int32), kind="packed")
        snap = obs.snapshot()["counters"]
    finally:
        obs.reset()
    for kernel in ("packed_count", "token_count", "arena_commit_packed"):
        assert snap[f"kernels.dispatch{{impl=reference,kernel={kernel}}}"] == 1
    assert not any(ops.launch_counts().get(k) for k in
                   ("packed_count", "token_count", "arena_commit_packed"))
