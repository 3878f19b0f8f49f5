"""Plain versions of the port's kernels against the JAX package's kernels
(Pallas in interpret mode) on the CPU: exact, on ragged shapes, ties and
an all-zero alive mask; plus the dispatch rules."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.fused import _ArenaFused  # noqa: E402
from repro_torch.core.store import make_store  # noqa: E402
from repro_torch.kernels import _common, ops, ref  # noqa: E402


def _bitmap(rng, theta, n, p=0.3):
    return (rng.uniform(size=(theta, n)) < p).astype(np.uint8)


def _padded(a: np.ndarray) -> torch.Tensor:
    """A (rows, n) view of a zeroed row-padded buffer holding ``a``."""
    rows, n = a.shape
    buf = torch.zeros((rows, ops.padded_width(n)), dtype=torch.uint8)
    buf[:, :n] = torch.from_numpy(a)
    return buf[:, :n]


# ---------------------------------------------------------- arena_commit ----

@pytest.mark.parametrize("B,n", [(1, 1), (3, 17), (8, 128), (70, 1000),
                                 (256, 513)])
def test_arena_commit_matches_jax(B, n):
    rng = np.random.default_rng(B * 31 + n)
    rows = _bitmap(rng, B, n, 0.2)
    stored, colsum = jops.arena_commit(jnp.asarray(rows), kind="bitmap",
                                       interpret=True)
    arena = torch.zeros((2 * B, ops.padded_width(n)), dtype=torch.uint8)
    counter = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    before = counter.clone()
    sizes = torch.full((2 * B,), -3, dtype=torch.int32)
    ops.arena_commit(_padded(rows), arena[B:, :n], counter,
                     sizes=sizes[B:])
    np.testing.assert_array_equal(arena[B:, :n].numpy(), np.asarray(stored))
    np.testing.assert_array_equal((counter - before).numpy(),
                                  np.asarray(colsum))
    np.testing.assert_array_equal(sizes[B:].numpy(), rows.sum(axis=1))
    assert int(arena[:B].sum()) == 0 and int(arena[:, n:].sum()) == 0
    assert bool((sizes[:B] == -3).all())


def _expected_commit(kind, rows):
    """What a commit of ``rows`` stores: the rows, or their LSB-first
    packed bytes."""
    if kind == "bitmap":
        return rows
    return np.packbits(rows, axis=1, bitorder="little")


@pytest.mark.parametrize("kind", ["bitmap", "packed"])
@pytest.mark.parametrize("B", [255, 256, 257])
@pytest.mark.parametrize("n", [1, 7, 9, 15, 16, 17, 4099])
@pytest.mark.parametrize("fill", [0, 1])
def test_arena_commit_all_ones_and_zeros(kind, B, n, fill):
    """All-ones and all-zero batches on both sides of 256 rows and at
    ragged widths: arena rows, counter and sizes (stale before the call)
    against numpy, nothing written past the row's width."""
    rows = np.full((B, n), fill, np.uint8)
    want = _expected_commit(kind, rows)
    w = want.shape[1]
    arena = torch.zeros((B + 2, ops.padded_width(w)), dtype=torch.uint8)
    counter = torch.full((n,), 5, dtype=torch.int32)
    sizes = torch.full((B + 2,), 77, dtype=torch.int32)
    ops.arena_commit(_padded(rows), arena[1:B + 1, :w], counter, kind=kind,
                     sizes=sizes[1:B + 1])
    np.testing.assert_array_equal(arena[1:B + 1, :w].numpy(), want)
    np.testing.assert_array_equal(counter.numpy(), 5 + fill * B)
    np.testing.assert_array_equal(sizes[1:B + 1].numpy(), fill * n)
    assert int(sizes[0]) == int(sizes[B + 1]) == 77
    assert int(arena[0].sum()) == int(arena[B + 1].sum()) == 0
    assert int(arena[:, w:].sum()) == 0


class _Replay:
    """A bound sampler that hands out given batches in turn."""

    def __init__(self, batches):
        self.batches = list(batches)

    def __call__(self, key):
        return self.batches.pop(0), None, None


@pytest.mark.parametrize("kind", ["bitmap", "packed"])
def test_fused_extender_matches_add_batch(kind):
    """`_ArenaFused.extend_once` (one arena_commit with sizes) leaves the
    arena, counter and sizes of the store's unfused `add_batch` on the
    same rows; the second batch lands at row 300 of a grown arena."""
    rng = np.random.default_rng(3)
    n, B = 777, 300
    batches = [_bitmap(rng, B, n, p) for p in (0.1, 0.6)]
    batches[1][7] = 0
    fused_store = make_store(kind, n, device="cpu")
    plain_store = make_store(kind, n, device="cpu")
    fused = _ArenaFused(fused_store, _Replay(_padded(b) for b in batches),
                        B, sampler_name="replay")
    for b in batches:
        assert fused.extend_once(None)
        plain_store.add_batch(torch.from_numpy(b))
    assert fused_store.count == plain_store.count == 2 * B
    for name in ("R", "counter", "sizes"):
        assert torch.equal(getattr(fused_store, name),
                           getattr(plain_store, name)), name
    np.testing.assert_array_equal(fused_store.sizes[:2 * B].numpy(),
                                  np.concatenate(batches).sum(axis=1))


# ------------------------------------------------------- coverage_matvec ----

@pytest.mark.parametrize("theta,n", [(64, 100), (300, 700), (257, 1000),
                                     (1, 33), (4100, 64)])
@pytest.mark.parametrize("alive_kind", ["mask", "float", "zeros"])
def test_coverage_matvec_matches_jax(theta, n, alive_kind):
    rng = np.random.default_rng(theta * 7 + n)
    R = _bitmap(rng, theta, n)
    alive = rng.uniform(size=theta) < 0.7
    if alive_kind == "zeros":
        alive[:] = False
    want = jops.coverage_matvec(jnp.asarray(alive), jnp.asarray(R),
                                interpret=True)
    a = torch.from_numpy(alive)
    if alive_kind == "float":
        a = a.to(torch.float32)
    got = ops.coverage_matvec(a, _padded(R))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- fused_select ----

@pytest.mark.parametrize("theta,n", [(64, 100), (513, 300), (256, 2000),
                                     (5, 1)])
def test_fused_select_matches_jax(theta, n):
    rng = np.random.default_rng(theta + n)
    R = _bitmap(rng, theta, n, 0.25)
    alive = rng.uniform(size=theta) < 0.8
    jm, ji = jops.fused_select(jnp.asarray(alive), jnp.asarray(R),
                               interpret=True)
    pm, pi = ops.fused_select(torch.from_numpy(alive), _padded(R))
    assert pi.dtype == torch.int32
    assert float(pm) == float(jm) and int(pi) == int(ji)


@pytest.mark.parametrize("n,cols", [(1100, (3, 600, 1099)),
                                    (2000, (1999, 700)),
                                    (40, (0, 39))])
def test_fused_select_ties_take_the_first_column(n, cols):
    """Equal maxima in different 512-column tiles: jnp.argmax's first."""
    rng = np.random.default_rng(n)
    R = _bitmap(rng, 96, n, 0.1)
    R[:, list(cols)] = 1
    alive = np.ones(96, bool)
    jm, ji = jops.fused_select(jnp.asarray(alive), jnp.asarray(R),
                               interpret=True)
    pm, pi = ops.fused_select(torch.from_numpy(alive), _padded(R))
    assert int(pi) == int(ji) == min(cols)
    assert float(pm) == float(jm) == 96.0


@pytest.mark.parametrize("n", [1, 64, 1025])
def test_fused_select_all_zero_alive(n):
    R = np.ones((32, n), np.uint8)
    alive = np.zeros(32, bool)
    jm, ji = jops.fused_select(jnp.asarray(alive), jnp.asarray(R),
                               interpret=True)
    pm, pi = ops.fused_select(torch.from_numpy(alive), _padded(R))
    assert (float(pm), int(pi)) == (float(jm), int(ji)) == (0.0, 0)


# -------------------------------------------------------------- dispatch ----

def test_dispatch_records_reference_on_cpu():
    obs.reset()
    obs.enable()
    try:
        ops.coverage_matvec(torch.ones(4, dtype=torch.bool),
                            _padded(np.ones((4, 5), np.uint8)))
        snap = obs.snapshot()["counters"]
    finally:
        obs.reset()
    assert snap["kernels.dispatch{impl=reference,kernel=coverage_matvec}"] == 1
    assert not _common.launch_counts().get("coverage_matvec")


def test_non_cpu_operands_never_take_the_plain_version():
    """A tensor off the CPU launches the kernel or raises: here (meta
    tensors) it raises before any plain arithmetic runs."""
    R = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    alive = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="operands on"):
        ops.coverage_matvec(alive, R)
    with pytest.raises(ValueError, match="operands on"):
        ops.arena_commit(R, R, torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="operands on"):
        ops.arena_commit(R, R[:, :2], torch.zeros(16, dtype=torch.int32),
                         kind="packed")
    cpu = torch.zeros((4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="operands on"):
        ops.arena_commit(cpu, cpu, torch.zeros(16, dtype=torch.int32),
                         sizes=torch.zeros(4, dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError, match="operands on"):
        ops.packed_count(R, alive, n=128)
    with pytest.raises(ValueError, match="operands on"):
        ops.token_count(R.to(torch.int32), alive, n=100)


def test_row_view_requires_padded_rows():
    ok = torch.zeros((4, 32), dtype=torch.uint8)[:, :17]
    assert _common.row_view(ok, "R")[1] == 32
    with pytest.raises(ValueError, match="16-byte"):
        _common.row_view(torch.zeros((4, 17), dtype=torch.uint8), "R")
    assert ops.padded_width(334_863) == 334_864
