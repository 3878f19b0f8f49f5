"""Plain versions of the port's IMPack kernels — the packed arena commit,
packed_count and token_count — against the JAX package's kernels (Pallas
in interpret mode) on the CPU: exact, on ragged widths, saturated runs,
the edge arenas the CUDA kernels are held to on the card
(``test_torch_count_cuda.py``), float, mask, all-zero and all-one alive.
Also the counting kernels' index arithmetic written in PyTorch (the
bit-sliced planes, where each span's literals start) against brute
force, and the stores' device rule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.pack import codec as jc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import store as cstore  # noqa: E402
from repro_torch.core.pack import codec as pc  # noqa: E402
from repro_torch.core.pack import stores as pstores  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packed_count as pcm  # noqa: E402


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
    if kind == "ones":
        alive[:] = True
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
    sizes = torch.full((2 * B,), -3, dtype=torch.int32)
    ops.arena_commit(_padded(rows), arena[B:, :nb], counter, kind="packed",
                     sizes=sizes[B:])
    np.testing.assert_array_equal(sizes[B:].numpy(), rows.sum(axis=1))
    assert bool((sizes[:B] == -3).all())
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


# ------------------------------------------------------------ edge arenas ----

def _edge(kind, rng):
    """Small copies of the edge arenas of the CUDA tests (0/1 rows)."""
    if kind == "no_sentinel":         # 8 literals a row: s_pad 8, full
        bits = np.zeros((5, 64), np.uint8)
        bits[:, ::8] = 1
    elif kind == "runs_only":          # two runs a row, and empty rows
        bits = np.zeros((6, 512), np.uint8)
        bits[::2] = 1
    elif kind == "last_superblock_run":
        bits = (rng.uniform(size=(6, 512)) < 0.2).astype(np.uint8)
        bits[1::2, 256:] = 1
    elif kind == "hub_columns":        # count = theta
        bits = (rng.uniform(size=(40, 300)) < 0.05).astype(np.uint8)
        bits[:, [0, 150, 299]] = 1
    elif kind == "span_edges":         # both sides of a 4,096-column edge
        bits = (rng.uniform(size=(9, 4099)) < 0.002).astype(np.uint8)
        bits[:, [0, 4095, 4096, 4097, 4098]] = 1
    elif kind == "n_1_mod_8":
        bits = (rng.uniform(size=(33, 17)) < 0.4).astype(np.uint8)
    else:                              # theta not a multiple of 32
        bits = (rng.uniform(size=(35, 40)) < 0.3).astype(np.uint8)
    return bits


EDGES = ("no_sentinel", "runs_only", "last_superblock_run", "hub_columns",
         "span_edges", "n_1_mod_8", "theta_35")


@pytest.mark.parametrize("kind", EDGES)
@pytest.mark.parametrize("alive_kind", ["mask", "float", "zeros", "ones"])
def test_count_edge_arenas_match_jax(kind, alive_kind):
    rng = np.random.default_rng(EDGES.index(kind))
    bits = _edge(kind, rng)
    theta, n = bits.shape
    need = int(pc.tokens_needed(torch.from_numpy(bits)).max())
    s_pad = max(pc.MIN_TOKEN_PAD, 1 << max(need - 1, 0).bit_length())
    tokens = pc.token_encode(torch.from_numpy(bits), s_pad)
    if kind == "no_sentinel":
        assert s_pad == need and not bool(
            (tokens == pc.token_sentinel(n)).any())
    if kind in ("runs_only", "last_superblock_run"):
        assert bool(((tokens & 511) == pc.SAT_CODE).any())
    packed = jc.pack_bits_np(bits)
    alive, a = _alive(rng, theta, alive_kind)
    want = (bits.astype(np.int64) * alive[:, None]).sum(0)
    got_p = ops.packed_count(_padded(packed), a, n=n)
    got_t = ops.token_count(tokens, a, n=n)
    np.testing.assert_array_equal(got_p.numpy(), want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(
        jops.packed_count(jnp.asarray(packed), jnp.asarray(alive), n=n,
                          interpret=True)))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(
        jops.token_count(jnp.asarray(tokens.numpy()), jnp.asarray(alive),
                         n=n, interpret=True)))


# ------------------------------------------ the kernels' index arithmetic ----

@pytest.mark.parametrize("steps", [1, 5, 31])
def test_bitplanes_count_columns(steps):
    """``add8`` and ``expand`` of csrc/bitslice.cuh, in PyTorch: the
    planes after ``steps`` eight-row adds hold each column's count (up to
    the 248 a kernel lets them reach before it expands them)."""
    rng = np.random.default_rng(steps)
    words = rng.integers(0, 2 ** 32, size=(steps, 8, 50), dtype=np.int64)
    words[0, :, 0] = 0xFFFFFFFF                 # every bit, every row
    P = torch.zeros((50, pcm.PLANES), dtype=torch.int64)
    for s in range(steps):
        P = pcm.bitplanes_add8(P, torch.from_numpy(words[s].T))
    bits = (words[..., None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(pcm.bitplanes_expand(P).numpy(),
                                  bits.sum(axis=(0, 1)))


@pytest.mark.parametrize("span", [8, 32, pcm.SPAN_BYTES])
@pytest.mark.parametrize("n", [9, 300, 4099])
def test_token_segments_find_each_span(span, n):
    """Where each span's literals start in each row, against a walk of
    the decoded literal blocks."""
    rng = np.random.default_rng(n + span)
    dens = rng.uniform(0.0, 0.9, size=(12, 1))
    bits = (rng.uniform(size=(12, n)) < dens).astype(np.uint8)
    bits[0] = 0
    bits[1] = 1
    tokens = pc.token_encode(torch.from_numpy(bits), 1024)
    got = pcm.token_segments(tokens, n, span).numpy()
    nbp = pc.n_blocks_padded(n)
    spans = -(-nbp // span)
    assert got.shape == (12, spans + 1)
    for r, row in enumerate(tokens.numpy()):
        lits = [int(t) >> 9 for t in row
                if t & 511 < pc.SAT_CODE and int(t) >> 9 < nbp]
        for j in range(spans):
            assert got[r, j] == sum(b < j * span for b in lits)
        assert got[r, spans] == len(lits)


# --------------------------------------------------------- stores' device ----

_MAKERS = {
    "BitmapStore": lambda st, dev: cstore.BitmapStore(9, **dev),
    "PackedBitmapStore": lambda st, dev: pstores.PackedBitmapStore(9, **dev),
    "CompressedStore": lambda st, dev: pstores.CompressedStore(9, **dev),
    "make_store": lambda st, dev: cstore.make_store("compressed", 9, **dev),
    "store_from_state": lambda st, dev: cstore.store_from_state(st, **dev),
    "store_from_state kind": lambda st, dev: cstore.store_from_state(
        st, kind="packed", **dev),
    "BitmapStore.from_state": lambda st, dev: cstore.BitmapStore.from_state(
        st, **dev),
    "BitmapStore.from_rows": lambda st, dev: cstore.BitmapStore.from_rows(
        np.eye(3, 9, dtype=np.uint8), 9, **dev),
    "CodecStore.from_state": lambda st, dev: pstores.PackedBitmapStore
    .from_state(cstore.store_from_state(st, kind="packed",
                                        device="cpu").state(), **dev),
    "CodecStore.from_rows": lambda st, dev: pstores.CompressedStore
    .from_rows(np.eye(3, 9, dtype=np.uint8), 9, **dev),
}


@pytest.mark.parametrize("maker", sorted(_MAKERS))
def test_stores_run_on_cuda_unless_told(maker):
    """Every store constructor and factory runs on ``cuda`` unless given
    ``device="cpu"``; with no GPU it raises instead."""
    st = cstore.BitmapStore.from_rows(np.eye(3, 9, dtype=np.uint8), 9,
                                      device="cpu").state()
    made = _MAKERS[maker](st, {"device": "cpu"})
    assert made.device.type == "cpu" and made.counter.device.type == "cpu"
    if torch.cuda.is_available():
        assert _MAKERS[maker](st, {}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _MAKERS[maker](st, {})


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
