"""repro_torch's IMPack codec against repro.core.pack.codec on the CPU:
bit packing, popcounts and the token format, exact, on ragged widths,
saturated runs, empty and single-bit rows, and s_pad below, at and above
what the rows need."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.pack import codec as jc  # noqa: E402
from repro_torch.core.pack import codec as pc  # noqa: E402

# the reference's token functions, jitted once per shape (op by op, JAX
# compiles every primitive of them anew for each shape)
_j_encode = jax.jit(jc.token_encode, static_argnums=1)
_j_decode = jax.jit(jc.token_decode, static_argnums=1)
_j_decode_cols = jax.jit(jc.token_decode_cols)
_j_popcount = jax.jit(jc.token_row_popcount)
_j_plan = jax.jit(jc._row_plan)
_j_needed = jax.jit(jc.tokens_needed)

WIDTHS = [1, 7, 8, 9, 77, 257, 1000, 8200]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(n: int, seed: int = 0) -> np.ndarray:
    """Bit rows of mixed density plus the edge cases: all zero, one bit,
    saturated 32-byte runs (a whole superblock, and every one of them),
    and a run cut short by the row's end."""
    rng = np.random.default_rng(seed * 1000 + n)
    dens = rng.uniform(0.0, 1.0, size=(12, 1))
    bits = (rng.uniform(size=(12, n)) < dens).astype(np.uint8)
    bits[0] = 0
    bits[1] = 0
    bits[1, rng.integers(n)] = 1
    bits[2] = 1
    if n >= 512:
        bits[3, 256:512] = 1
        bits[4] = 0
        bits[4, :256] = 1
        bits[4, n - 300:] = 1
    bits[5, :] = 0
    bits[5, -1] = 1
    return bits


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", WIDTHS)
def test_pack_and_unpack_match_jax(n):
    bits = _rows(n)
    want = np.asarray(jc.pack_bits(jnp.asarray(bits)))
    got = pc.pack_bits(_t(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pc.pack_bits_np(bits), want)
    back = np.asarray(jc.unpack_bits(jnp.asarray(want), n))
    np.testing.assert_array_equal(pc.unpack_bits(_t(want), n).numpy(), back)
    np.testing.assert_array_equal(pc.unpack_bits_np(want, n), back)
    np.testing.assert_array_equal(back, bits)
    assert pc.n_bytes_for(n) == jc.n_bytes_for(n) == want.shape[1]
    assert pc.n_blocks_padded(n) == jc.n_blocks_padded(n)
    assert pc.token_sentinel(n) == jc.token_sentinel(n)


def test_popcounts_match_jax():
    rng = np.random.default_rng(5)
    u8 = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(pc.popcount_u8(_t(u8)).numpy(),
                                  np.asarray(jc.popcount_u8(jnp.asarray(u8))))
    i32 = np.concatenate([np.arange(1024), [2**31 - 1, 0x0F0F0F0F],
                          rng.integers(0, 2**31 - 1, 4096)]).astype(np.int32)
    got = pc.popcount_i32(_t(i32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.popcount_i32(jnp.asarray(i32))))


@pytest.mark.parametrize("n", WIDTHS)
def test_row_plan_and_tokens_needed_match_jax(n):
    bits = _rows(n, seed=1)
    for want, got in zip(_j_plan(jnp.asarray(bits)),
                         pc._row_plan(_t(bits))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    need = pc.tokens_needed(_t(bits))
    assert need.dtype == torch.int32
    np.testing.assert_array_equal(
        need.numpy(), np.asarray(_j_needed(jnp.asarray(bits))))


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("s_pad_case", ["short", "exact", "above_total"])
def test_token_encode_and_decode_match_jax(n, s_pad_case):
    bits = _rows(n, seed=2)
    need = int(pc.tokens_needed(_t(bits)).max())
    total = pc.n_blocks_padded(n) + pc.n_superblocks_for(n)
    s_pad = {"short": max(need // 2, 1), "exact": max(need, 1),
             "above_total": total + 5}[s_pad_case]
    want = np.asarray(_j_encode(jnp.asarray(bits), s_pad))
    got = pc.token_encode(_t(bits), s_pad)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)

    np.testing.assert_array_equal(
        pc.token_decode(got, n).numpy(),
        np.asarray(_j_decode(jnp.asarray(want), n)))
    np.testing.assert_array_equal(pc.token_decode_np(want, n),
                                  jc.token_decode_np(want, n))
    np.testing.assert_array_equal(
        pc.token_row_popcount(got).numpy(),
        np.asarray(_j_popcount(jnp.asarray(want))))
    if s_pad_case != "short":
        np.testing.assert_array_equal(pc.token_decode(got, n).numpy(), bits)
    rng = np.random.default_rng(n)
    cols = np.unique(np.concatenate([[0, n - 1],
                                     rng.integers(0, n, 9)])).astype(np.int32)
    np.testing.assert_array_equal(
        pc.token_decode_cols(got, _t(cols)).numpy(),
        np.asarray(_j_decode_cols(jnp.asarray(want), jnp.asarray(cols))))


def test_token_decode_cols_chunks_rows(monkeypatch):
    """Chunked membership equals one broadcast over every row."""
    bits = _rows(1000, seed=3)
    toks = pc.token_encode(_t(bits), 256)
    cols = torch.arange(0, 1000, 7, dtype=torch.int32)
    whole = pc.token_decode_cols(toks, cols)
    monkeypatch.setattr(pc, "DECODE_ELEMS", 256 * cols.numel() * 2)
    np.testing.assert_array_equal(pc.token_decode_cols(toks, cols).numpy(),
                                  whole.numpy())
    np.testing.assert_array_equal(whole.numpy(), bits[:, ::7] > 0)


@pytest.mark.parametrize("kind", ["bitmap", "packed", "compressed"])
@pytest.mark.parametrize("n", [9, 257, 1000])
def test_codec_objects_match_jax(kind, n):
    bits = _rows(n, seed=4)
    s_pad = 64 if n < 1000 else 256
    jcod = jc.codec_for(kind, n, s_pad=s_pad)
    tcod = pc.codec_for(kind, n, s_pad=s_pad)
    assert (tcod.kind, tcod.width, tcod.fill) == (jcod.kind, jcod.width,
                                                  jcod.fill)
    want = np.asarray(jax.jit(jcod.encode)(jnp.asarray(bits)))
    got = tcod.encode(_t(bits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcod.decode(got).numpy(),
        np.asarray(jax.jit(jcod.decode)(jnp.asarray(want))))
    np.testing.assert_array_equal(tcod.decode_np(want), jcod.decode_np(want))
    np.testing.assert_array_equal(
        tcod.row_popcount(got).numpy(),
        np.asarray(jax.jit(jcod.row_popcount)(jnp.asarray(want))))
    cols = np.array([0, n // 2, n - 1], np.int32)
    np.testing.assert_array_equal(
        tcod.decode_cols(got, _t(cols)).numpy(),
        np.asarray(jax.jit(jcod.decode_cols)(jnp.asarray(want),
                                             jnp.asarray(cols))))


def test_codec_for_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="unknown codec kind"):
        pc.codec_for("indices", 10)
