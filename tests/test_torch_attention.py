"""The port's attention (``repro_torch.models.attention`` and the plain
version of the ``flash_attention`` kernel, its CPU path) against the JAX
package: the reference's Pallas kernel in interpret mode and its oracle
``attention_ref``, RoPE, the blockwise path with ``kv_len`` and
``q_offset``, and the CPU dispatch across the blockwise threshold.

Tolerances (the float contract of ``docs/kernels.md``): f32 against the
oracle 1e-5 (the same f32 arithmetic, summed in another order); f32
against the interpreted TPU kernel 2e-3 (its online softmax, as
``tests/test_kernels.py`` holds it); bf16 3e-2 (the output's rounding to
bf16, one ulp is 2**-8 relative, plus the inputs' own rounding)."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import _common as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

F32_ORACLE, F32_KERNEL, BF16 = 1e-5, 2e-3, 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the cases of tests/test_kernels.py (flash_attention sweep and windows)
CASES = [
    (2, 8, 8, 64, 64, 32, 0),       # MHA
    (2, 8, 2, 64, 64, 32, 0),       # GQA 4:1
    (1, 4, 1, 128, 128, 64, 0),     # MQA
    (2, 4, 2, 1, 128, 64, 0),       # decode shape
    (1, 4, 4, 100, 100, 32, 0),     # non-tile-multiple
    (1, 4, 2, 96, 96, 32, 8),       # sliding window 8
    (1, 4, 2, 96, 96, 32, 32),      # sliding window 32
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window", CASES)
def test_plain_matches_jax_kernel_and_oracle_f32(B, Hq, Hkv, Sq, Skv, D,
                                                 window):
    q, k, v = _qkv(Sq + Skv + window, B, Hq, Hkv, Sq, Skv, D)
    got = ops.flash_attention(*(_torch(a, torch.float32) for a in (q, k, v)),
                              causal=True, window=window)
    jq, jk, jv = (_jax(a, jnp.float32) for a in (q, k, v))
    oracle = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    kernel = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  interpret=True, tile_q=32, tile_k=32)
    _close(got, oracle, F32_ORACLE)
    _close(got, kernel, F32_KERNEL)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Sq, D)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window", [
    CASES[0], CASES[1], CASES[3], CASES[5]])
def test_plain_matches_jax_bf16(B, Hq, Hkv, Sq, Skv, D, window):
    q, k, v = _qkv(7 + window, B, Hq, Hkv, Sq, Skv, D)
    got = ops.flash_attention(*(_torch(a, torch.bfloat16)
                                for a in (q, k, v)), window=window)
    jq, jk, jv = (_jax(a, jnp.bfloat16) for a in (q, k, v))
    oracle = jref.attention_ref(jq, jk, jv, window=window)
    kernel = jops.flash_attention(jq, jk, jv, window=window, interpret=True,
                                  tile_q=32, tile_k=32)
    assert got.dtype == torch.bfloat16
    _close(got, oracle, BF16)
    _close(got, kernel, BF16)


def test_non_causal_and_ref_name():
    q, k, v = _qkv(3, 1, 4, 2, 40, 72, 16)
    tq, tk, tv = (_torch(a, torch.float32) for a in (q, k, v))
    got = ref.attention_ref(tq, tk, tv, causal=False, window=16)
    want = jref.attention_ref(*(_jax(a, jnp.float32) for a in (q, k, v)),
                              causal=False, window=16)
    _close(got, want, F32_ORACLE)
    assert torch.equal(got, fa.flash_attention_plain(tq, tk, tv,
                                                     causal=False,
                                                     window=16))


def test_plain_walks_query_blocks(monkeypatch):
    """The plain version's query blocking (taken above ~8k x 8k scores a
    head on the card) gives the unblocked result."""
    q, k, v = (_torch(a, torch.float32)
               for a in _qkv(5, 1, 4, 2, 70, 90, 16))
    want = fa.flash_attention_plain(q, k, v, window=24)
    monkeypatch.setattr(fa, "_PLAIN_BLOCK_ELEMS", 4 * 90 * 16)
    got = fa.flash_attention_plain(q, k, v, window=24)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("Sq,Skv,causal", [(8, 4, True), (3, 0, True),
                                           (3, 0, False)])
def test_fully_masked_rows_raise(Sq, Skv, causal):
    """Rows that admit no key: the TPU kernel's value depends on its tile
    size, the oracle's is NaN, so the port refuses them."""
    q, k, v = (_torch(a, torch.float32)
               for a in _qkv(0, 1, 2, 2, Sq, Skv, 16))
    for fn in (ops.flash_attention, fa.flash_attention_plain,
               fa.flash_attention_cuda):
        with pytest.raises(ValueError, match="admit no key"):
            fn(q, k, v, causal=causal)


def test_admitted_pairs_counts_the_mask():
    for Sq, Skv, causal, window in ((64, 64, True, 0), (1, 128, True, 0),
                                    (100, 100, True, 8), (40, 72, False, 16),
                                    (4, 9, True, 3)):
        qpos = np.arange(Sq)[:, None] + Skv - Sq
        kpos = np.arange(Skv)[None, :]
        mask = np.ones((Sq, Skv), bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        assert fa.admitted_pairs(Sq, Skv, causal=causal,
                                 window=window) == int(mask.sum())


def test_dispatch_and_no_fallback():
    q, k, v = (_torch(a, torch.float32) for a in _qkv(1, 1, 2, 2, 8, 8, 16))
    obs.reset()
    obs.enable()
    try:
        ops.flash_attention(q, k, v)
        snap = obs.snapshot()["counters"]
    finally:
        obs.reset()
    assert snap["kernels.dispatch{impl=reference,kernel=flash_attention}"] == 1
    m = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="operands on"):
        ops.flash_attention(m, m, m)
    with pytest.raises(ValueError, match="operands on"):
        ops.flash_attention(q, m, m)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention_cuda(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q.bfloat16(), k, v)


class _Lib:
    """A stand-in for a built kernel library: records each call of an entry
    point and returns ``err[0]`` as the C function would."""

    calls: list = []
    err = [0]

    def __init__(self, source):
        self.source = source

    def __getattr__(self, entry):
        def fn(*args):
            _Lib.calls.append((self.source, entry, args[4:]))
            return _Lib.err[0]
        return fn


def test_cuda_wrapper_picks_the_kernel_by_dtype(monkeypatch):
    """bf16 launches the tensor-core kernel and f32 the SIMT one, with the
    same arguments; each launch counts under ``flash_attention`` and under
    its design; a refused launch raises and counts nothing; each design
    refuses the grid it cannot launch."""
    monkeypatch.setattr(build, "library", _Lib)
    # host tensors through the CUDA wrapper: no card to make current,
    # stream handle 0
    monkeypatch.setattr(C, "on_device",
                        contextlib.contextmanager(lambda *a: (yield 0)))
    monkeypatch.setattr(_Lib, "calls", [])
    monkeypatch.setattr(_Lib, "err", [0])
    ops.reset_launches()
    q, k, v = (_torch(a, torch.float32)
               for a in _qkv(2, 1, 4, 2, 10, 12, 24))
    for dtype, impl, source in ((torch.bfloat16, "tc", "flash_attention_tc"),
                                (torch.float32, "simt", "flash_attention")):
        qq, kk, vv = q.to(dtype), k.to(dtype), v.to(dtype)
        assert fa.design(qq, kk, vv) == impl
        out = fa.flash_attention_cuda(qq, kk, vv, window=5)
        assert out.dtype == dtype and out.shape == q.shape
        src, entry, args = _Lib.calls[-1]
        assert (src, entry) == (source, f"repro_{source}")
        # no gradient asked: a null logsumexp pointer
        assert args == (None, 1, 4, 2, 10, 12, 24, 1, 5, 1 / np.sqrt(24),
                        0)
    # reset_launches zeroes the keys that earlier tests of this process
    # made, and keeps them: the launches are the nonzero counts
    assert {key: n for key, n in ops.launch_counts().items() if n} == {
        "flash_attention": 2, "flash_attention:tc": 1,
        "flash_attention:simt": 1}
    _Lib.err[0] = 700
    with pytest.raises(RuntimeError, match="error 700"):
        fa.flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert ops.launch_counts()["flash_attention:tc"] == 1
    _Lib.err[0] = 0
    # the SIMT grid's second axis is B * Hq, the tensor-core grid's first
    wide = torch.zeros((1, 65536, 1, 8))
    with pytest.raises(ValueError, match="simt kernel's grid"):
        fa.flash_attention_cuda(wide, wide, wide)
    fa.flash_attention_cuda(wide.bfloat16(), wide.bfloat16(),
                            wide.bfloat16())
    assert _Lib.calls[-1][0] == "flash_attention_tc"


# ------------------------------------------------------------- RoPE ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
    pos = np.arange(5, 29)
    got = tattn.apply_rope(_torch(x, getattr(torch, dtype)),
                           torch.from_numpy(pos)[None, None, :], 10000.0)
    want = jattn.apply_rope(_jax(x, getattr(jnp, dtype)),
                            jnp.asarray(pos)[None, None, :], 10000.0)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(got, want, tol)
    np.testing.assert_allclose(tattn.rope_freqs(16, 1e6).numpy(),
                               np.asarray(jattn.rope_freqs(16, 1e6)),
                               rtol=1e-6)


# -------------------------------------------------- blockwise attention ----

@pytest.mark.parametrize("window,q_offset,kv_len", [
    (0, None, None), (0, None, [40, 27]), (8, None, [33, 40]),
    (0, 16, [24, 24]), (6, 8, None)])
def test_blockwise_matches_jax(window, q_offset, kv_len):
    q, k, v = _qkv(11, 2, 4, 2, 8, 40, 16)
    jkw = dict(causal=True, window=window, chunk=16)
    if kv_len is not None:
        jkw["kv_len"] = jnp.asarray(kv_len, jnp.int32)
    if q_offset is not None:
        jkw["q_offset"] = q_offset
    want = jattn.blockwise_attention(*(_jax(a, jnp.float32)
                                       for a in (q, k, v)), **jkw)
    tkw = dict(jkw)
    if kv_len is not None:
        tkw["kv_len"] = torch.tensor(kv_len)
    got = tattn.blockwise_attention(*(_torch(a, torch.float32)
                                      for a in (q, k, v)), **tkw)
    _close(got, want, F32_ORACLE)


def test_cpu_dispatch_across_the_blockwise_threshold(monkeypatch):
    """On the CPU, ``attention`` takes the oracle up to Skv 2,048 and the
    blockwise path above it or with ``kv_len``, as the reference does off
    the TPU; both agree with the reference's ``attention``."""
    calls = []
    plain, block = ref.attention_ref, tattn.blockwise_attention
    monkeypatch.setattr(ref, "attention_ref", lambda *a, **kw: (
        calls.append("ref"), plain(*a, **kw))[1])
    monkeypatch.setattr(tattn, "blockwise_attention", lambda *a, **kw: (
        calls.append("blockwise"), block(*a, **kw))[1])
    for Skv, kv_len, want_path in ((2048, None, "ref"),
                                   (2049, None, "blockwise"),
                                   (64, [60], "blockwise")):
        q, k, v = _qkv(Skv, 1, 2, 1, 4, Skv, 16)
        calls.clear()
        tkw = {} if kv_len is None else {"kv_len": torch.tensor(kv_len)}
        jkw = {} if kv_len is None else {"kv_len": jnp.asarray(kv_len)}
        got = tattn.attention(*(_torch(a, torch.float32) for a in (q, k, v)),
                              window=32, **tkw)
        want = jattn.attention(*(_jax(a, jnp.float32) for a in (q, k, v)),
                               window=32, use_pallas=False, **jkw)
        assert calls == [want_path]
        _close(got, want, F32_ORACLE)
