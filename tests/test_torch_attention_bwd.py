"""The attention kernels' gradient on the host: what the backward kernels
must reproduce, and their wrapper's checks and routing, with no card and
nothing built.

- The plain logsumexp and delta (`flash_attention_stats_plain`), which
  the forward kernel writes and the backward kernels' dQ pass sums,
  against JAX: ``logsumexp`` of the reference oracle's masked scores and
  ``rowsum(dout * attention_ref(...))``, within 1e-5 (the same f32
  arithmetic summed in another order), with GQA, windows, ragged S, Sq <
  Skv and no causal mask.
- `flash_attention_backward_cuda` refuses what its kernels do not take
  (dtype, head dim, shapes, the grid) before anything is built.
- `FlashAttention` (what ``ops.flash_attention`` runs on CUDA tensors)
  with both C entry points stood in for: the forward asks for the
  logsumexp exactly when an input needs a gradient and saves q, k, v and
  it; the backward hands those to the design's backward entry point
  (bf16 ``flash_attention_bwd_tc``, f32 ``flash_attention_bwd``), counts
  one launch under ``flash_attention_bwd`` and its design, and never
  calls the plain backward.
"""
import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _common as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5

#: (B, Hq, Hkv, Sq, Skv, D, window, causal)
STATS_CASES = [(1, 4, 2, 37, 37, 16, 0, True), (2, 2, 1, 50, 50, 8, 7, True),
               (1, 3, 3, 45, 45, 24, 0, True), (1, 4, 1, 20, 50, 8, 0, True),
               (1, 4, 2, 30, 70, 16, 9, True), (1, 2, 2, 10, 30, 8, 5, False),
               (2, 6, 2, 130, 130, 32, 40, True)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, Sq, D))]


def _jax_stats(q, k, v, dout, causal, window):
    """logsumexp of the oracle's masked scores (its own logits, mask and
    scale) and rowsum(dout * its output)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kk = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kk) / jnp.sqrt(
        jnp.float32(D))
    qpos = jnp.arange(Sq) + (Skv - Sq)
    kpos = jnp.arange(Skv)
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    lse = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1)
    out = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    return np.asarray(lse), np.asarray(jnp.sum(jnp.asarray(dout) * out, -1))


@pytest.mark.parametrize("case", STATS_CASES)
def test_plain_lse_and_delta_match_jax(case, monkeypatch):
    B, Hq, Hkv, Sq, Skv, D, window, causal = case
    # blocks of a few rows, so that several query blocks run
    monkeypatch.setattr(fa, "_PLAIN_BLOCK_ELEMS", B * Hq * Skv * 8)
    arrs = _arrays(Sq + D, B, Hq, Hkv, Sq, Skv, D)
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    lse, delta = fa.flash_attention_stats_plain(q, k, v, dout, causal=causal,
                                                window=window)
    want_lse, want_delta = _jax_stats(*arrs, causal, window)
    assert lse.dtype == delta.dtype == torch.float32
    assert tuple(lse.shape) == tuple(delta.shape) == (B, Hq, Sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=TOL, atol=TOL)
    assert fa.flash_attention_stats_plain(q, k, v, causal=causal,
                                          window=window)[1] is None


def test_delta_is_rowsum_of_p_times_dp():
    """What the dQ pass sums, rowsum(P * dP) from the recomputed P, is
    the plain delta, rowsum(dout * O)."""
    q, k, v, dout = (torch.from_numpy(a).double()
                     for a in _arrays(3, 1, 4, 2, 40, 60, 16))
    lse, delta = fa.flash_attention_stats_plain(q, k, v, dout, window=12)
    kk, vv = (t.repeat_interleave(2, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / 4.0
    qpos = torch.arange(40)[:, None] + 20
    kpos = torch.arange(60)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - 12)
    p = torch.exp(s - lse.double()[..., None]).masked_fill(~mask, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, vv)
    np.testing.assert_allclose(delta.numpy(), (p * dp).sum(-1).numpy(),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------- the wrapper, nothing built

class _Lib:
    """A stand-in for a built kernel library: records each call of an
    entry point and returns 0, as a launch that succeeded would."""

    calls: list = []

    def __init__(self, source):
        self.source = source

    def __getattr__(self, entry):
        def fn(*args):
            _Lib.calls.append((self.source, entry, args))
            return 0
        return fn


@pytest.fixture
def stub(monkeypatch):
    """Both CUDA entry points stood in for (host tensors through the CUDA
    wrappers: no card to make current, stream handle 0), and the plain
    backward replaced by a sentinel that fails if it runs."""
    monkeypatch.setattr(build, "library", _Lib)
    monkeypatch.setattr(C, "on_device",
                        contextlib.contextmanager(lambda *a: (yield 0)))
    monkeypatch.setattr(_Lib, "calls", [])

    def sentinel(*a, **kw):
        raise AssertionError("the plain backward ran")

    monkeypatch.setattr(fa, "flash_attention_backward_plain", sentinel)
    ops.reset_launches()
    return _Lib.calls


def _nothing_built(*a, **kw):
    raise AssertionError("a kernel library was asked for")


def _qkv(dtype, B=1, Hq=4, Hkv=2, Sq=10, Skv=12, D=16, device="cpu"):
    return [torch.zeros(s, dtype=dtype, device=device) for s in (
        (B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


def test_backward_refusals_come_before_any_build(monkeypatch):
    monkeypatch.setattr(build, "library", _nothing_built)
    q, k, v = _qkv(torch.bfloat16)
    lse = torch.zeros((1, 4, 10))
    bwd = fa.flash_attention_backward_cuda
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd(q.double(), k.double(), v.double(), lse, q.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd(q, k.float(), v, lse, q)
    for D in (12, 264):
        qq, kk, vv = _qkv(torch.bfloat16, D=D)
        with pytest.raises(ValueError, match="multiple of 8"):
            bwd(qq, kk, vv, lse, qq)
    with pytest.raises(ValueError, match="dout"):
        bwd(q, k, v, lse, q[:, :, :9])
    with pytest.raises(ValueError, match="dout"):
        bwd(q, k, v, lse, q.float())
    with pytest.raises(ValueError, match="lse"):
        bwd(q, k, v, lse.double(), q)
    with pytest.raises(ValueError, match="lse"):
        bwd(q, k, v, lse[:, :, :9], q)
    qq, kk, vv = _qkv(torch.bfloat16, Hq=3)
    with pytest.raises(ValueError, match="multiple of"):
        bwd(qq, kk, vv, torch.zeros((1, 3, 10)), qq)
    qq, kk, vv = _qkv(torch.bfloat16, Sq=12, Skv=10)
    with pytest.raises(ValueError, match="admit no key"):
        bwd(qq, kk, vv, torch.zeros((1, 4, 12)), qq)
    # the backward grids' tiles: 64 rows a tensor-core tile, 32 a SIMT one
    for dtype, rows in ((torch.bfloat16, 64), (torch.float32, 32)):
        S = rows * 65535 + 1
        qq, kk, vv = _qkv(dtype, Hq=1, Hkv=1, Sq=S, Skv=S, D=8,
                          device="meta")
        with pytest.raises(ValueError, match="backward's grid"):
            bwd(qq, kk, vv, torch.zeros((1, 1, S), device="meta"), qq)


@pytest.mark.parametrize("dtype,impl", [(torch.bfloat16, "tc"),
                                        (torch.float32, "simt")])
def test_flash_attention_routes_its_gradient_to_the_kernels(stub, dtype,
                                                            impl):
    q, k, v = (t.requires_grad_() for t in _qkv(dtype))
    out = fa.FlashAttention.apply(q, k, v, True, 5)
    source, entry, args = stub[-1]
    assert (source, entry) == (fa._SOURCE[impl], f"repro_{fa._SOURCE[impl]}")
    # an input needs a gradient: the forward writes the logsumexp
    sq, sk, sv, lse = out.grad_fn.saved_tensors
    assert all(a is b for a, b in zip((sq, sk, sv), (q, k, v)))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, 4, 10)
    assert args[4] == lse.data_ptr()
    dout = torch.zeros_like(out)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    source, entry, args = stub[-1]
    assert (source, entry) == (fa._BWD_SOURCE[impl],
                               f"repro_{fa._BWD_SOURCE[impl]}")
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lse.data_ptr())
    assert args[5:8] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[9:] == (1, 4, 2, 10, 12, 16, 1, 5, 1 / math.sqrt(16), 0)
    for g, t in zip((dq, dk, dv), (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
    assert {key: n for key, n in ops.launch_counts().items() if n} == {
        "flash_attention": 1, f"flash_attention:{impl}": 1,
        fa.BWD_KERNEL: 1, f"{fa.BWD_KERNEL}:{impl}": 1}


def test_no_gradient_no_logsumexp(stub):
    """Serving's forward (no input needs a gradient) writes no
    logsumexp: a null pointer, and nothing saved for a backward."""
    q, k, v = _qkv(torch.bfloat16)
    out = fa.FlashAttention.apply(q, k, v, True, 0)
    assert out.grad_fn is None
    assert stub[-1][2][4] is None
    assert fa.forward_cuda(q, k, v)[1] is None


def test_ops_sends_cuda_tensors_through_flash_attention(stub, monkeypatch):
    """On CUDA operands ``ops.flash_attention`` takes `FlashAttention`:
    its gradient is the backward kernel's (the dispatch is stood in for,
    as the host has no card)."""
    monkeypatch.setattr(ops, "impl_for", lambda *a: "cuda")
    q, k, v = (t.requires_grad_() for t in _qkv(torch.bfloat16))
    out = ops.flash_attention(q, k, v, window=3)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    torch.autograd.grad(out, (q, k, v), torch.zeros_like(out))
    assert [c[0] for c in stub] == ["flash_attention_tc",
                                    "flash_attention_bwd_tc"]
