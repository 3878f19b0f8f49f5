"""The ``ic_frontier_step`` CUDA kernel on the card, held bitwise to its
plain PyTorch version on the same inputs (the order of summation is the
contract, so there is no tolerance): ragged batch and vertex counts up to
B 256 x n 16,384, frontier densities from empty to full, a dense logq and
one with ``-0.0`` entries, row blocks at odd strides and offsets, coins
on the threshold; the launch count, the checks and a refused launch.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed (from the repo root, with ``PYTHONPATH=src``):
``python -m pytest -q -m cuda tests/test_torch_frontier_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _common as C  # noqa: E402
from repro_torch.kernels import ic_frontier as icf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _logq(n, per_col, gen, *, signed_zeros=False):
    """An (n, n) log(1-p) table with about ``per_col`` nonzeros a column
    (every entry when ``per_col >= n``), clamped at -30 as the samplers'
    are; ``signed_zeros`` writes -0.0 over a third of the entries."""
    if per_col >= n:
        L = torch.log1p(-torch.rand((n, n), generator=gen, device="cuda"))
    else:
        L = torch.zeros((n, n), device="cuda")
        rows = torch.randint(0, n, (per_col * n,), generator=gen,
                             device="cuda")
        cols = torch.arange(n, device="cuda").repeat(per_col)
        L[rows, cols] = torch.log1p(-torch.rand(per_col * n, generator=gen,
                                                device="cuda"))
    L.clamp_(min=-30.0)
    if signed_zeros:
        L[torch.rand((n, n), generator=gen, device="cuda") < 0.33] = -0.0
    return L


def _inputs(B, n, density, gen, *, ld=None, offset=0):
    """frontier, visited and rand as ``(B, n)`` views of buffers of row
    stride ``ld`` (default: the padded width) starting ``offset`` bytes
    (elements for rand) into their storage."""
    ld = ops.padded_width(n) if ld is None else ld

    def block(dtype):
        buf = torch.zeros(offset + B * ld + 16, dtype=dtype, device="cuda")
        return torch.as_strided(buf, (B, n), (ld, 1), offset)

    F, V, R = block(torch.bool), block(torch.bool), block(torch.float32)
    F.copy_(torch.rand((B, n), generator=gen, device="cuda") < density)
    V.copy_((torch.rand((B, n), generator=gen, device="cuda") < 0.2) | F)
    R.copy_(torch.rand((B, n), generator=gen, device="cuda"))
    return F, V, R


def _agree(F, V, L, R, cols=None):
    ops.reset_launches()
    got = ops.ic_frontier_step(F, V, L, R, cols=cols)
    assert ops.launch_counts().get(icf.KERNEL) == 1
    want = icf.ic_frontier_step_plain(F, V, L, R, cols)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.stride(0) == ops.padded_width(
        F.shape[1])
    assert torch.equal(got, want), int((got != want).sum())
    whole = torch.as_strided(got, (got.shape[0], got.stride(0)),
                             (got.stride(0), 1))
    assert int(whole[:, F.shape[1]:].sum()) == 0
    return got


_LOGQS = {}


def _table(n):
    """One logq per n (the large ones sparse, as a graph's are)."""
    if n not in _LOGQS:
        _LOGQS[n] = _logq(n, n if n <= 513 else 32, _gen(n))
    return _LOGQS[n]


@pytest.mark.parametrize("n", [1, 7, 129, 513, 4099, 16_384])
@pytest.mark.parametrize("B", [1, 3, 70, 256])
def test_kernel_is_the_plain_version_bitwise(cuda, B, n):
    F, V, R = _inputs(B, n, 0.3, _gen(B * n))
    L = _table(n)
    got = _agree(F, V, L, R)
    # a prebuilt form gives the same bits
    assert torch.equal(ops.ic_frontier_step(F, V, L, R,
                                            cols=icf.column_form(L)), got)


@pytest.mark.parametrize("density", [0.0, 0.001, 0.3, 1.0])
@pytest.mark.parametrize("B,n", [(70, 513), (256, 4099)])
def test_frontier_densities(cuda, B, n, density):
    F, V, R = _inputs(B, n, density, _gen(int(density * 1000) + n))
    if density == 1.0:
        V.copy_(torch.rand((B, n), generator=_gen(1), device="cuda") < 0.2)
    got = _agree(F, V, _table(n), R)
    if density == 0.0:
        assert int(got.sum()) == 0


@pytest.mark.parametrize("n", [129, 4099])
@pytest.mark.parametrize("kind", ["dense", "signed_zeros"])
def test_dense_logq_and_signed_zeros(cuda, n, kind):
    gen = _gen(n + len(kind))
    L = _logq(n, n, gen, signed_zeros=kind == "signed_zeros")
    F, V, R = _inputs(256, n, 0.3, gen)
    cols = icf.column_form(L)
    assert cols.nnz == int((L != 0).sum())
    _agree(F, V, L, R, cols)


@pytest.mark.parametrize("ld,offset", [(520, 0), (515, 3), (1000, 17),
                                       (513, 0)])
def test_strided_and_offset_row_blocks(cuda, ld, offset):
    n = 513
    F, V, R = _inputs(70, n, 0.3, _gen(ld + offset), ld=ld, offset=offset)
    got = _agree(F, V, _table(n), R)
    want = ops.ic_frontier_step(F.contiguous(), V.contiguous(), _table(n),
                                R.contiguous())
    assert torch.equal(got, want)


def _spread_form(n, per_col, gen):
    """A column form with ``per_col`` nonzeros in every column, spread
    over all of ``[0, n)``, built without a dense logq."""
    gap = n // per_col
    start = torch.randint(0, gap, (n, 1), generator=gen, device="cuda")
    rows = (start + gap * torch.arange(per_col, device="cuda")).to(
        torch.int32).reshape(-1)
    vals = torch.log1p(-torch.rand(n * per_col, generator=gen,
                                   device="cuda"))
    col_ptr = (per_col * torch.arange(n + 1, device="cuda")).to(torch.int32)
    return icf.ColumnForm(col_ptr, rows, vals, n, n * per_col)


@pytest.mark.parametrize("n", [49_153, 100_000])
def test_vertex_chunks(cuda, n):
    """Past 49,152 vertices the kernel stages the frontier in chunks and
    carries each sum across them; the form, built directly, is the
    whole table (no dense logq, ``logq=None``)."""
    gen = _gen(n)
    cols = _spread_form(n, 6, gen)
    F, V, R = _inputs(40, n, 0.3, gen)
    _agree(F, V, None, R, cols)


def test_coins_on_the_threshold(cuda):
    """rand = p fires no coin, p's lower f32 neighbour fires every live
    cell, its upper one none."""
    n = 4099
    L = _table(n)
    F, V, _ = _inputs(256, n, 0.01, _gen(5))
    V.zero_()
    cols = icf.column_form(L)
    p = torch.expm1(icf.ascending_acc(F, L, cols).double()).neg_().float()
    live = p > 0
    assert int(live.sum()) > 0
    for shift, fires in ((0.0, False), (-1.0, True), (1.0, False)):
        R = p if not shift else torch.nextafter(
            p, torch.full_like(p, shift * float("inf")))
        got = _agree(F, V, L, R.contiguous(), cols)
        assert bool((got[live.nonzero(as_tuple=True)] == fires).all()), shift


def test_checks_and_a_refused_launch(cuda):
    n = 64
    L = _logq(n, 8, _gen(2))
    F, V, R = _inputs(4, n, 0.3, _gen(3))
    with pytest.raises(ValueError, match="does not fit"):
        ops.ic_frontier_step(F, V, L, R, cols=icf.column_form(_table(129)))
    with pytest.raises(ValueError, match="contiguous on cuda"):
        ops.ic_frontier_step(F, V, L, R, cols=icf.column_form(L.cpu()))
    stale = icf.column_form(L)
    L[0, 0] = -0.5
    with pytest.raises(ValueError, match="not the column form"):
        ops.ic_frontier_step(F, V, L, R, cols=stale)
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        big = torch.zeros((32 * 65535 + 1, 1), dtype=torch.uint8,
                          device="cuda")
        icf.ic_frontier_step_cuda(big, big, torch.zeros((1, 1),
                                                        device="cuda"),
                                  big.float())
    # the C entry point reports a launch the card refuses (a grid of
    # 65,537 row tiles); the wrapper raises on it and counts nothing
    cols = icf.column_form(L)
    words = torch.zeros((1, n), dtype=torch.int32, device="cuda")
    with C.on_device(icf.KERNEL, F, V, R) as stream:
        err = icf._step_entry()(
            F.data_ptr(), 0, V.data_ptr(), 0, cols.col_ptr.data_ptr(),
            cols.rows.data_ptr(), cols.vals.data_ptr(), R.data_ptr(), 0,
            F.data_ptr(), 0, words.data_ptr(), n, 32 * 65536 + 1, n, n,
            stream)
    assert err != 0
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        C.launched(icf.KERNEL, err)
    assert ops.launch_counts().get(icf.KERNEL, 0) == 0
    torch.cuda.synchronize()
    _agree(F, V, L, R)
