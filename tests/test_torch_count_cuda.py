"""The ``packed_count`` and ``token_count`` CUDA kernels on the card, held
bitwise to their plain PyTorch versions and to ``coverage_matvec_plain``
over the decoded rows (integer sums: there is no tolerance): a row of
s_pad real tokens and no sentinel, rows of runs only, a run in the last
superblock, hub columns (count = theta, also past 65,535), columns on
every span and tile edge and rows across every chunk edge, n = 1 mod 8,
theta not a multiple of 32, dead rows and all rows dead, bool and float
``alive``, the stores' own ``st.R`` views and token rows at odd strides
and offsets; the launch count and the checks.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed (from the repo root, with ``PYTHONPATH=src``):
``python -m pytest -q -m cuda tests/test_torch_count_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pack import codec as pc  # noqa: E402
from repro_torch.core.store import make_store, next_pow2  # noqa: E402
from repro_torch.kernels import coverage_matvec as cov  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packed_count as pcm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _rows(theta, n, p, gen):
    """``(theta, n)`` 0/1 uint8 rows, a fraction ``p`` of them set."""
    return (torch.rand((theta, n), generator=gen, device="cuda")
            < p).to(torch.uint8)


def _encode(R):
    """R bit-packed into a row-padded arena view, and as tokens at the
    smallest power-of-two s_pad that holds every row."""
    theta, n = R.shape
    nb = pc.n_bytes_for(n)
    buf = torch.zeros((theta, ops.padded_width(nb)), dtype=torch.uint8,
                      device="cuda")
    buf[:, :nb] = pc.pack_bits(R)
    need = int(pc.tokens_needed(R).max()) if theta else 0
    return buf[:, :nb], pc.token_encode(R, next_pow2(need, pc.MIN_TOKEN_PAD))


def _alives(theta, gen):
    some = torch.rand(theta, generator=gen, device="cuda") < 0.7
    return {"some": some, "none": torch.zeros_like(some),
            "all": torch.ones_like(some), "float": some.to(torch.float32)}


def _agree(R, P, T, alive):
    n = R.shape[1]
    want = cov.coverage_matvec_plain(alive, R).to(torch.int32)
    got_p = ops.packed_count(P, alive, n=n)
    got_t = ops.token_count(T, alive, n=n)
    torch.cuda.synchronize()
    assert got_p.dtype == got_t.dtype == torch.int32
    assert torch.equal(got_p, pcm.packed_count_plain(P, alive, n))
    assert torch.equal(got_t, pcm.token_count_plain(T, alive, n))
    assert torch.equal(got_p, want) and torch.equal(got_t, want)
    return got_t


def _edge(kind, gen):
    if kind == "no_sentinel":          # 64 literals a row: s_pad 64, full
        R = torch.zeros((37, 512), dtype=torch.uint8, device="cuda")
        R[:, ::8] = 1
    elif kind == "runs_only":           # 8 runs a row, and empty rows
        R = torch.zeros((50, 2048), dtype=torch.uint8, device="cuda")
        R[::2] = 1
    elif kind == "last_superblock_run":
        R = _rows(40, 2304, 0.2, gen)
        R[1::3, -256:] = 1
    elif kind == "hub_columns":
        R = _rows(1000, 5000, 0.05, gen)
        R[:, [0, 1234, 4999]] = 1
    elif kind == "span_edges":          # both sides of every 4,096 columns
        n = 5 * 8192 + 3
        R = _rows(600, n, 0.02, gen)
        R[:, [c for k in range(0, n + 1, 4096) for c in (k - 1, k, k + 1)
              if 0 <= c < n]] = 1
    elif kind == "n_1_mod_8":
        R = _rows(300, 4097, 0.3, gen)
    elif kind == "theta_1013":
        R = _rows(1013, 3000, 0.1, gen)
    else:                               # dense rows past one span's bytes
        R = _rows(257, 20000, 0.35, gen)
        R[::5] = 0
    return R


EDGES = ("no_sentinel", "runs_only", "last_superblock_run", "hub_columns",
         "span_edges", "n_1_mod_8", "theta_1013", "dense")


@pytest.mark.parametrize("kind", EDGES)
@pytest.mark.parametrize("alive", ["some", "none", "all", "float"])
def test_edge_arenas(cuda, kind, alive):
    gen = _gen(EDGES.index(kind))
    R = _edge(kind, gen)
    P, T = _encode(R)
    if kind == "no_sentinel":
        assert T.shape[1] == 64
        assert not bool((T == pc.token_sentinel(R.shape[1])).any())
    if kind in ("runs_only", "last_superblock_run"):
        assert bool(((T & 511) == pc.SAT_CODE).any())
    got = _agree(R, P, T, _alives(R.shape[0], gen)[alive])
    if kind == "hub_columns" and alive == "all":
        assert int(got[1234]) == R.shape[0]


def test_hub_count_past_65535(cuda):
    """Counts are int32 all the way: a column set in 300,001 rows, which
    also gives token_count's row chunks more rows than it holds in
    shared memory at once (kMaxRows), with runs in some of them."""
    gen = _gen(11)
    R = _rows(300001, 300, 0.01, gen)
    R[:, 77] = 1
    R[::1000, :256] = 1
    P, T = _encode(R)
    alive = _alives(R.shape[0], gen)
    assert int(_agree(R, P, T, alive["all"])[77]) == 300001
    _agree(R, P, T, alive["some"])


@pytest.mark.parametrize("kind", ["packed", "compressed"])
def test_store_views(cuda, kind):
    """The arenas as the stores hold them: ``st.R`` over every capacity
    row, with the padding rows alive too, and the store's valid mask."""
    gen = _gen(3)
    R = _rows(300, 4097, 0.3, gen)
    R[7] = 1
    st = make_store(kind, 4097)
    for s in range(0, 300, 128):
        st.add_batch(R[s:s + 128])
    assert st.R.device.type == "cuda" and st.capacity == 512
    full = torch.zeros((st.capacity, 4097), dtype=torch.uint8,
                       device="cuda")
    full[:300] = R
    count = ops.packed_count if kind == "packed" else ops.token_count
    plain = pcm.packed_count_plain if kind == "packed" \
        else pcm.token_count_plain
    for alive in (st.view().valid,
                  torch.ones(st.capacity, dtype=torch.bool, device="cuda")):
        got = count(st.R, alive, n=4097)
        assert torch.equal(got, plain(st.R, alive, 4097))
        assert torch.equal(got, cov.coverage_matvec_plain(alive, full)
                           .to(torch.int32))
        assert torch.equal(got, st.counter)


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("extra", [0, 3, 8])
def test_token_rows_at_odd_strides(cuda, offset, extra):
    """Token rows at a row stride of s_pad + extra starting ``offset``
    tokens into their storage (16-byte loads where both allow them)."""
    gen = _gen(offset * 10 + extra)
    R = _rows(70, 3000, 0.25, gen)
    R[3, :1024] = 1
    P, T = _encode(R)
    theta, s_pad = T.shape
    buf = torch.full((theta, s_pad + extra + offset), -7, dtype=torch.int32,
                     device="cuda")
    view = buf[:, offset:offset + s_pad]
    view.copy_(T)
    _agree(R, P, view, _alives(theta, gen)["some"])


def test_launches_and_checks(cuda):
    gen = _gen(5)
    R = _rows(64, 1000, 0.3, gen)
    P, T = _encode(R)
    alive = torch.ones(64, dtype=torch.bool, device="cuda")
    ops.reset_launches()
    ops.packed_count(P, alive, n=1000)
    ops.token_count(T, alive, n=1000)
    counts = ops.launch_counts()
    assert counts.get(pcm.KERNEL_PACKED) == 1
    assert counts.get(pcm.KERNEL_TOKEN) == 1
    with pytest.raises(ValueError, match="operands on"):
        ops.token_count(T, alive.cpu(), n=1000)
    with pytest.raises(ValueError, match="alive has shape"):
        ops.token_count(T, alive[:10], n=1000)
    with pytest.raises(ValueError, match="do not hold"):
        ops.packed_count(P, alive, n=2000)
    with pytest.raises(TypeError, match="int32 tokens"):
        ops.token_count(T.to(torch.int64), alive, n=1000)
    with pytest.raises(ValueError, match="unit column stride"):
        ops.token_count(T.t().contiguous().t(), alive, n=1000)
