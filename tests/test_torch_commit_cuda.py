"""The ``arena_commit`` CUDA kernel on the card, both kinds, held bitwise
to its plain PyTorch version (integer results: there is no tolerance):
arena rows, counter and sizes on all-ones, all-zero and random batches
at B 1, 255, 256, 257, 511 and 1,024 and at ragged widths (n 1, 7, 9,
15, 16, 17, 4,099), past the kernel's 4,096 rows a launch, at the main
path's shape (B 256 x n 334,863) into an arena slice at a row lo != 0,
with stale values in sizes; then the fused extender on a store whose
arena grows between batches, one launch a batch and no PyTorch
reduction in the step.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed (from the repo root, with ``PYTHONPATH=src``):
``python -m pytest -q -m cuda tests/test_torch_commit_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.fused import _ArenaFused  # noqa: E402
from repro_torch.core.store import make_store  # noqa: E402
from repro_torch.kernels import commit, ops  # noqa: E402

pytestmark = pytest.mark.cuda

KINDS = {"bitmap": commit.arena_commit_plain,
         "packed": commit.arena_commit_packed_plain}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(B, n, fill, seed):
    """A (B, n) view of a row-padded uint8 batch: all ones, all zeros or
    rows of mixed density (one empty, one full); pad bytes hold 1s that
    the kernel must not count or copy."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.ones((B, ops.padded_width(n)), dtype=torch.uint8,
                     device="cuda")
    if fill == "zeros":
        buf[:, :n] = 0
    elif fill == "random":
        dens = torch.rand((B, 1), generator=gen, device="cuda")
        buf[:, :n] = (torch.rand((B, n), generator=gen, device="cuda")
                      < dens).to(torch.uint8)
        buf[0, :n] = 0
    return buf[:, :n]


def _width(kind, n):
    return n if kind == "bitmap" else -(-n // 8)


def _agree(kind, rows, lo=0, cap=None):
    """Commit ``rows`` into rows [lo, lo + B) of an arena of ``cap`` rows
    with the kernel and with the plain version; arena, counter and sizes
    (stale before the call) must be equal."""
    B, n = rows.shape
    w = _width(kind, n)
    cap = cap or lo + B
    gen = torch.Generator(device="cuda").manual_seed(B + n)
    arena = torch.zeros((cap, ops.padded_width(w)), dtype=torch.uint8,
                        device="cuda")
    counter = torch.randint(0, 50, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
    sizes = torch.randint(-9, 9, (cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    want = [t.clone() for t in (arena, counter, sizes)]
    ops.arena_commit(rows, arena[lo:lo + B, :w], counter, kind=kind,
                     sizes=sizes[lo:lo + B])
    KINDS[kind](rows, want[0][lo:lo + B, :w], want[1], want[2][lo:lo + B])
    torch.cuda.synchronize()
    assert torch.equal(arena, want[0])
    assert torch.equal(counter, want[1])
    assert torch.equal(sizes, want[2])
    return arena, counter, sizes


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("B", [1, 255, 256, 257, 511, 1024])
@pytest.mark.parametrize("n", [1, 7, 9, 15, 16, 17, 4099])
@pytest.mark.parametrize("fill", ["ones", "zeros", "random"])
def test_kernel_matches_plain(cuda, kind, B, n, fill):
    rows = _batch(B, n, fill, seed=B * 7 + n)
    _, _, sizes = _agree(kind, rows, lo=3, cap=B + 5)
    if fill == "ones":
        assert bool((sizes[3:3 + B] == n).all())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rows_past_one_launch(cuda, kind):
    """4,097 rows and more: the launch runs 4,096 rows at a time."""
    _agree(kind, _batch(9000, 1500, "random", seed=5), lo=17)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_main_path_shape(cuda, kind):
    """B 256 x com-Amazon's n, into rows [300, 556) of a 1,024-row arena;
    without sizes, only the arena and the counter change."""
    rows = _batch(256, 334_863, "random", seed=1)
    _agree(kind, rows, lo=300, cap=1024)
    w = _width(kind, rows.shape[1])
    arena = torch.zeros((256, ops.padded_width(w)), dtype=torch.uint8,
                        device="cuda")
    counter = torch.zeros(rows.shape[1], dtype=torch.int32, device="cuda")
    ops.arena_commit(rows, arena[:, :w], counter, kind=kind)
    assert torch.equal(counter, rows.sum(dim=0, dtype=torch.int32))


def _kernel_name(kind):
    return commit.KERNEL if kind == "bitmap" else commit.KERNEL_PACKED


def _sampler(batches):
    it = iter(batches)
    return lambda key: (next(it), None, None)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_extender_on_a_growing_arena(cuda, kind):
    """Batches of 300 rows through `_ArenaFused.extend_once`: the arena
    grows (16 -> 512 -> 1,024 rows) and the second batch lands at row 300;
    the store equals one written by `add_batch` on the CPU.  A step is one
    kernel launch and starts no PyTorch reduction on the card."""
    n, B = 4099, 300
    batches = [_batch(B, n, "random", seed=s) for s in range(3)]
    st = make_store(kind, n)
    ref = make_store(kind, n, device="cpu")
    fused = _ArenaFused(st, _sampler(batches), B, sampler_name="test")
    for rows in batches[:2]:
        fused.extend_once(None)
        ref.add_batch(rows.cpu())
    st._grow_rows(st.count + B)           # the profiled step grows nothing
    key = f"kernels.dispatch{{impl=cuda,kernel={_kernel_name(kind)}}}"
    before = ops.launch_counts().get(_kernel_name(kind), 0)
    obs.reset()
    obs.enable()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fused.extend_once(None)
            torch.cuda.synchronize()
        dispatched = obs.snapshot()["counters"][key]
    finally:
        obs.reset()
    ref.add_batch(batches[2].cpu())
    assert dispatched == 1
    assert ops.launch_counts()[_kernel_name(kind)] == before + 1
    kernels = {e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("commit_kernel" in k for k in kernels), kernels
    assert all("commit_kernel" in k or "emset" in k for k in kernels), kernels
    assert st.count == ref.count == 3 * B
    for name in ("R", "counter", "sizes"):
        assert torch.equal(getattr(st, name).cpu(), getattr(ref, name)), name


def test_sizes_must_match_the_batch(cuda):
    rows = _batch(4, 17, "ones", seed=0)
    arena = torch.zeros((4, 32), dtype=torch.uint8, device="cuda")
    counter = torch.zeros(17, dtype=torch.int32, device="cuda")
    for bad in (torch.zeros(5, dtype=torch.int32, device="cuda"),
                torch.zeros(8, dtype=torch.int32, device="cuda")[::2]):
        with pytest.raises((ValueError, TypeError), match="sizes"):
            ops.arena_commit(rows, arena[:, :17], counter, sizes=bad)
