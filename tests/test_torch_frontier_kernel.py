"""The port's ic_frontier_step (plain version, the CPU path of the kernel)
against a literal ascending-order loop (bitwise) and against the JAX
package's kernel in interpret mode and its oracle (equal up to near-ties,
which are counted and printed), on ragged shapes, row-padded views and
coins placed on the threshold; logq's column form against a Python loop,
the wrapper's checks of it, and the dense sampler building it once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ic_frontier import (  # noqa: E402
    ic_frontier_step as jfrontier,
)
from repro_torch import prng  # noqa: E402
from repro_torch.core import sampler, ties  # noqa: E402
from repro_torch.core.engine import IMMConfig  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels import ic_frontier as icf  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _logq(rng, n, density):
    """An (n, n) log(1-p) table with ``density`` nonzeros (the others the
    -0.0 that log1p(-0) gives), clamped at -30 like the samplers'."""
    p = rng.uniform(size=(n, n)).astype(np.float32)
    p[rng.uniform(size=(n, n)) >= density] = 0.0
    with np.errstate(divide="ignore"):
        L = np.log1p(-p.astype(np.float64)).astype(np.float32)
    return np.maximum(L, np.float32(-30.0))


def _inputs(seed, B, n, *, f_density=0.3, q_density=0.2):
    rng = np.random.default_rng(seed)
    F = rng.uniform(size=(B, n)) < f_density
    V = (rng.uniform(size=(B, n)) < 0.2) | F
    R = rng.uniform(size=(B, n)).astype(np.float32)
    return F, V, _logq(rng, n, q_density), R


def _padded(a: np.ndarray) -> torch.Tensor:
    rows, n = a.shape
    buf = torch.zeros((rows, ops.padded_width(n)), dtype=torch.bool)
    buf[:, :n] = torch.from_numpy(a)
    return buf[:, :n]


def _ascending_acc(F, L):
    """The contract's sum, literally: float32, ascending v, one term at a
    time, from +0.0."""
    B, n = F.shape
    acc = np.zeros((B, n), np.float32)
    for v in range(n):
        acc[F[:, v]] = acc[F[:, v]] + L[v][None, :]
    return acc


def _port(F, V, L, R, padded=False):
    wrap = _padded if padded else torch.from_numpy
    return ops.ic_frontier_step(wrap(F), wrap(V), torch.from_numpy(L),
                                torch.from_numpy(R)).numpy().astype(bool)


@pytest.mark.parametrize("B,n", [(1, 1), (3, 7), (5, 33), (16, 64),
                                 (2, 64)])
@pytest.mark.parametrize("q_density", [0.1, 1.0])
def test_plain_matches_dense_ascending_loop(B, n, q_density):
    F, V, L, R = _inputs(B * 100 + n, B, n, f_density=0.5,
                         q_density=q_density)
    acc = _ascending_acc(F, L)
    want = icf.activation(torch.from_numpy(acc), torch.from_numpy(R),
                          torch.from_numpy(V)).numpy()
    got = ops.ic_frontier_step(torch.from_numpy(F), torch.from_numpy(V),
                               torch.from_numpy(L), torch.from_numpy(R))
    assert got.dtype == torch.uint8 and got.stride(0) == ops.padded_width(n)
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    # a column form built once by the caller gives the same bits
    L_t = torch.from_numpy(L)
    again = ops.ic_frontier_step(torch.from_numpy(F), torch.from_numpy(V),
                                 L_t, torch.from_numpy(R),
                                 cols=icf.column_form(L_t))
    assert torch.equal(again, got)
    # the coins that fire are exactly rand < p on unvisited cells
    p = -np.expm1(acc.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(want, (R < p) & ~V)


def _form_by_loop(L):
    """logq's nonzeros column by column, ascending v, by a Python loop."""
    n = L.shape[0]
    ptr, rows, vals = [0], [], []
    for u in range(n):
        for v in range(n):
            if L[v, u] != 0:
                rows.append(v)
                vals.append(L[v, u])
        ptr.append(len(rows))
    return ptr, rows, np.asarray(vals, np.float32)


def _form_case(name):
    rng = np.random.default_rng(len(name))
    if name == "n1":
        return np.array([[-0.5]], np.float32)
    if name == "n1_zero":
        return np.array([[-0.0]], np.float32)
    L = _logq(rng, 9, 0.3)
    if name == "empty_columns":
        L[:, [0, 4, 8]] = 0.0
    elif name == "full_column":
        L[:, 3] = -rng.uniform(0.1, 1.0, 9).astype(np.float32)
    elif name == "signed_zeros":
        L[::2, :] = -0.0
        L[1::4, :] = 0.0
        assert np.signbit(L).any() and (L == 0).any()
    return L


@pytest.mark.parametrize("name", ["random", "empty_columns", "full_column",
                                  "signed_zeros", "n1", "n1_zero"])
def test_column_form_matches_a_python_loop(name):
    L = _form_case(name)
    cols = icf.column_form(torch.from_numpy(L))
    ptr, rows, vals = _form_by_loop(L)
    assert (cols.n, cols.nnz) == (L.shape[0], len(rows))
    assert (cols.col_ptr.dtype, cols.rows.dtype, cols.vals.dtype) == (
        torch.int32, torch.int32, torch.float32)
    assert cols.col_ptr.tolist() == ptr and cols.rows.tolist() == rows
    np.testing.assert_array_equal(cols.vals.numpy().view(np.int32),
                                  vals.view(np.int32))
    assert (cols.vals != 0).all() and cols.nbytes == 4 * (L.shape[0] + 1
                                                          + 2 * len(rows))
    # the rank groups of the plain version hold the same entries
    got = sorted((int(u), int(v), float(q)) for g in cols.terms
                 for u, v, q in zip(*g))
    want = sorted((u, rows[i], float(vals[i])) for u in range(L.shape[0])
                  for i in range(ptr[u], ptr[u + 1]))
    assert got == want


@pytest.mark.parametrize("n", [1, 7, 129, 513])
@pytest.mark.parametrize("B", [1, 3, 70])
def test_plain_on_prebuilt_and_per_call_forms(B, n):
    """The plain version on a form built once, on one built per call and
    the dense ascending loop: bitwise, on row-padded operands."""
    F, V, L, R = _inputs(B * 1000 + n, B, n, f_density=0.3, q_density=0.05)
    L_t = torch.from_numpy(L)
    args = (_padded(F), _padded(V), L_t, torch.from_numpy(R))
    per_call = ops.ic_frontier_step(*args)
    prebuilt = ops.ic_frontier_step(*args, cols=icf.column_form(L_t))
    assert torch.equal(per_call, prebuilt)
    want = icf.activation(torch.from_numpy(_ascending_acc(F, L)),
                          torch.from_numpy(R), torch.from_numpy(V))
    np.testing.assert_array_equal(prebuilt.numpy().astype(bool),
                                  want.numpy())


def test_wrapper_refuses_a_form_that_does_not_fit():
    F, V, L, R = _inputs(5, 4, 16)
    args = (torch.from_numpy(F), torch.from_numpy(V), torch.from_numpy(L),
            torch.from_numpy(R))
    other = icf.column_form(torch.from_numpy(_inputs(6, 4, 17)[2]))
    with pytest.raises(ValueError, match="does not fit"):
        ops.ic_frontier_step(*args, cols=other)
    cols = icf.column_form(args[2])
    meta = icf.ColumnForm(cols.col_ptr.to("meta"), cols.rows.to("meta"),
                          cols.vals.to("meta"), cols.n, cols.nnz)
    with pytest.raises(ValueError, match="contiguous on cpu"):
        ops.ic_frontier_step(*args, cols=meta)
    wide = icf.ColumnForm(cols.col_ptr, cols.rows.long(), cols.vals,
                          cols.n, cols.nnz)
    with pytest.raises(TypeError, match="int32 col_ptr"):
        ops.ic_frontier_step(*args, cols=wide)
    with pytest.raises(TypeError, match="ColumnForm"):
        ops.ic_frontier_step(*args, cols=icf.column_terms(cols))


@pytest.mark.parametrize("case", ["other_table", "written_since",
                                  "hand_built"])
def test_wrapper_refuses_a_form_of_another_logq(case):
    """Given logq and a form, the form must be the one built from that
    logq as it stands: the kernel reads only the form, so a stale or
    foreign form of the same n would give other bits with no error.
    Without logq the form alone is the table."""
    F, V, L, R = _inputs(8, 4, 16, q_density=0.3)
    L_t = torch.from_numpy(L.copy())
    args = (torch.from_numpy(F), torch.from_numpy(V), L_t,
            torch.from_numpy(R))
    cols = icf.column_form(L_t)
    want = ops.ic_frontier_step(*args, cols=cols)
    if case == "other_table":
        bad = icf.column_form(torch.from_numpy(
            _inputs(9, 4, 16, q_density=0.3)[2]))
    elif case == "written_since":
        bad = cols
        L_t[0, 1] = -0.25
    else:
        bad = icf.ColumnForm(cols.col_ptr, cols.rows, cols.vals, cols.n,
                             cols.nnz)
    for step in (ops.ic_frontier_step, icf.ic_frontier_step_plain):
        with pytest.raises(ValueError, match="not the column form"):
            step(*args, cols=bad)
    alone = ops.ic_frontier_step(args[0], args[1], None, args[3], cols=bad)
    if case == "hand_built":
        assert torch.equal(alone, want)
    with pytest.raises(ValueError, match="logq or its column form"):
        ops.ic_frontier_step(args[0], args[1], None, args[3])


@pytest.mark.parametrize("stable", [False, True])
def test_bind_dense_builds_the_form_once(monkeypatch, stable):
    """The pallas backend builds logq's column form once per bound
    sampler and hands it to every BFS step; the dense backend builds
    none."""
    built, seen = [], []
    real_form, real_step = sampler.column_form, ops.ic_frontier_step

    def counting_form(logq):
        built.append(real_form(logq))
        return built[-1]

    def recording_step(*args, cols=None):
        seen.append(cols)
        return real_step(*args, cols=cols)

    monkeypatch.setattr(sampler, "column_form", counting_form)
    monkeypatch.setattr(ops, "ic_frontier_step", recording_step)
    g = generators.rmat_graph(96, 600, seed=3)
    cfg = IMMConfig(batch=8)
    model = sampler.get_model("IC")
    sample = sampler._bind_pallas(model, g, cfg, stable=stable,
                                  placement=None)
    assert len(built) == 1 and sample.cols is built[0]
    for i in range(2):
        sample(prng.split(prng.PRNGKey(i), 2)[1])
    assert len(built) == 1 and len(seen) > 2
    assert all(c is built[0] for c in seen)
    dense = sampler._bind_dense(model, g, cfg, stable=stable, placement=None)
    assert len(built) == 1 and dense.cols is None


@pytest.mark.parametrize("B,n", [(1, 1), (3, 17), (70, 129), (64, 300),
                                 (128, 512)])
def test_plain_matches_jax_up_to_near_ties(B, n):
    F, V, L, R = _inputs(7 * B + n, B, n)
    got = _port(F, V, L, R)
    args = (jnp.asarray(F), jnp.asarray(V), jnp.asarray(L), jnp.asarray(R))
    for name, want in (
            ("interpret", np.asarray(jfrontier(*args, interpret=True))),
            ("oracle", np.asarray(jref.ic_frontier_ref(*args)))):
        b, u = np.nonzero(got != want.astype(bool))
        _, tie = ties.classify_cells(F, L, R, b, u)
        print(f"B={B} n={n} vs JAX {name}: {b.size} of {B * n} cells "
              f"differ, {int(tie.sum())} near-ties")
        assert tie.all(), list(zip(b[~tie], u[~tie]))


@pytest.mark.parametrize("B,n", [(3, 17), (33, 200)])
def test_row_padded_and_contiguous_operands_agree(B, n):
    F, V, L, R = _inputs(B + n, B, n)
    np.testing.assert_array_equal(_port(F, V, L, R, padded=True),
                                  _port(F, V, L, R))
    assert ref.ic_frontier_ref is icf.ic_frontier_step_plain


def test_coins_on_the_threshold():
    """rand = p fires no coin, its lower f32 neighbour fires, its upper
    one does not; JAX (f32 expm1, its own sum order) may land on either
    side of these cells, and every such difference is a near-tie."""
    B, n = 6, 96
    F, V, L, _ = _inputs(11, B, n, f_density=0.4, q_density=0.5)
    V[:] = False
    p = -np.expm1(_ascending_acc(F, L).astype(np.float64)).astype(np.float32)
    live = p > 0
    for shift, fires in ((0, False), (-1, True), (1, False)):
        R = p.copy()
        if shift:
            R = np.nextafter(p, np.float32(shift * np.inf)).astype(np.float32)
        got = _port(F, V, L, R)
        assert (got[live] == fires).all(), shift
        want = np.asarray(jref.ic_frontier_ref(
            jnp.asarray(F), jnp.asarray(V), jnp.asarray(L), jnp.asarray(R)))
        b, u = np.nonzero(got != want)
        _, tie = ties.classify_cells(F, L, R, b, u)
        print(f"rand = p {shift:+d} ulp: {int(live.sum())} live cells, "
              f"{b.size} differ from JAX, {int(tie.sum())} near-ties")
        assert tie.all()


def test_classifier_rejects_a_far_flip():
    F, V, L, R = _inputs(3, 4, 40, q_density=0.5)
    p = ties.p64(F, L, np.arange(4), np.zeros(4, int))
    far = np.float32(np.clip(p[0] + 0.25, 0, 0.999))
    R[0, 0] = far
    _, tie = ties.classify_cells(F, L, R, np.array([0]), np.array([0]))
    assert not tie.any()
    R[0, 0] = np.float32(p[0])
    _, tie = ties.classify_cells(F, L, R, np.array([0]), np.array([0]))
    assert tie.all()


def test_non_cpu_operands_never_take_the_plain_version():
    F = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    L = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError, match="operands on"):
        ops.ic_frontier_step(F, F, L, torch.zeros((4, 16), device="meta"))
    with pytest.raises(ValueError, match="operands on"):
        cpu = torch.zeros((4, 16), dtype=torch.uint8)
        ops.ic_frontier_step(cpu, cpu, L, torch.zeros((4, 16)))


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (70, 129), (48, 512)])
def test_uniform_draw_is_jax_uniform(shape):
    """The dense backends' positional draw (``uniform_draw`` on the
    card): on the CPU the plain threefry, bitwise ``jax.random.uniform``."""
    key = prng.split(prng.PRNGKey(sum(shape)), 2)[1]
    got = ops.uniform(key, shape, device="cpu")
    want = jax.random.uniform(jnp.asarray(key), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="operands on"):
        ops.uniform(key, shape, device="meta")
