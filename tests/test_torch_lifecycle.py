"""The row lifecycle of repro_torch's stores against the JAX package on
the CPU, bitwise: kill, replace (with -1 padding targets) and compact on
the bitmap, index, packed and compressed stores, each step held to the
reference store's ``state()``; pressure policies (row and byte caps,
staleness-first then FIFO eviction, the packed -> compressed ladder);
each store's ``_row_contrib`` (through the count kernels' plain versions
here) at a capacity the policy clamps to a non-power-of-two; and the two
places where the port keeps the policy's promise and the reference does
not (a batch written right after the ladder's morph, an arena whose
token rows widened under a byte cap)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import store as jstore  # noqa: E402
from repro.core.pack import stores as jpack  # noqa: F401,E402 (kinds)
from repro_torch.core import store  # noqa: E402
from repro_torch.core.pack.codec import token_decode  # noqa: E402

KINDS = ("bitmap", "indices", "packed", "compressed")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(rng, B, n, density):
    return (rng.random((B, n)) < density).astype(np.uint8)


def _pair(kind, n, **policy):
    jp = jstore.StorePressurePolicy(**policy) if policy else None
    tp = store.StorePressurePolicy(**policy) if policy else None
    return (jstore.make_store(kind, n, policy=jp),
            store.make_store(kind, n, policy=tp, device="cpu"))


def _same_state(js, ts):
    a, b = js.state(), ts.state()
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and np.array_equal(x, y), k
    assert (js.count, js.dead, js.capacity) == (ts.count, ts.dead,
                                                ts.capacity)
    assert js.representation == ts.representation


def _add(js, ts, rows):
    a = js.add_batch(jnp.asarray(rows))
    b = ts.add_batch(torch.from_numpy(rows))
    assert np.array_equal(a, b)


def _bits(ts):
    """The port store's arena as 0/1 rows."""
    R = ts.R
    if ts.representation == "bitmap":
        return R.numpy()
    if ts.representation == "indices":
        out = np.zeros((R.shape[0], ts.n + 1), np.uint8)
        out[np.arange(R.shape[0])[:, None], R.numpy()] = 1
        return out[:, :ts.n]
    return ts.codec.decode(R).numpy()


# -------------------------------------------------------------- policy ----

@pytest.mark.parametrize("kw,row_bytes", [
    ({}, 10), ({"max_rows": 40}, 10), ({"max_bytes": 1000}, 30),
    ({"max_rows": 40, "max_bytes": 1000}, 30),
    ({"max_rows": 400, "max_bytes": 1000}, 7)])
def test_policy_row_cap_matches_jax(kw, row_bytes):
    assert (store.StorePressurePolicy(**kw).row_cap(row_bytes)
            == jstore.StorePressurePolicy(**kw).row_cap(row_bytes))


def test_policy_refuses_a_cap_below_one_row():
    with pytest.raises(ValueError, match=">= 1 row"):
        store.StorePressurePolicy(max_bytes=10).row_cap(11)


@pytest.mark.parametrize("kind", ["bitmap", "packed", "compressed"])
@pytest.mark.parametrize("ladder", [(), ("packed",), ("compressed",),
                                    ("packed", "compressed"), ("bitmap",)])
def test_ladder_next_matches_jax(kind, ladder):
    assert store._ladder_next(kind, ladder) == jstore._ladder_next(kind,
                                                                   ladder)


def test_store_kinds_factory_and_protocol():
    for kind in KINDS:
        s = store.make_store(kind, 40, device="cpu",
                             policy=store.StorePressurePolicy(max_rows=20))
        assert isinstance(s, store.RRRStore)
        assert type(s) is store.STORE_KINDS[kind]
        assert s.row_cap == 20 and s.policy.max_rows == 20
    assert store.make_store("auto", 8, device="cpu").representation == \
        "bitmap"


# ----------------------------------------------------------- lifecycle ----

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_kill_replace_compact_match_jax(kind, seed):
    rng = np.random.default_rng(seed)
    n = 150
    js, ts = _pair(kind, n)
    for density in (0.02, 0.3, 0.05):
        _add(js, ts, _rows(rng, 24, n, density))
        _same_state(js, ts)
    dead = rng.random(js.capacity) < 0.3
    assert js.kill_rows(jnp.asarray(dead)) == ts.kill_rows(dead)
    _same_state(js, ts)
    # replace part of the dead rows, padded with -1 targets whose rows
    # are not zero: the store must neither write nor count them
    slots = np.flatnonzero(dead[:js.count])[:9]
    idx = np.concatenate([slots, np.full(16 - slots.size, -1)])
    fresh = _rows(rng, 16, n, 0.4)
    js.replace_rows(idx, jnp.asarray(fresh))
    ts.replace_rows(idx, torch.from_numpy(fresh))
    _same_state(js, ts)
    assert np.array_equal(ts.counter.numpy(), _bits(ts)[
        ts._valid().numpy()].sum(axis=0))
    js.track_remaps = ts.track_remaps = True
    ra, rb = js.compact(), ts.compact()
    assert np.array_equal(ra, rb)
    assert [r.tolist() for r in ts.drain_remaps()] == [rb.tolist()]
    _same_state(js, ts)
    assert js.compact() is None and ts.compact() is None
    _add(js, ts, _rows(rng, 24, n, 0.1))
    _same_state(js, ts)
    assert js.coverage_stats() == ts.coverage_stats()


@pytest.mark.parametrize("kind", KINDS)
def test_replace_rows_refuses_live_or_unfilled_targets(kind):
    rng = np.random.default_rng(3)
    _, ts = _pair(kind, 40)
    ts.add_batch(torch.from_numpy(_rows(rng, 8, 40, 0.2)))
    for idx in ([2], [8]):
        with pytest.raises(ValueError, match="dead slots"):
            ts.replace_rows(np.asarray(idx), torch.zeros((1, 40),
                                                         dtype=torch.uint8))
    before = ts.state()
    ts.replace_rows(np.asarray([-1, -1]), torch.ones((2, 40),
                                                     dtype=torch.uint8))
    assert all(np.array_equal(np.asarray(before[k]),
                              np.asarray(ts.state()[k])) for k in before)


@pytest.mark.parametrize("kind", KINDS)
def test_eviction_is_staleness_first_then_fifo_and_matches_jax(kind):
    rng = np.random.default_rng(4)
    n = 96
    js, ts = _pair(kind, n, max_rows=48)
    rows = _rows(rng, 48, n, 0.1)
    _add(js, ts, rows)
    dead = np.zeros(js.capacity, bool)
    dead[8:16] = True
    assert js.kill_rows(jnp.asarray(dead)) == ts.kill_rows(dead) == 8
    incoming = _rows(rng, 8, n, 0.1)
    _add(js, ts, incoming)                  # fits by compaction alone
    _same_state(js, ts)
    assert ts.count == 48 and ts.dead == 0
    live_then = np.concatenate([rows[:8], rows[16:48], incoming])
    assert np.array_equal(ts.counter.numpy(), live_then.sum(axis=0))
    incoming2 = _rows(rng, 8, n, 0.1)
    _add(js, ts, incoming2)                 # evicts the oldest 8
    _same_state(js, ts)
    survivors = np.concatenate([live_then[8:], incoming2])
    assert np.array_equal(ts.counter.numpy(), survivors.sum(axis=0))
    assert np.array_equal(_bits(ts)[:48], survivors)
    with pytest.raises(ValueError, match="exceeds the policy row cap"):
        ts.add_batch(torch.from_numpy(_rows(rng, 49, n, 0.1)))


@pytest.mark.parametrize("kind", KINDS)
def test_capacity_clamps_to_a_non_power_of_two_cap(kind):
    rng = np.random.default_rng(5)
    js, ts = _pair(kind, 64, max_rows=40)
    for _ in range(3):
        _add(js, ts, _rows(rng, 16, 64, 0.1))
        _same_state(js, ts)
    assert ts.capacity == 40 and ts.count == 40


# ------------------------------------------------------- counter share ----

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("density", [0.0, 0.01, 0.5])
def test_row_contrib_matches_jax_at_a_ragged_capacity(kind, density):
    rng = np.random.default_rng(6)
    n = 333
    js, ts = _pair(kind, n, max_rows=45)
    for _ in range(3):
        _add(js, ts, _rows(rng, 15, n, 0.2))
    assert ts.capacity == 45
    mask = rng.random(45) < density
    want = np.asarray(js._row_contrib(jnp.asarray(mask)))
    got = ts._row_contrib(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(got.numpy(), _bits(ts)[mask].sum(axis=0))


# ------------------------------------------------------------- the ladder --

def test_ladder_compresses_before_evicting_and_matches_jax():
    rng = np.random.default_rng(7)
    n = 512                                 # 64 packed bytes a row
    js, ts = _pair("packed", n, max_bytes=40 * 64, ladder=("compressed",))
    assert ts.row_cap == 40
    batches = [_rows(rng, 16, n, 0.004) for _ in range(2)]
    for b in batches:
        _add(js, ts, b)
    assert ts.representation == "packed"
    extra = _rows(rng, 16, n, 0.002)        # no more tokens than resident
    _add(js, ts, extra)                     # over the cap: morph, no evict
    _same_state(js, ts)
    assert ts.representation == "compressed" and ts.count == 48
    assert ts.row_cap > 48
    allrows = np.concatenate(batches + [extra])
    assert np.array_equal(ts.counter.numpy(), allrows.sum(axis=0))
    assert np.array_equal(_bits(ts)[:48], allrows)


def test_batch_after_the_morph_keeps_every_token():
    """The ladder sizes its tokens for the resident rows.  The reference
    then writes the batch that set it off at that width and cuts the rows
    that need more tokens (its arena and counter disagree); the port
    widens for the batch and fits the cap again."""
    rng = np.random.default_rng(0)
    n = 2048                                # 256 packed bytes a row
    js, ts = _pair("packed", n, max_bytes=16 * 256, ladder=("compressed",))
    sparse, dense = _rows(rng, 16, n, 0.001), _rows(rng, 16, n, 0.01)
    _add(js, ts, sparse)
    _add(js, ts, dense)
    for s in (js, ts):
        assert s.representation == "compressed"
    jbits = np.asarray(token_decode(torch.from_numpy(
        np.asarray(js.R)), n))[:js.count]
    assert not np.array_equal(np.asarray(js.counter), jbits.sum(axis=0))
    live = _bits(ts)[:ts.count]
    assert np.array_equal(ts.counter.numpy(), live.sum(axis=0))
    assert np.array_equal(live[-16:], dense)
    assert ts.capacity * ts._row_bytes() <= 16 * 256


def test_wider_tokens_keep_the_arena_under_its_byte_cap():
    """A token widening under ``max_bytes`` lowers the row cap: the port
    evicts the oldest rows and cuts the arena to the cap (the reference
    keeps the larger arena, capacity x row bytes over the cap)."""
    rng = np.random.default_rng(1)
    n = 512
    cap_bytes = 64 * 32                     # 64 rows at s_pad 8
    js, ts = _pair("compressed", n, max_bytes=cap_bytes)
    kept = []
    for density in (0.005, 0.005, 0.005, 0.005, 0.03, 0.06):
        rows = _rows(rng, 16, n, density)
        _add(js, ts, rows)
        kept.append(rows)
        assert ts.capacity * ts._row_bytes() <= cap_bytes
        assert ts.count <= ts.row_cap
        live = _bits(ts)[:ts.count]
        assert np.array_equal(ts.counter.numpy(), live.sum(axis=0))
        assert np.array_equal(live, np.concatenate(kept)[-ts.count:])
    assert js.capacity * js._row_bytes() > cap_bytes


def test_replace_rows_keeps_the_byte_cap_after_a_widening():
    """Replacement rows that need wider tokens lower the row cap: the
    store fits it again inside ``replace_rows`` (dead rows first, then
    the oldest live rows), as ``add_batch`` does; the reference keeps
    the wider arena over the cap."""
    rng = np.random.default_rng(2)
    n = 512
    cap_bytes = 64 * 32                     # 64 rows at s_pad 8
    js, ts = _pair("compressed", n, max_bytes=cap_bytes)
    rows = _rows(rng, 64, n, 0.004)
    _add(js, ts, rows)
    assert ts.codec.s_pad == 8 and ts.count == 64
    dead = np.zeros(64, bool)
    dead[[3, 9, 40]] = True
    assert js.kill_rows(jnp.asarray(dead)) == ts.kill_rows(dead) == 3
    fresh = _rows(rng, 2, n, 0.06)
    js.replace_rows(np.asarray([9, 40]), jnp.asarray(fresh))
    ts.replace_rows(np.asarray([9, 40]), torch.from_numpy(fresh))
    assert js.capacity * js._row_bytes() > cap_bytes
    assert ts.capacity * ts._row_bytes() <= cap_bytes
    assert ts.codec.s_pad > 8 and ts.dead == 0
    assert ts.count == ts.row_cap < 64
    kept = rows.copy()
    kept[[9, 40]] = fresh
    kept = np.delete(kept, 3, axis=0)       # the dead row went first
    live = _bits(ts)[:ts.count]
    assert np.array_equal(live, kept[-ts.count:])
    assert np.array_equal(ts.counter.numpy(), live.sum(axis=0))


def _dispatches(counters, kernel):
    return sum(v for k, v in counters.items()
               if k.startswith("kernels.dispatch")
               and f"kernel={kernel}," in k.replace("}", ","))


@pytest.mark.parametrize("kind,kernel", [("bitmap", "arena_commit"),
                                         ("packed", "arena_commit_packed")])
def test_bitmap_and_packed_writes_go_through_arena_commit(kind, kernel):
    """Every bitmap or packed write, ``add_batch`` and ``replace_rows``
    alike, is one ``arena_commit`` call (its plain version here), and
    the store equals the reference's."""
    from repro_torch import obs
    rng = np.random.default_rng(8)
    n = 333                                 # rows not 16-byte multiples
    js, ts = _pair(kind, n)
    obs.reset()
    obs.enable()
    try:
        _add(js, ts, _rows(rng, 24, n, 0.1))
        dead = rng.random(js.capacity) < 0.5
        assert js.kill_rows(jnp.asarray(dead)) == ts.kill_rows(dead)
        idx = np.concatenate([np.flatnonzero(dead[:24])[:5], [-1, -1, -1]])
        fresh = _rows(rng, 8, n, 0.2)
        js.replace_rows(idx, jnp.asarray(fresh))
        ts.replace_rows(idx, torch.from_numpy(fresh))
        counters = obs.snapshot()["counters"]
    finally:
        obs.reset()
    assert _dispatches(counters, kernel) == 2
    _same_state(js, ts)


def test_fused_extender_leaves_room_making_to_the_store():
    """A batch that would cross the policy's row cap is declined by the
    fused extender before it samples; the engine's unfused write then
    enforces the policy, and the store equals one filled without the
    fused chain."""
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.core.fused import _ArenaFused
    from repro_torch.graphs import generators
    g = generators.rmat_graph(128, 1024, seed=3)
    out = []
    for fused in ("auto", "off"):
        cfg = IMMConfig(batch=16, seed=5, sampler="LT/walk",
                        fused_pipeline=fused)
        st = store.make_store("bitmap", g.n, device="cpu",
                              policy=store.StorePressurePolicy(max_rows=40))
        eng = InfluenceEngine(g, cfg, store=st, device="cpu")
        assert (eng._fused is not None) == (fused == "auto")
        eng.extend(100)
        out.append(st)
    _same_state_ports(*out)
    st = out[0]
    calls = []
    ext = _ArenaFused(st, lambda key: calls.append(key), 16,
                      sampler_name="probe")
    assert st.count + 16 > st.row_cap
    assert ext.extend_once(None) is False and calls == []


def _same_state_ports(a, b):
    sa, sb = a.state(), b.state()
    for k in sa:
        assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
