"""The meshed row lifecycle of the port's `ShardedStore` on the CPU
(kill, replace, compact, the slot remaps, a `StorePressurePolicy` with
its ladder and per-shard FIFO evictions), held bitwise to the JAX
package: against its *single-device* stores fed the same batches, kills,
repairs and compactions (rows matched by identity, since a mesh places
them in other slots), and on a 1x1 mesh against the JAX `ShardedStore`
itself, which runs on this tree.  Per-shard rules that only a mesh of
several shards shows (slot remaps, FIFO eviction per shard) are held to
oracles written here.  Meshes repeat the ``cpu`` device; n <= 512, one
torch thread.  Tolerance: none (every compare is exact)."""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core.pack import stores as jpack  # noqa: F401,E402 (kinds)
from repro.stream.invalidate import (  # noqa: E402
    rows_touching as jrows_touching,
)
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.adaptive import l_pad_for  # noqa: E402
from repro_torch.core.store import (  # noqa: E402
    ShardedStore, StorePressurePolicy, store_from_state,
)
from repro_torch.graphs.partition import (  # noqa: E402
    balanced_vertex_partition,
)
from repro_torch.mesh import Mesh  # noqa: E402

SHAPES = ((1, 2), (2, 1), (2, 2))
CODECS = ("bitmap", "packed", "compressed")
N = 83                      # not a multiple of 16, nor of 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(shape):
    return Mesh([["cpu"] * shape[1] for _ in range(shape[0])],
                ("data", "vertex"))


def _rows(rng, B, n=N, density=0.2):
    return (rng.random((B, n)) < density).astype(np.uint8)


def _partition(shape, balanced, rng, n=N):
    if not balanced or shape[1] == 1:
        return None
    dst = (n * rng.random(6 * n) ** 3).astype(np.int64)
    return balanced_vertex_partition(n, shape[1], dst=dst)


def _store(shape, codec, part=None, n=N, policy=None):
    return ShardedStore(n, mesh=cpu_mesh(shape), vertex_axis="vertex",
                        partition=part, codec=codec, policy=policy)


class Ledger:
    """Row identity -> slot, for a store that moves its rows: the slots
    ``add_batch`` returned, followed through every drained remap."""

    def __init__(self, store):
        self.store = store
        store.track_remaps = True
        self.slot = {}
        self.next_id = 0

    def add(self, rows, tensor):
        slots = self.store.add_batch(tensor(rows))
        self.follow()
        ids = list(range(self.next_id, self.next_id + len(slots)))
        self.next_id += len(slots)
        for i, s in zip(ids, slots):
            self.slot[i] = int(s)
        return ids

    def follow(self):
        for remap in self.store.drain_remaps():
            for i, s in list(self.slot.items()):
                new = int(remap[s]) if s < remap.shape[0] else -1
                if new < 0:
                    del self.slot[i]
                else:
                    self.slot[i] = new

    def mask(self, ids):
        m = np.zeros(self.store.capacity, bool)
        m[[self.slot[i] for i in ids]] = True
        return m


def _live_rows(st) -> list:
    """The live rows of a state() tree, sorted (a multiset)."""
    R = np.asarray(st["R"])
    if str(np.asarray(st["kind"])) == "packed":
        from repro_torch.core.pack.codec import unpack_bits_np
        R = unpack_bits_np(R, int(st["n"]))
    elif str(np.asarray(st["kind"])) == "compressed":
        from repro_torch.core.pack.codec import token_decode_np
        R = token_decode_np(R, int(st["n"]))
    R = R[:int(st["count"])]
    if "live" in st:
        R = R[np.asarray(st["live"])[:int(st["count"])].astype(bool)]
    return sorted(map(bytes, np.asarray(R, np.uint8)))


def _select_equal(ss, js, k=6):
    """Every sharded strategy over the meshed store (the dense ones over
    the tiles, the sparse one over their index view) picks the JAX
    single-device store's seeds, gains and covered fraction."""
    jv = js.view()
    R = jv.R if js.representation == "bitmap" else js.codec.decode(jv.R)
    want = jsel.select_dense(jnp.asarray(R), jv.valid, k, "rebuild")
    iview = ss.index_view(l_pad_for(ss.max_local_size()))
    for method, layout, view in (("rebuild", "sharded", ss.view()),
                                 ("decrement", "sharded", ss.view()),
                                 ("fused-rebuild", "sharded", ss.view()),
                                 ("rebuild", "sharded-sparse", iview)):
        got = selection.get_selection(method, layout)(
            view, k, mesh=ss.mesh, vertex_axis="vertex",
            partition=ss.partition, codec=ss.codec, n=ss.n)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert float(got[1]) == float(want[1])


def _same_answers(ss, js):
    assert np.array_equal(ss.counter.numpy(), np.asarray(js.counter))
    assert ss.live_count == js.live_count and ss.dead == js.dead
    assert _live_rows(ss.state()) == _live_rows(js.state())
    S = [[1, 2, 3], [82, 82, 82], [0, 40, 41], [17, 5, 80]]
    np.testing.assert_array_equal(ss.hits(S).numpy(),
                                  np.asarray(js.hits(jnp.asarray(S))))
    assert ss.coverage_stats() == js.coverage_stats()
    # valid rows are the filled, live ones, and they hold the counter
    valid = np.concatenate([m.numpy() for m in ss.valid_mask()])
    assert valid.sum() == ss.live_count
    # state() holds exactly the state_slots() rows, in slot order, and
    # the touch query over them agrees with those rows and with JAX's
    st, keep = ss.state(), ss.state_slots()
    assert np.array_equal(valid, keep) and keep.sum() == int(st["count"])
    verts = np.array([3, 17, 40, 82])
    touch = ss.rows_touching(verts).numpy()[keep]
    assert np.array_equal(touch, np.asarray(st["R"])[:, verts].any(axis=1))
    jtouch = np.asarray(jrows_touching(js, verts)) \
        & np.asarray(js.view().valid)
    assert touch.sum() == jtouch.sum()
    _select_equal(ss, js)


# ------------------------------------------------- (i) the lifecycle ----

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lifecycle_matches_the_jax_single_device_store(shape, balanced,
                                                       codec):
    rng = np.random.default_rng(
        zlib.crc32(repr((shape, balanced, codec)).encode()))
    ss = _store(shape, codec, _partition(shape, balanced, rng))
    js = jstore.make_store(codec, N)
    led_s, led_j = Ledger(ss), Ledger(js)
    ids = []
    for B, dens in ((5, 0.2), (16, 0.05), (3, 0.4), (33, 0.2)):
        rows = _rows(rng, B, density=dens)
        ids += led_s.add(rows, torch.from_numpy)
        led_j.add(rows, jnp.asarray)
    _same_answers(ss, js)
    dead = [int(i) for i in rng.choice(ids, 14, replace=False)]
    assert ss.kill_rows(led_s.mask(dead)) == 14
    assert js.kill_rows(jnp.asarray(led_j.mask(dead))) == 14
    _same_answers(ss, js)
    # repair 9 of them, padded with -1 targets whose rows are not zero
    fresh = _rows(rng, 16, density=0.35)
    for led, store, conv in ((led_s, ss, torch.from_numpy),
                             (led_j, js, jnp.asarray)):
        idx = np.full(16, -1, np.int64)
        idx[:9] = [led.slot[i] for i in dead[:9]]
        store.replace_rows(idx, conv(fresh))
        led.follow()
    _same_answers(ss, js)
    # a device mask kills as a host one does
    more = [i for i in ids if i not in dead][:4]
    assert ss.kill_rows(torch.from_numpy(led_s.mask(more))) == 4
    js.kill_rows(jnp.asarray(led_j.mask(more)))
    _same_answers(ss, js)
    before = dict(led_s.slot)
    remap = ss.compact()
    js.compact()
    led_s.follow()
    led_j.follow()
    # each shard's live rows move to its block's head, their order kept
    cap = ss.cap_local
    for t in range(ss.D):
        kept = sorted(s for i, s in before.items()
                      if s // cap == t and i not in dead[9:] + more)
        assert [int(remap[s]) for s in kept] == [
            t * cap + j for j in range(len(kept))]
    assert ss.dead == 0 and ss.compact() is None
    _same_answers(ss, js)
    for i, s in led_s.slot.items():     # identities survive the moves
        assert s // cap < ss.D
    rows = _rows(rng, 24, density=0.1)
    led_s.add(rows, torch.from_numpy)
    led_j.add(rows, jnp.asarray)
    _same_answers(ss, js)
    # the snapshot (live rows only) restores on one device and the mesh
    st = ss.state()
    assert int(st["count"]) == ss.live_count
    for target in (store_from_state(st, device="cpu"),
                   store_from_state(st, mesh=cpu_mesh((2, 2)),
                                    vertex_axis="vertex")):
        assert np.array_equal(target.counter.numpy(), ss.counter.numpy())
        assert _live_rows(target.state()) == _live_rows(st)


@pytest.mark.parametrize("codec", CODECS)
def test_growth_renumbers_slots_and_records_it(codec):
    """Per-shard growth moves the shard blocks apart: slot ``t * cap +
    i`` becomes ``t * new_cap + i``, as the reference records it."""
    rng = np.random.default_rng(9)
    ss = _store((2, 2), codec)
    ss.track_remaps = True
    ss.add_batch(torch.from_numpy(_rows(rng, 20)))
    old = ss.cap_local
    dead = np.zeros(ss.capacity, bool)
    dead[[1, old + 2]] = True
    ss.kill_rows(dead)
    ss.drain_remaps()
    ss.add_batch(torch.from_numpy(_rows(rng, 40)))
    (remap,) = ss.drain_remaps()
    new = ss.cap_local
    assert new > old
    want = np.concatenate([t * new + np.arange(old) for t in range(2)])
    np.testing.assert_array_equal(remap, want)
    live = ss._live_host
    assert not live[1] and not live[new + 2] and live.sum() == ss.capacity - 2
    assert np.array_equal(ss.live_mask().numpy(), live)


@pytest.mark.parametrize("codec", CODECS)
def test_replace_rows_refuses_live_or_unfilled_targets(codec):
    rng = np.random.default_rng(3)
    ss = _store((2, 2), codec)
    ss.add_batch(torch.from_numpy(_rows(rng, 8)))
    cap = ss.cap_local
    for idx in ([2], [cap + 4], [ss.capacity]):
        with pytest.raises(ValueError, match="dead slots"):
            ss.replace_rows(np.asarray(idx),
                            torch.zeros((1, N), dtype=torch.uint8))
    before = ss.state()
    ss.replace_rows(np.asarray([-1, -1]), torch.ones((2, N),
                                                     dtype=torch.uint8))
    assert all(np.array_equal(np.asarray(before[k]),
                              np.asarray(ss.state()[k])) for k in before)


# ---------------------------------------- (ii) against the 1x1 reference ----

def _jax_1x1(codec, policy=None, n=N):
    jmesh = jax.make_mesh((1, 1), ("data", "vertex"))
    jp = jstore.StorePressurePolicy(**policy) if policy else None
    return jstore.ShardedStore(n, mesh=jmesh, vertex_axis="vertex",
                               codec=codec, policy=jp)


def _same_1x1(ts, js):
    want, got = js.state(), ts.state()
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert (ts.capacity, ts.cap_local, ts.count, ts.dead, ts.live_count) \
        == (js.capacity, js.cap_local, js.count, js.dead, js.live_count)
    assert ts.representation == js.representation
    assert ts.row_cap == js.row_cap and ts._row_bytes() == js._row_bytes()
    np.testing.assert_array_equal(ts.live_mask().numpy(),
                                  np.asarray(js.live_mask()))


@pytest.mark.parametrize("codec", CODECS)
def test_1x1_lifecycle_equals_the_jax_sharded_store(codec):
    rng = np.random.default_rng(17)
    js, ts = _jax_1x1(codec), _store((1, 1), codec)
    js.track_remaps = ts.track_remaps = True
    for B in (5, 16, 40):
        rows = _rows(rng, B)
        np.testing.assert_array_equal(
            ts.add_batch(torch.from_numpy(rows)),
            js.add_batch(jnp.asarray(rows)))
    dead = rng.random(ts.capacity) < 0.3
    assert ts.kill_rows(dead) == js.kill_rows(jnp.asarray(dead))
    _same_1x1(ts, js)
    slots = np.flatnonzero(dead[:ts.count])[:7]
    idx = np.concatenate([slots, np.full(8 - slots.size, -1)])
    fresh = _rows(rng, 8, density=0.5)
    ts.replace_rows(idx, torch.from_numpy(fresh))
    js.replace_rows(idx, jnp.asarray(fresh))
    _same_1x1(ts, js)
    np.testing.assert_array_equal(ts.compact(), js.compact())
    for a, b in zip(ts.drain_remaps(), js.drain_remaps()):
        np.testing.assert_array_equal(a, b)
    _same_1x1(ts, js)


POLICIES = (
    ("bitmap", dict(max_rows=48), N),
    ("packed", dict(max_rows=40), N),
    ("compressed", dict(max_rows=36), N),
    # 64 packed bytes a row against 32 at the ladder's token width
    ("packed", dict(max_bytes=40 * 64, ladder=("compressed",)), 512),
)


@pytest.mark.parametrize("codec,policy,n", POLICIES)
def test_1x1_pressure_equals_the_jax_sharded_store(codec, policy, n):
    """Compaction, the ladder and FIFO eviction under a policy: each
    write's slots, every remap and the state after it equal the JAX
    `ShardedStore`'s on a 1x1 mesh (token widths that keep within the
    byte cap, where the reference keeps its promise)."""
    rng = np.random.default_rng(zlib.crc32(repr((codec, policy)).encode()))
    js = _jax_1x1(codec, policy, n)
    ts = _store((1, 1), codec, n=n, policy=StorePressurePolicy(**policy))
    js.track_remaps = ts.track_remaps = True
    _same_1x1(ts, js)
    steps = 0
    for i in range(7):
        rows = _rows(rng, 12, n=n, density=0.003)
        np.testing.assert_array_equal(
            ts.add_batch(torch.from_numpy(rows)),
            js.add_batch(jnp.asarray(rows)))
        _same_1x1(ts, js)
        if i == 3:
            dead = np.zeros(ts.capacity, bool)
            dead[2:9] = True
            assert ts.kill_rows(dead) == js.kill_rows(jnp.asarray(dead))
            _same_1x1(ts, js)
        ra, rb = ts.drain_remaps(), js.drain_remaps()
        assert len(ra) == len(rb)
        for a, b in zip(ra, rb):
            np.testing.assert_array_equal(a, b)
        steps += len(ra)
    assert steps > 0
    if policy.get("ladder"):
        assert ts.representation == "compressed"


# --------------------------------------------- (iii) per-shard pressure ----

def _fifo_oracle(shards, b, local_cap):
    """The per-shard rule: each shard drops its dead rows first, then its
    oldest live rows until ``b`` more fit under ``local_cap``; returns
    the row identities each shard keeps, oldest first."""
    out = []
    for rows in shards:
        live = [i for i, alive in rows if alive]
        over = len(live) + b - local_cap
        out.append(live[max(over, 0):] if len(rows) + b > local_cap
                   else [i for i, _ in rows])
    return out


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 1)])
def test_per_shard_fifo_eviction_follows_the_oracle(shape, codec):
    rng = np.random.default_rng(zlib.crc32(repr((shape, codec)).encode()))
    D = shape[0]
    cap = 10 * D + D - 1            # floored to a multiple of D
    ss = _store(shape, codec, policy=StorePressurePolicy(max_rows=cap))
    assert ss.row_cap == 10 * D
    led = Ledger(ss)
    shards = [[] for _ in range(D)]     # (identity, alive), oldest first
    by_id = {}
    for step in range(6):
        B = 3 * D + (step % 3)
        rows = _rows(rng, B)
        b = -(-B // D)
        # what the store must keep, from the oracle, before the write
        want = _fifo_oracle(shards, b, ss.row_cap // D)
        ids = led.add(rows, torch.from_numpy)
        for i, r in zip(ids, rows):
            by_id[i] = r
        for t in range(D):
            kept = [s for s in led.slot if led.slot[s] // ss.cap_local == t
                    and s not in ids]
            assert sorted(kept) == sorted(want[t]), (step, t)
            shards[t] = [(i, True) for i in want[t]]
        for j, i in enumerate(ids):
            shards[j // b].append((i, True))
        assert max(ss.counts) <= ss.row_cap // D
        assert ss.capacity * ss._row_bytes() <= cap * ss._row_bytes()
        if step == 2:
            # kill the newest row of shard 0: staleness goes first
            victim = shards[0][-1][0]
            ss.kill_rows(led.mask([victim]))
            shards[0][-1] = (victim, False)
        live = np.stack([by_id[i] for t in range(D) for i, a in shards[t]
                         if a])
        assert np.array_equal(ss.counter.numpy(), live.sum(axis=0))
    with pytest.raises(ValueError, match="per-shard policy cap"):
        ss.add_batch(torch.from_numpy(_rows(rng, 11 * D)))


def test_policy_below_one_row_a_shard_refuses():
    with pytest.raises(ValueError, match="below one row per shard"):
        _store((4, 1), "bitmap", policy=StorePressurePolicy(max_rows=3))


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
def test_ladder_on_tiles_compresses_before_evicting(shape):
    """Packed tiles over a byte cap morph to tokens tile by tile (the
    token width covers every resident row of every tile) before any live
    row goes; the answers are the rows'.  (At n 512 a vertex axis would
    leave 32 packed bytes a tile, no more than the least token width.)"""
    rng = np.random.default_rng(21)
    n = 512
    D = shape[0]
    row_bytes = shape[1] * -(-(-(-n // shape[1])) // 8)
    ss = _store(shape, "packed", n=n, policy=StorePressurePolicy(
        max_bytes=20 * D * row_bytes, ladder=("compressed",)))
    assert ss.row_cap == 20 * D
    rows = [_rows(rng, 8 * D, n=n, density=0.004) for _ in range(3)]
    for r in rows[:2]:
        ss.add_batch(torch.from_numpy(r))
    assert ss.representation == "packed"
    ss.add_batch(torch.from_numpy(rows[2]))
    assert ss.representation == "compressed" and ss.count == 24 * D
    allrows = np.concatenate(rows)
    assert np.array_equal(ss.counter.numpy(), allrows.sum(axis=0))
    assert _live_rows(ss.state()) == sorted(map(bytes, allrows))
    assert ss.capacity * ss._row_bytes() <= 20 * D * row_bytes


def test_wider_tokens_keep_the_tiles_under_their_byte_cap():
    """A batch that widens the token tiles lowers the per-shard cap; the
    port cuts ``cap_local`` to it (renumbering the slots, recorded), so
    capacity x row bytes stays within the cap after every write, by
    add_batch and replace_rows alike."""
    rng = np.random.default_rng(5)
    n = 512                             # 256 columns a tile
    cap_bytes = 2 * 4 * 40 * 8          # Dv 2, 40 rows of s_pad 8
    ss = _store((2, 2), "compressed", n=n, policy=StorePressurePolicy(
        max_bytes=cap_bytes))
    led = Ledger(ss)
    ids = []
    for _ in range(4):
        ids += led.add(_rows(rng, 16, n=n, density=0.002), torch.from_numpy)
        assert ss.capacity * ss._row_bytes() <= cap_bytes
    assert ss.codec.s_pad == 8
    dense = _rows(rng, 8, n=n, density=0.1)    # many more tokens a row
    led.add(dense, torch.from_numpy)
    assert ss.codec.s_pad > 8
    assert ss.capacity * ss._row_bytes() <= cap_bytes
    assert max(ss.counts) <= ss.row_cap // ss.D
    live = [i for i in ids if i in led.slot][:3]
    ss.kill_rows(led.mask(live))
    idx = np.array([led.slot[i] for i in live])
    ss.replace_rows(idx, torch.from_numpy(_rows(rng, 3, n=n, density=0.5)))
    led.follow()
    assert ss.capacity * ss._row_bytes() <= cap_bytes
    bits = np.stack([np.frombuffer(r, np.uint8)
                     for r in _live_rows(ss.state())])
    assert np.array_equal(ss.counter.numpy(), bits.sum(axis=0))
