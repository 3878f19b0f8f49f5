#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each:

  env       the card (nvidia-smi), torch/CUDA versions, kernel build time
  kernels   every CUDA kernel of the main paths against its plain PyTorch
            version on the same inputs, bitwise, at the main paths' shapes
            (B = 256 rows, com-Amazon's n = 334,863 and m = 1,820,024,
            theta = 16,384, the arena also packed and as tokens), plus
            ragged and tie cases; times on the card
  parity    a small cell (rmat n = 2,048) run by the port on cuda with
            each store and on cpu: seeds, theta, coverage, counter and
            arena identical
  imm_full  imm() on the full-size com-Amazon replica (IC, k = 50,
            eps = 0.5, max_theta = 16,384, rebuild), then the fused
            selections and four influence queries on its store
  packed_full, compressed_full
            the same solve, selections and queries on the IMPack packed
            and compressed stores: seeds, theta, influence and coverage
            equal imm_full's

then the kernel table (each kernel's launches counted on the one full
run that is its path: the bitmap kernels and the coins on imm_full, the
packed commit and packed_count on packed_full, token_count on
compressed_full), the card's name and power limit, and
``{"ok": true, "device": {...}}`` last.
Any failure exits non-zero without the ok line; so does a machine with
no CUDA device, or a directory without the repo's src/repro_torch.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the
#: float32 rate outside the tensor cores, used for the coin kernel's
#: 32-bit integer operations (the table lists no int32 rate; the card
#: issues int32 at half that, so the bound is a floor)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

AMAZON_N, BATCH, THETA = 334_863, 256, 16_384
DEV = "cuda"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_cuda(torch, fn, *, warmup: int = 2, iters: int = 10) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- kernels ----

def bitmap_arena(torch, theta: int, n: int, gen, *, ld: int):
    """A ``(theta, n)`` view of a zeroed ``(theta, ld)`` uint8 arena shaped
    like the main path's: 9 of every 16 rows hold one vertex (roots with
    no in-edges), the other 7 hold about 35% of the vertices."""
    buf = torch.zeros((theta, ld), dtype=torch.uint8, device="cuda")
    R = buf[:, :n]
    for s in range(0, theta, 1024):
        e = min(s + 1024, theta)
        R[s:e] = (torch.randint(0, 1000, (e - s, n), generator=gen,
                                device="cuda", dtype=torch.int16) < 350)
    single = torch.arange(theta, device="cuda") % 16 < 9
    R[single] = 0
    roots = torch.randint(0, n, (theta,), generator=gen, device="cuda")
    R[single.nonzero().squeeze(1), roots[single]] = 1
    return buf, R


def packed_commit_row(torch, gen, B: int, n: int) -> dict:
    """The packed arena commit against its plain version on ragged
    widths (n = 1, 7, 9, 17, 1,000, 4,099) and at the main path's batch;
    its times at that batch."""
    from repro_torch.kernels import commit, ops

    def case(Bc, nc):
        nbc = -(-nc // 8)
        src = torch.zeros((Bc, ops.padded_width(nc)), dtype=torch.uint8,
                          device="cuda")
        src[:, :nc] = torch.randint(0, 100, (Bc, nc), generator=gen,
                                    device="cuda") < 15
        arena = torch.zeros((2 * Bc, ops.padded_width(nbc)),
                            dtype=torch.uint8, device="cuda")
        arena_ref = arena.clone()
        cnt = torch.randint(0, 50, (nc,), generator=gen, device="cuda",
                            dtype=torch.int32)
        cnt_ref = cnt.clone()
        ops.arena_commit(src[:, :nc], arena[Bc:, :nbc], cnt, kind="packed")
        commit.arena_commit_packed_plain(src[:, :nc], arena_ref[Bc:, :nbc],
                                         cnt_ref)
        check(torch.equal(arena, arena_ref),
              f"arena_commit_packed rows {Bc}x{nc}")
        check(torch.equal(cnt, cnt_ref),
              f"arena_commit_packed counter {Bc}x{nc}")
        return src[:, :nc], arena, cnt, arena_ref, cnt_ref

    for Bc, nc in ((5, 1), (5, 7), (5, 9), (3, 17), (70, 1000), (256, 4099)):
        case(Bc, nc)
    rows, arena, cnt, arena_ref, cnt_ref = case(B, n)
    nb = -(-n // 8)
    ms = time_cuda(torch, lambda: commit.arena_commit_packed_cuda(
        rows, arena[B:, :nb], cnt))
    plain_ms = time_cuda(torch, lambda: commit.arena_commit_packed_plain(
        rows, arena_ref[B:, :nb], cnt_ref), iters=3)
    b_ms, b_by = bound(B * n + B * nb + 8 * n)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/commit.cu",
        replaces="src/repro/kernels/commit.py:118", max_abs_err=0,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=[B, n])


def encode_arena(torch, R, *, chunk: int = 1024):
    """``R (theta, n)`` 0/1 rows bit-packed into a 16-byte-strided arena
    and as tokens at the smallest power-of-two ``s_pad`` holding every
    row; returns ``(packed view, tokens, tokens needed per row)``."""
    from repro_torch.core.pack import codec as pc
    from repro_torch.core.store import next_pow2
    from repro_torch.kernels import ops

    theta, n = R.shape
    nb = pc.n_bytes_for(n)
    pbuf = torch.zeros((theta, ops.padded_width(nb)), dtype=torch.uint8,
                       device="cuda")
    need = torch.empty(theta, dtype=torch.int32, device="cuda")
    for s in range(0, theta, chunk):
        pbuf[s:s + chunk, :nb] = pc.pack_bits(R[s:s + chunk])
        need[s:s + chunk] = pc.tokens_needed(R[s:s + chunk])
    s_pad = next_pow2(int(need.max()), pc.MIN_TOKEN_PAD)
    T = torch.empty((theta, s_pad), dtype=torch.int32, device="cuda")
    for s in range(0, theta, chunk):
        T[s:s + chunk] = pc.token_encode(R[s:s + chunk], s_pad)
    return pbuf[:, :nb], T, need


def count_rows(torch, R, gen) -> dict:
    """packed_count and token_count against their plain versions and
    against coverage_matvec over the same rows: ragged shapes, saturated
    runs, random, full and all-zero ``alive``; then at the main path's
    shape, the ``(theta, n)`` arena ``R`` (with saturated rows added)
    packed and as tokens, and their times there."""
    from repro_torch.kernels import coverage_matvec as cov
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_count as pcm

    def agree(Rc, tag):
        theta, n = Rc.shape
        P, T, need = encode_arena(torch, Rc)
        alive = torch.rand(theta, generator=gen, device="cuda") < 0.8
        for a in (alive, torch.zeros_like(alive), torch.ones_like(alive),
                  alive.to(torch.float32)):
            want = cov.coverage_matvec_plain(a, Rc).to(torch.int32)
            got_p, got_t = (ops.packed_count(P, a, n=n),
                            ops.token_count(T, a, n=n))
            check(torch.equal(got_p, pcm.packed_count_plain(P, a, n))
                  and torch.equal(got_p, want), f"packed_count {tag}")
            check(torch.equal(got_t, pcm.token_count_plain(T, a, n))
                  and torch.equal(got_t, want), f"token_count {tag}")
        return P, T, need

    for th, nc in ((300, 1000), (1, 17), (33, 9), (4096, 513), (64, 4099)):
        buf, Rc = bitmap_arena(torch, th, nc, gen,
                               ld=ops.padded_width(nc))
        Rc[0] = 1                                  # a saturated row
        Rc[th // 2, :min(nc, 512)] = 1             # and a saturated span
        agree(Rc, f"{th}x{nc}")

    theta, n = R.shape
    R[5::64] = 1                           # whole rows of saturated runs
    R[37::64, 2560:2560 + 256 * 40] = 1    # superblock-aligned spans
    P, T, need = agree(R, "full size")
    full = torch.ones(theta, dtype=torch.bool, device="cuda")
    nb = P.shape[1]
    rows = {}
    for name, fn, plain, arena, nbytes, replaces in (
            ("packed_count", pcm.packed_count_cuda, pcm.packed_count_plain,
             P, theta * nb, "src/repro/kernels/packed_count.py:65"),
            ("token_count", pcm.token_count_cuda, pcm.token_count_plain,
             T, 4 * int(need.sum()), "src/repro/kernels/packed_count.py:131")):
        ms = time_cuda(torch, lambda: fn(arena, full, n))
        plain_ms = time_cuda(torch, lambda: plain(arena, full, n),
                             warmup=1, iters=2)
        b_ms, b_by = bound(nbytes + theta + 4 * n)
        rows[name] = dict(
            route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces, max_abs_err=0, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=[theta, n] if name == "packed_count"
            else [theta, T.shape[1]])
    emit("count_arenas", theta=theta, n=n, packed_bytes=theta * nb,
         s_pad=T.shape[1], token_bytes=T.numel() * 4,
         real_token_bytes=4 * int(need.sum()),
         rows_holding_tokens=int((need > 1).sum()))
    return rows


def kernel_phase(torch, graph):
    from repro_torch import prng
    from repro_torch.kernels import coins, commit, ops
    from repro_torch.kernels import coverage_matvec as cov
    from repro_torch.kernels import fused_select as fsel

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, m, B, theta = graph.n, graph.m, BATCH, THETA
    ld = ops.padded_width(n)
    rows_out = {}

    # ---- arena_commit: one batch into rows [B, 2B) of an arena
    def commit_case(Bc, nc):
        ldc = ops.padded_width(nc)
        src = torch.zeros((Bc, ldc), dtype=torch.uint8, device="cuda")
        src[:, :nc] = torch.randint(0, 100, (Bc, nc), generator=gen,
                                    device="cuda") < 15
        arena = torch.zeros((2 * Bc, ldc), dtype=torch.uint8, device="cuda")
        arena_ref = arena.clone()
        cnt = torch.randint(0, 50, (nc,), generator=gen, device="cuda",
                            dtype=torch.int32)
        cnt_ref = cnt.clone()
        ops.arena_commit(src[:, :nc], arena[Bc:, :nc], cnt)
        commit.arena_commit_plain(src[:, :nc], arena_ref[Bc:, :nc], cnt_ref)
        check(torch.equal(arena, arena_ref), f"arena_commit rows {Bc}x{nc}")
        check(torch.equal(cnt, cnt_ref), f"arena_commit counter {Bc}x{nc}")
        return src[:, :nc], arena, cnt, arena_ref, cnt_ref

    for Bc, nc in ((70, 1000), (3, 17), (256, 4099)):
        commit_case(Bc, nc)
    rows, arena, cnt, arena_ref, cnt_ref = commit_case(B, n)
    ms = time_cuda(torch, lambda: commit.arena_commit_cuda(
        rows, arena[B:, :n], cnt))
    plain_ms = time_cuda(torch, lambda: commit.arena_commit_plain(
        rows, arena_ref[B:, :n], cnt_ref), iters=3)
    b_ms, b_by = bound(2 * B * n + 8 * n)
    rows_out["arena_commit"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/commit.cu",
        replaces="src/repro/kernels/commit.py:75", max_abs_err=0,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=[B, n])
    del rows, arena, cnt, arena_ref, cnt_ref
    rows_out["arena_commit_packed"] = packed_commit_row(torch, gen, B, n)

    # ---- coverage_matvec and fused_select over a theta x n arena
    for th, nc in ((300, 1000), (1, 17), (4096, 513)):
        buf, R = bitmap_arena(torch, th, nc, gen, ld=ops.padded_width(nc))
        alive = torch.rand(th, generator=gen, device="cuda") < 0.8
        for a in (alive, torch.zeros_like(alive), torch.ones_like(alive)):
            got = ops.coverage_matvec(a, R)
            check(torch.equal(got, cov.coverage_matvec_plain(a, R)),
                  f"coverage_matvec {th}x{nc}")
            mx, ix = ops.fused_select(a, R)
            pm, pi = fsel.fused_select_plain(a, R)
            check(float(mx) == float(pm) and int(ix) == int(pi),
                  f"fused_select {th}x{nc}: ({float(mx)}, {int(ix)}) vs "
                  f"({float(pm)}, {int(pi)})")
        # ties across tiles: two equal hub columns, the first max wins
        R[:, nc // 3] = 1
        R[:, nc - 1] = 1
        mx, ix = ops.fused_select(alive, R)
        pm, pi = fsel.fused_select_plain(alive, R)
        check(float(mx) == float(pm) == float(alive.sum())
              and int(ix) == int(pi) <= nc // 3,
              f"fused_select tie {th}x{nc}: {int(ix)} vs {int(pi)}")
        mx, ix = ops.fused_select(torch.zeros_like(alive), R)
        check(int(ix) == 0 and float(mx) == 0.0, "fused_select zero alive")

    buf, R = bitmap_arena(torch, theta, n, gen, ld=ld)
    alive = torch.rand(theta, generator=gen, device="cuda") < 0.8
    full = torch.ones(theta, dtype=torch.bool, device="cuda")
    errs = []
    for a in (alive, full):
        got, ref = ops.coverage_matvec(a, R), cov.coverage_matvec_plain(a, R)
        errs.append(float((got - ref).abs().max()))
        check(torch.equal(got, ref), "coverage_matvec full size")
        mx, ix = ops.fused_select(a, R)
        pm, pi = fsel.fused_select_plain(a, R)
        check(float(mx) == float(pm) and int(ix) == int(pi),
              f"fused_select full size ({float(mx)}, {int(ix)}) vs "
              f"({float(pm)}, {int(pi)})")
    lib_sum = torch.sum(R, dim=0, dtype=torch.int32)
    check(torch.equal(lib_sum.float(), cov.coverage_matvec_plain(full, R)),
          "library column sum")
    ms = time_cuda(torch, lambda: cov.coverage_matvec_cuda(full, R))
    plain_ms = time_cuda(torch, lambda: cov.coverage_matvec_plain(full, R),
                         warmup=1, iters=2)
    library_ms = time_cuda(torch, lambda: torch.sum(R, dim=0,
                                                    dtype=torch.int32))
    b_ms, b_by = bound(theta * n + theta + 4 * n)
    rows_out["coverage_matvec"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/coverage_matvec.cu",
        replaces="src/repro/kernels/coverage_matvec.py:40",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms, shape=[theta, n])
    ms = time_cuda(torch, lambda: fsel.fused_select_cuda(full, R))
    plain_ms = time_cuda(torch, lambda: fsel.fused_select_plain(full, R),
                         warmup=1, iters=2)
    rows_out["fused_select"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/fused_select.cu",
        replaces="src/repro/kernels/fused_select.py:46", max_abs_err=0,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=[theta, n])
    rows_out.update(count_rows(torch, R, gen))
    del buf, R

    # ---- ic_sparse_hits: one BFS step's coins over the real edge probs
    prob = graph.in_prob.to("cuda")
    key = prng.split(prng.PRNGKey(123))[1]
    hits = ops.ic_sparse_hits(key, prob, B)
    bad = 0
    for r in range(0, B, 32):
        ref = coins.ic_sparse_hits_plain(key, prob, B, rows=(r, r + 32))
        bad += int((hits[r:r + 32] != ref).sum())
    check(bad == 0, f"ic_sparse_hits: {bad} coins differ")
    for Bc, mc in ((5, 1001), (1, 3)):
        p = torch.rand(mc, generator=gen, device="cuda")
        check(torch.equal(ops.ic_sparse_hits(key, p, Bc),
                          coins.ic_sparse_hits_plain(key, p, Bc)),
              f"ic_sparse_hits {Bc}x{mc}")
    ms = time_cuda(torch, lambda: coins.ic_sparse_hits_cuda(key, prob, B))
    plain_ms = time_cuda(torch, lambda: coins.ic_sparse_hits_plain(
        key, prob, B), warmup=1, iters=2)
    b_ms, b_by = bound(B * m + 4 * m, B * m * coins.OPS_PER_COIN)
    rows_out["ic_sparse_hits"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/coins.cu",
        replaces="src/repro/core/sampler.py:470", max_abs_err=0,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=[B, m])
    del hits
    torch.cuda.empty_cache()
    emit("kernels", **{k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms",
                                                "library_ms", "shape")}
                       for k, v in rows_out.items()})
    return rows_out


# -------------------------------------------------------------- parity ----

def parity_phase(torch):
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.graphs.generators import rmat_graph
    from repro_torch.kernels import ops

    g = rmat_graph(2048, 16384, seed=0)
    out = {}
    for dev, store in ((DEV, "bitmap"), ("cpu", "bitmap"), (DEV, "packed"),
                       (DEV, "compressed")):
        cfg = IMMConfig(k=10, backend="sparse", max_theta=4096, seed=0,
                        store=store)
        ops.reset_launches()
        t0 = time.perf_counter()
        eng = InfluenceEngine(g, cfg, device=dev)
        res = eng.run()
        fr = eng.select(10, method="fused-rebuild")
        fd = eng.select(10, method="fused-decrement")
        st = eng.store
        rows = st.R[:res.theta] if store == "bitmap" else \
            st.codec.decode(st.R[:res.theta])
        out[dev, store] = dict(res=res, fr=fr, fd=fd, R=rows.cpu(),
                               s=time.perf_counter() - t0,
                               launches=ops.launch_counts())
    c, h = out[DEV, "bitmap"], out["cpu", "bitmap"]
    for name in ("arena_commit", "coverage_matvec", "fused_select",
                 "ic_sparse_hits"):
        check(c["launches"].get(name, 0) > 0, f"parity: {name} not launched")
        check(h["launches"].get(name, 0) == 0, f"parity: {name} on cpu")
    for store, names in (("packed", ("arena_commit_packed", "packed_count")),
                         ("compressed", ("token_count",))):
        for name in names:
            check(out[DEV, store]["launches"].get(name, 0) > 0,
                  f"parity: {name} not launched on the {store} store")
    rh = h["res"]
    for key, o in out.items():
        r = o["res"]
        check(list(r.seeds) == list(rh.seeds), f"parity seeds {key}")
        check(r.theta == rh.theta and r.rounds == rh.rounds,
              f"parity theta {key}")
        check(r.covered_frac == rh.covered_frac, f"parity covered_frac {key}")
        check((r.counter == rh.counter).all(), f"parity counter {key}")
        check(torch.equal(o["R"], h["R"]), f"parity arena {key}")
        for q in ("fr", "fd"):
            check(list(o[q].seeds) == list(rh.seeds), f"parity {q} {key}")
    emit("parity", n=g.n, m=g.m, theta=rh.theta, rounds=rh.rounds,
         seeds=[int(s) for s in rh.seeds], covered_frac=rh.covered_frac,
         cuda_s=c["s"], cpu_s=h["s"], launches=c["launches"],
         packed_s=out[DEV, "packed"]["s"],
         compressed_s=out[DEV, "compressed"]["s"],
         packed_launches=out[DEV, "packed"]["launches"],
         compressed_launches=out[DEV, "compressed"]["launches"])


# --------------------------------------------------------- full solves ----

#: the kernels each store's solve must launch, and those it must not
PATH_KERNELS = {
    "bitmap": ("arena_commit", "coverage_matvec", "fused_select"),
    "packed": ("arena_commit_packed", "packed_count"),
    "compressed": ("token_count",),
}
PHASE = {"bitmap": "imm_full", "packed": "packed_full",
         "compressed": "compressed_full"}


def full_phase(torch, graph, max_theta: int, store: str = "bitmap",
               ref: dict = None):
    """imm() on the full-size replica with ``store``, then the fused
    selections and four influence queries; checks the arena against the
    counter and sizes and, given the bitmap run's ``ref``, every result
    against it.  Returns (launches, summary)."""
    from repro_torch import obs
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.kernels import ops

    phase = PHASE[store]
    cfg = IMMConfig(k=50, eps=0.5, model="IC", max_theta=max_theta,
                    selection_method="rebuild", seed=0, store=store)
    obs.reset()
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    engine = InfluenceEngine(graph, cfg, device=DEV)
    res = engine.run()
    torch.cuda.synchronize()
    imm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fr = engine.select(50, method="fused-rebuild")
    fd = engine.select(50, method="fused-decrement")
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    deg = torch.bincount(graph.edge_src.long(), minlength=graph.n)
    sets = [list(res.seeds), list(res.seeds[:10]),
            torch.topk(deg, 50).indices.tolist(),
            list(range(0, graph.n, graph.n // 50))[:50]]
    t0 = time.perf_counter()
    infl = engine.influences(sets)
    influences_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    tracer = obs.get_tracer()
    spans = {name: sum(tracer.durations_s(name))
             for name in ("sample", "store.write", "select")}
    obs.reset()
    peak = torch.cuda.max_memory_allocated()

    st = engine.store
    count = st.count
    check(res.theta == count and count > 0, f"{phase} theta")
    check(len(set(int(s) for s in res.seeds)) == 50, f"{phase} seeds unique")
    check(0.0 < res.covered_frac <= 1.0, f"{phase} covered_frac")
    check(res.representation == store, f"{phase} representation")
    check(list(fr.seeds) == list(res.seeds), f"{phase} fused-rebuild seeds")
    check(list(fd.seeds) == list(res.seeds),
          f"{phase} fused-decrement seeds")
    check(fr.covered_frac == res.covered_frac == fd.covered_frac,
          f"{phase} fused covered_frac")
    check(infl[0] == res.influence, f"{phase} influence of the seeds "
          f"{infl[0]} vs {res.influence}")
    check(all(0.0 < x <= graph.n for x in infl), f"{phase} influences")
    colsum = torch.zeros(graph.n, dtype=torch.int32, device=DEV)
    rowsum = torch.empty(count, dtype=torch.int32, device=DEV)
    for s in range(0, count, 1024):
        blk = st.R[s:s + 1024]
        if store != "bitmap":
            blk = st.codec.decode(blk)
        colsum += blk.sum(dim=0, dtype=torch.int32)
        rowsum[s:s + 1024] = blk.sum(dim=1, dtype=torch.int32)
    check(torch.equal(colsum, st.counter), f"{phase} counter == arena sums")
    check(torch.equal(rowsum, st.sizes[:count]), f"{phase} sizes == row sums")
    width = st.R.shape[1]
    if store != "compressed":
        check(int(st._arena[:, width:].sum()) == 0,
              f"{phase} arena padding zero")
    for kind, names in PATH_KERNELS.items():
        for name in names:
            got = launches.get(name, 0)
            check(got > 0 if kind == store else got == 0,
                  f"{phase}: {name} launched {got} times")
    check(launches.get("ic_sparse_hits", 0) > 0, f"{phase}: coins")
    summary = dict(seeds=[int(x) for x in res.seeds], theta=res.theta,
                   influence=res.influence, covered_frac=res.covered_frac,
                   influences=[float(x) for x in infl])
    for key in summary if ref is not None else ():
        check(summary[key] == ref[key], f"{phase} {key} differs from "
              f"imm_full's: {summary[key]} vs {ref[key]}")
    extra = {}
    if store != "bitmap":
        # one greedy round's count and the winner's membership, timed
        alive = torch.ones(st.capacity, dtype=torch.bool, device=DEV)
        count_fn = (ops.packed_count if store == "packed"
                    else ops.token_count)
        v = torch.as_tensor(res.seeds[:1], device=DEV)
        extra = dict(
            round_count_ms=time_cuda(
                torch, lambda: count_fn(st.R, alive, n=graph.n), iters=5),
            round_member_ms=time_cuda(
                torch, lambda: st.codec.decode_cols(st.R, v), iters=5))
    if store == "compressed":
        # token_count's bound on this arena: its real tokens, read once
        real = 4 * sum(int((st.R[s:s + 1024] != st.codec.fill).sum())
                       for s in range(0, count, 1024))
        extra.update(s_pad=st.codec.s_pad, real_token_bytes=real,
                     round_count_bound_ms=bound(real + st.capacity
                                                + 4 * graph.n)[0])
    emit(phase, graph="com-Amazon", store=store, n=graph.n, m=graph.m, k=50,
         eps=0.5, max_theta=max_theta, theta=res.theta, rounds=res.rounds,
         imm_s=imm_s, sample_s=spans["sample"] + spans["store.write"],
         select_s=spans["select"], fused_selects_s=fused_s,
         influences_s=influences_s, influence=res.influence,
         covered_frac=res.covered_frac,
         seeds=[int(s) for s in res.seeds[:10]],
         influences=[float(x) for x in infl],
         arena_bytes=st.arena_bytes, at_rest_row_bytes=st._row_bytes(),
         max_memory_allocated=peak, launches=launches, **extra)
    return launches, summary


def profile_phase(torch, graph, batches: int = 4):
    """Optional (``--phases profile``): the full-size sampler for a few
    batches, first plain and then under ``torch.profiler`` (after one
    profiled warm-up batch that absorbs the tracer's start-up): wall
    time with and without tracing, device-busy share and the kernels
    that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import prng
    from repro_torch.core.engine import IMMConfig
    from repro_torch.core.sampler import _bind_sparse

    sample = _bind_sparse(graph.to("cuda"), IMMConfig())
    keys = prng.split(prng.PRNGKey(7), batches + 1)
    sample(keys[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in keys[1:]:
        sample(k)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=batches,
                                   repeat=1)) as prof:
        sample(keys[0])
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for k in keys[1:]:
            sample(k)
            prof.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # kernels only: the schedule's ProfilerStep annotations also carry
    # device time, which would count every kernel twice
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("ProfilerStep")),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    emit("profile", batches=batches, plain_wall_s=plain_wall,
         traced_wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
         top=[{"name": e.key[:90], "calls": e.count,
               "device_ms": dev_us(e) / 1e3} for e in kernels[:12]])

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-theta", type=int, default=THETA,
                    help="theta cap of the full solves (cut this, never "
                         "n)")
    ap.add_argument("--phases",
                    default="kernels,parity,imm_full,packed_full,"
                            "compressed_full",
                    help="comma list of kernels, parity, imm_full, "
                         "packed_full, compressed_full and the optional "
                         "profile")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.graphs.datasets import synthetic_snap
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    build_s = build.build_all()
    for name, log in build.build_logs().items():
        print(f"--- nvcc {name}.cu\n{log}", file=sys.stderr)
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), build_s=build_s)

    t0 = time.perf_counter()
    graph = synthetic_snap("com-Amazon", seed=0)
    emit("graph", name="com-Amazon", n=graph.n, m=graph.m,
         build_s=time.perf_counter() - t0)
    check(graph.n == AMAZON_N, "com-Amazon replica size")

    rows = kernel_phase(torch, graph) if "kernels" in phases else {}
    if "parity" in phases:
        parity_phase(torch)
    launches, ref = {}, None
    for store in ("bitmap", "packed", "compressed"):
        if PHASE[store] in phases:
            launches[PHASE[store]], summary = full_phase(
                torch, graph, args.max_theta, store, ref)
            if store == "bitmap":
                ref = summary
    if "profile" in phases:
        profile_phase(torch, graph)
    # each kernel's launches on the full run that is its path
    path = {name: PHASE[kind] for kind, names in PATH_KERNELS.items()
            for name in names}
    table = [{"name": name,
              **{k: v for k, v in row.items() if k != "shape"},
              "launches": launches.get(path.get(name, "imm_full"),
                                       {}).get(name, 0)}
             for name, row in rows.items()]
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
