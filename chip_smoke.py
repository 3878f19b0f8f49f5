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
            arena identical (on the sparse sampler; the dense-path cells
            below), imm() under LT with the positional and the stable
            walk on cuda and on cpu, identical, and tier_full's tenant mix
            at n 2,048 and theta 1,024 replayed synchronously (a refresh
            step after every pump) on cuda and on cpu: every ServedQuery
            but its latency, the stats and the selections identical; and
            mesh cells (2x2 equal and 1x2 balanced meshes of the card and
            of the host under IC/sparse, IC/pallas and LT/walk: each theta
            shard's rows sampled at a row offset; the pallas BFS
            column-blocked on the vertex tiles) equal to the
            single-device run on the host; the small tier again with
            every engine on a 2x2 mesh of the card and of the host, equal
            to the unmeshed replay; and pallas_full's com-LJ cell on a
            2x2 mesh of the card (the column-blocked BFS, overlap on and
            off): every row in its shard, the seeds, theta and influence
            bitwise the single-device pallas run
  imm_full  imm() on the full-size com-Amazon replica (IC, k = 50,
            eps = 0.5, max_theta = 16,384, rebuild), then the fused
            selections and four influence queries on its store
  packed_full, compressed_full
            the same solve, selections and queries on the IMPack packed
            and compressed stores: seeds, theta, influence and coverage
            equal imm_full's
  mesh_full imm_full's cell on meshes of the one card: 2x2 bitmap
            tiles (equal vertex blocks), 1x4 packed tiles (balanced
            blocks), 4x1 token tiles; each gives imm_full's seeds,
            influence, theta, gains and counter, and its fused
            selections the same seeds; per layout imm_s, sample_s,
            select_s, each tile's bytes and device, peak memory and the
            launches (arena_commit, arena_commit_packed, coverage_matvec,
            packed_count, token_count and ic_sparse_hits on the tiles);
            on the 2x2 store the tiles' padding and partial counters,
            the sharded-sparse strategy over its index view, a snapshot
            restored on a 1x1 mesh and into a BitmapStore, imm_full's
            snapshot restored on the 2x2 mesh and a replica (same seeds)
  indices_full
            imm() on the same replica under WC (sparse backend) with
            three engines: an IndexStore fed C4 index lists by the
            sampler (the emission width doubling and re-emitting the
            batch when a row comes back full), a bitmap store with the
            C4 chooser on (index-list selection through its index view
            when C4 picks it) and one with it off: seeds, theta,
            influence, covered_frac, counter and four influence queries
            identical; then a snapshot of the index engine restored into
            a fresh engine and replicated (identical answers; two more
            batches give identical counters)
  lt_full   imm() on the same replica under LT (positional walk, k = 50,
            eps = 0.5, max_theta = 16,384, bitmap store, C4 off so its
            "rebuild" selection runs coverage_matvec): the walk's coins
            through uniform_draw, the arena_commit writes, its first four
            batches equal to the port's walk on the host; as a check
            after it (launches printed apart), the fused selection
            (fused_select) and the C4 one equal; walk steps, timings,
            peak memory and the walk's device idle share (torch.profiler)
  stream_full
            a StreamEngine on the same replica under LT (LT/walk+stable,
            packed store: its batches and repairs written by
            arena_commit_packed, its kills counted by packed_count)
            extended to 16,384 rows, four fringe deltas (256 inserts,
            deletes and reweights each, destinations of in-degree <= 8),
            refreshed until drained and equal to a fresh engine on the
            post-delta graph (seeds, counter; the fresh engine's launches
            counted apart); a bounded stream whose byte cap sends the
            packed arena down the ladder to tokens once and then evicts,
            checked against the cap after every add_batch and
            replace_rows; IMServer over the stream (refresh budget 512),
            synchronous and with its async worker from one snapshot,
            equal once drained
  mesh_stream_full
            stream_full's cell on a 2x2 mesh of the card (packed tiles,
            balanced blocks): each delta's stale rows and the drained
            seeds, influence and counter equal stream_full's and a fresh
            meshed engine's (launches counted apart); a snapshot restored
            on a 1x1 mesh and that one's on 2x2 again, the next delta
            repairing all three alike; a bounded meshed stream under the
            same byte cap (ladder, then per-shard evictions) checked
            against the per-shard rule after every add_batch and
            replace_rows; IMServer sync and async (the stream and its
            2x2 restore);
            delta_s, refresh_s, stale rows, tile bytes, peak memory and
            the launches per kernel
  tier_full the IMServe tier at the reference's full serving-tier run
            (benchmarks/serve_tier.py --users 262144 --scale 1, five
            tenants): four R-MAT campaigns of n 262,144 and m 8n under WC
            weights (campaign-0 static, strict, weight 2, bitmap with
            fused-rebuild; campaign-1 streaming, packed; campaign-2
            static, relaxed, "auto" with C4, two replicas; campaign-3
            streaming, bitmap with rebuild; campaign-4 a slot on
            campaign-0's engine at weight 0.5), theta 1,024 an engine; the
            bench's trace (2 virtual seconds, 96 q/s a tenant, Zipf 1.0,
            a delta every 0.5 s) replayed with the refresh worker running,
            a drain, a top-k selection per tenant and a flood of
            max_pending + 64 submits to one tenant (exactly 64 refused,
            the others served in the same DRR round); every static answer
            equals its primary's, every cached stream answer a recompute
            at its epoch, each drained stream a fresh one (launches
            counted apart), both replicas the primary's store
  mesh_tier_full
            tier_full's five tenants with every engine (replicas and the
            fresh streams too) on a 2x2 mesh of the card, at theta 1,024
            (the bench's own, cut from 4,096 for the time limit), the
            same trace, checks and flood; it must drain (the meshed
            tenants share one dispatch lock)
  pallas_full
            imm() on the com-LJ Table III replica (n = 3,997, IC, k = 50,
            eps = 0.5, max_theta = 65,536) with the pallas backend (every
            BFS step one ic_frontier_step launch, walking the column
            form the bound sampler built once), then the dense one;
            rows on which they differ are classified as near-ties
  lm_parity the five LM smoke configs (three dense, two MoE; f32) and
            a narrow bf16 config of Qwen1.5-0.5B's shape served on cuda
            and on cpu from the same weights: prefill logits within
            tolerance, greedy tokens equal (a differing token only where
            the cpu run's top-2 logit gap is below the tolerance); a
            prompt and a decode token out of the vocabulary give NaN rows
            in the same places on both devices; for the five smoke
            configs lm_loss and every gradient leaf on cuda (attention's
            gradient through FlashAttention, remat on: two forward
            launches a layer and one of the SIMT backward) against the
            cpu's; the meshed MoE (ep and tpe) on 1x2 and 2x2 meshes of
            the card against the single-device MoE FFN at a capacity
            where nothing drops
  lm_full   LMServer on the full-width Qwen1.5-0.5B config (24 layers,
            d 1,024, vocab 151,936, bf16, random weights from a seeded
            generator on the card): 4 requests of 512 prompt tokens, 32
            generated tokens; prefill launches flash_attention once per
            layer, every launch through the tensor-core kernel
  lm_train  training on the card, every step through
            launch.train.make_step inside a runtime.TrainLoop on
            TokenPipeline batches: full-width Qwen1.5-0.5B (bf16, seeded
            weights, remat on, ce_chunk 512) at 4 x 4,096 (train_4k's
            sequence; its batch of 256 cut to 4) in two loops of 6 steps
            with a checkpoint every 3, run B's step 4 failing until its
            retries are used up, then restored from step 3's checkpoint
            and replayed: B's final params, moments and step bitwise A's;
            flash_attention launches held to 24 forward + 24 recompute a
            step call and flash_attention_bwd's to 24 (all on the
            tensor-core kernels), the loss falling, step ms, bytes on
            disk, save and load seconds, the time to recover, peak
            memory, the disk's free space; index_add_ against the sorted
            embedding gradient
            on the Zipf batch (equal runs of 5); one more step under the
            profiler (its device time and the share under the attention
            backward); run A's last checkpoint resharded onto a 2x2 mesh
            of the card (embed's vocab axis split) and gathered back
            bitwise; int8 compression with error feedback of one
            full-width gradient tree, timed, bitwise the CPU on the
            embedding's and layer 0's gradients; examples_torch/
            train_lm.py's qwen-100m (its register_100m, train_lm for 200
            steps of 8 x 256, a checkpoint every 50: the last 10 losses'
            mean below the first 10's); one
            layer's attention at the training shape (4 x 16 x 4,096 x
            64) through FlashAttention, its output held to the plain
            version and its dq, dk, dv to the plain version's autograd,
            on f32 copies, two backward calls bitwise equal, the
            backward kernels' ms beside the plain backward's, the
            kernel's forward and SDPA's forward + backward and backward
            alone (a yardstick), with the bound at 10 D and the
            design's 16 D flops a pair; the backward at grok's and
            Danube's head shapes and, in f32, at qwen-100m's, against
            the plain backward; the f32 backward at ATTN_BWD_F32_TIMED
            (from the forward's logsumexp and output: within 1e-4 of
            the plain backward, two calls bitwise, call ms and graph_ms,
            the bound at 10 D and 14 D, SDPA's f32 backward);
            then
            moonshot-v1-16b-a3b at full width cut to 2 layers (64
            experts top-6, capacity 960) takes two steps in a loop that
            writes no checkpoint, on 2 x 4,096 (each step's dropped
            choices from `moe.route`'s obs counters), the forward kernel
            checked at its head dim 128, and LMServer serves 4 prompts of
            512 tokens, 8 greedy tokens, twice, equal
  fm_parity the FM smoke config and a full-field one (39 fields x K 10,
            vocab 64) run on cuda and on cpu from the same weights: the
            pair term and the serving logits (one fm_gather_interaction
            launch a call) bitwise; retrieval scores, loss, gradients
            and three clipped AdamW steps within stated tolerances; an id
            and a candidate past the table give NaN in the same places
            on both devices
  fm_full   the FM arch at full width (39 x 1,000,000 x 10, a 1.56 GB
            f32 table drawn on the card from a seeded generator): the
            serve_p99 (512), serve_bulk (262,144), retrieval_cand (4 user
            fields vs 1,000,000 candidates) and train_batch (3 AdamW steps
            at 65,536 on the click stream) shapes; every serving call and
            retrieval constant launches fm_gather_interaction once, every
            training step fm_interaction once; the serve_p99 logits
            bitwise the cpu's; the serving batches again in turns on the
            unfused chain (gathers, float32 copy, unfused kernel, sums)
            and the fused route, with host times and peak memory; the
            cost of the training gathers' out-of-range repair
  fm_profile
            the same serve_bulk batch and train_batch step under
            torch.profiler: device-busy share and the kernels that take
            the device time (the IM sampler's: the optional profile)
  gnn_parity
            the four GNNs' smoke configs (graphsage-reddit, egnn,
            graphcast, equiformer-v2): each arch's smoke_step on cuda and
            on cpu from the same weights and threefry key, every output,
            the loss and every gradient leaf within 1e-4 * (1 + |cpu|);
            two hops of neighbor_sampler (1,024 seeds, 15-10) on an R-MAT
            graph, cuda ids bitwise cpu's; Equiformer's chunked edges
            equal to its flat ones on the card; GraphCast's dst-
            partitioned processor and sharded_aggregate on a 2x2 mesh of
            the card equal to the single-device forms (forward, loss,
            gradients); embedding_bag in all three modes and the row-
            sharded lookup, cuda against cpu
  gnn_full  the GNNs at their published widths, each step as the
            reference's make_gnn_train_step (loss, clip 1, AdamW):
            graphsage-reddit's minibatch_lg on a Reddit-scale graph built
            on the card (R-MAT scale 18 mod 232,965 nodes, self loops and
            duplicates dropped, 114,615,892 edges kept, an in-CSC) with
            the planted-partition features (232,965 x 602 f32 and a zero
            sentinel row): 1,024 seeds, both hops (15, 10) sampled on the
            card every step, 6 steps, step 1's loss and gradients held to
            the cpu's; graphcast (16 layers, d 512, remat, n_vars 1,433)
            and equiformer-v2 (12 layers, C 128, l_max 6, m_max 2) at
            full_graph_sm (2,708 nodes, 10,556 edges); egnn (4 layers, d
            64, d_feat 227) on molecule's 128 graphs of 30 nodes and 64
            edges as one disjoint union, its E(n) equivariance checked on
            the card; then examples_torch/gnn_node_classification.py
            (R-MAT 2,000 x 16,000, 150 AdamW steps; it asserts the last
            10 steps' minibatch accuracy above the first 10's by more
            than 0.1), which the examples phase takes as its run;
            step ms, sample ms, graph build s, peak memory, losses
  cells     the launchers (repro_torch.launch): all 39 cells (36 arch x
            shape cells and the three IMM production cells) dry-run on
            the 16x16 and 2x16x16 meshes of the meta device, nothing
            allocated on the card (one line: each cell's bytes per
            device, fits in 80 GiB, model flops); then each cell built by
            launch/steps.py on a 1x1 mesh of the card at its published
            width, or cut as CELL_CUTS says (the global batch, then the
            layers, then a graph's nodes and edges by one factor; each
            cut listed as reduced: {field: [published, run]}; a GNN
            keeps its published config: dtype, remat group, channel
            axis and the edge-chunked layout), one step
            (two for train: the second loss must differ) through
            dryrun.execute_cell: step ms (CUDA events), peak memory,
            executed flops (FlopCounterMode) beside the model flops, the
            collective census, the outputs checked; fm serve_bulk,
            imm_select_youtube_ic (bitwise) and graphcast full_graph_sm
            (within 1e-4 * (1 + |1x1|)) again on a 2x2 mesh of the card,
            held to their 1x1 run; coverage_matvec, flash_attention,
            flash_attention_bwd and ic_sparse_hits must launch
  examples  the port's examples (examples_torch/, one for each of the
            JAX package's examples/*.py), each main at its defaults on
            the card, what it prints sent to stderr: quickstart,
            influence_campaign, streaming_campaign,
            multi_tenant_campaign, recsys_ctr, gnn_node_classification
            (gnn_full's run) and train_lm --tiny (its default, qwen-100m
            for 200 steps, is lm_train's); a line each: wall seconds,
            the launches counted, the kernel dispatches and the returned
            dict (lists cut to every 10th item).  It fails on an
            example's own assertion, on a kernel's reference impl
            dispatched on the card, on a kernel of EXAMPLE_KERNELS not
            launched, and on a claim the example prints that does not
            hold; then, while the run is under TWIN_DEADLINE_S,
            quickstart and influence_campaign again on the host: equal
            to the card's answers (the sparse and walk samplers), or on
            the dense sampler equal or differing only in rows traced to
            classified near-ties

The kernels phase holds arena_commit (both kinds, with the batch's row
sums written into a stale sizes slice) bitwise on all-ones and all-zero
batches at B 255, 256, 257 and 511 and n 1, 7, 9, 15, 16, 17 and 4,099,
on random rows and at the main batch, times it eagerly and from a CUDA
graph beside torch's copies of the same rows, and prints a commit_step
line: the step's device time against the parent's form (the kernel,
then a PyTorch row sum into sizes).  It also holds packed_count and
token_count against their plain versions and coverage_matvec on edge
arenas (a row of s_pad real tokens and no sentinel, runs only, a run in
the last superblock, hub columns, both sides of every 4,096-column edge,
n = 1 mod 8, theta not a multiple of 32), on the stores' own views and
on token rows at odd strides and offsets, prints beside their byte
bounds the instruction
floors of their built hot loops (cuobjdump), and times them on a store
arena at compressed_full's s_pad (32,768).  It holds ic_frontier_step
against its plain version at the com-LJ replica's logq (B = 256,
frontier densities 0, 0.1%, 1%,
30%, 100%), at n = 16,384, on a fully dense logq (n 4,099), with -0.0
entries, past the kernel's 49,152-vertex staging chunk (n 100,000), on
ragged shapes, with coins on the threshold and on column blocks of
logq (as a meshed BFS's tile hands them: the whole table's columns bit
for bit, timed at a 2x2 tile), timed beside
its column form's build, torch.matmul and cuSPARSE; the coin kernels'
bounds come from their SASS instruction counts (cuobjdump) at the
card's issue and integer-ALU rates; and
flash_attention at the serving prefill (B 4 x 16 heads x S 512 x D 64),
Qwen's 8k prefill, Danube's (32:8 heads, D 120, window 4,096, S 8,192)
and prefill_32k (bf16: the tensor-core kernel; f32: the SIMT kernel,
timed at the two smaller shapes), ragged and decode-shaped, with the
host cost of the tensor-core kernel's TMA maps, and
fm_interaction bitwise at the FM shapes (serve_p99, train_batch,
serve_bulk at 39 x 10, f32 and bf16; B 1 and 1,025; F/K 6/4 and 16/8),
and fm_gather_interaction bitwise (NaN rows in the same places) at
serve_p99 and serve_bulk on the full 39,000,000-row table (f32 and bf16,
int32 and int64 ids, timed beside its byte bound, its sector floor and
the unfused chain in turns), the retrieval constant and edge cases (B 1
and 1,025, F/K 6/4, 16/8, K 5 in bf16, a wrapped and an out-of-range id);
the parity phase also runs the dense-path cells (IC/dense, IC/pallas,
WC/pallas, GT/pallas, IC/pallas+stable) on cuda and cpu.

With two or more cards a two_cards line holds each kernel on cuda:1
while cuda:0 is current and a 2x1 mesh across both against the host;
with one card it says it skipped them.

Then the kernel table (each kernel's launches counted on the one full
run that is its path: the bitmap kernels and the coins on imm_full, the
packed commit and packed_count on packed_full, token_count on
compressed_full, ic_frontier_step on pallas_full, flash_attention on
lm_full, flash_attention_bwd on lm_train, both FM kernels on fm_full;
beside them its launches on every full run, the meshed phases' and the
cells' included), the card's name and power limit, and ``{"ok": true,
"device": {...}}`` last.
Any failure exits non-zero without the ok line; so does a machine with
no CUDA device, or a directory without the repo's src/repro_torch.
Each phase's end goes to stderr with the seconds since the start.  A
run still going after WATCHDOG_S seconds, or stopped by a signal, dumps
every thread's Python stack to stderr; the watchdog then exits with
code 1, inside the 1,200 s limit.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import faulthandler
import json
import math
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks, read in `main` from the port's roofline
#: (`repro_torch.launch.roofline`, its ``h100`` row, NVIDIA's data
#: sheet): HBM bytes/s, the float32 rate outside the tensor cores (an FMA
#: counts two operations) and the dense bf16 tensor-core rate, the bound
#: of attention's flops.  The coin kernels' 32-bit integer work is bounded
#: from their built instructions instead (`coin_bound`)
HBM_BYTES_PER_S = ALU_OPS_PER_S = BF16_FLOPS_PER_S = None
#: Hopper's issue rate (warp instructions a SM a clock) and its integer
#: ALU lanes a SM a clock (IADD3, LOP3, SHF, ...: half the FP32 lanes;
#: H100 white paper, CUDA's throughput table for compute capability 9.0)
ISSUE_PER_SM_CLK, INT_LANES_PER_SM_CLK = 4, 64
#: SASS opcodes that issue to the integer ALU pipe
INT_ALU_OPS = frozenset({
    "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP",
    "SEL", "PRMT", "IMNMX", "VIMNMX", "IABS", "POPC", "FLO", "BREV",
    "BMSK", "SGXT", "VIADD"})

AMAZON_N, BATCH, THETA = 334_863, 256, 16_384
#: the com-LJ Table III replica (`IMM_EXPERIMENTS["com-LJ"].bench_scale`)
#: and IMMConfig's default theta cap, the pallas_full cell
LJ_SCALE, LJ_N, LJ_THETA = 0.001, 3_997, 1 << 16
DEV = "cuda"
#: seconds after which a run that has not ended dumps its stacks and exits
WATCHDOG_S = 1140


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


def time_graph(torch, fn, *, iters: int = 20, replays: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card with no host launch cost:
    ``iters`` calls captured in one CUDA graph, replayed ``replays``
    times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (iters * replays)


def timed(torch, fn):
    """``(fn(), seconds)`` on the host clock, between device syncs."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def load_peaks() -> None:
    """Set the bounds' peaks from the port's roofline h100 row."""
    from repro_torch.launch.roofline import HW_PEAKS

    global HBM_BYTES_PER_S, ALU_OPS_PER_S, BF16_FLOPS_PER_S
    row = HW_PEAKS["h100"]
    HBM_BYTES_PER_S = row["hbm_bytes_per_s"]
    ALU_OPS_PER_S = row["peak_flops_f32"]
    BF16_FLOPS_PER_S = row["peak_flops_bf16"]


def bound(nbytes: float, ops: float = 0.0,
          rate: float = None) -> tuple[float, str]:
    rate = ALU_OPS_PER_S if rate is None else rate
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clock_hz() -> tuple[float, str]:
    """The card's maximum SM clock as ``nvidia-smi`` reports it."""
    txt = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    txt = txt.splitlines()[0]
    return float(txt.split()[0]) * 1e6, txt


def sass_text(lib) -> str:
    """``cuobjdump -sass`` of a built library."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def sass_function(sass: str, kernel: str) -> str:
    """The SASS of the first function whose mangled name holds
    ``kernel``."""
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if kernel in name:
            return body
    raise KeyError(f"{kernel}: no such function in the SASS")


def opcode_counts(ops) -> dict:
    import collections
    by = collections.Counter(o for o in ops if o != "NOP")
    return dict(total=sum(by.values()),
                int_alu=sum(c for o, c in by.items() if o in INT_ALU_OPS),
                by_opcode=dict(by.most_common()))


def sass_counts(lib, kernel: str) -> dict:
    """Instructions of one kernel of a built library (``cuobjdump
    -sass``), up to its last EXIT (the self-branch after it and NOPs
    left out): all of them, the integer-ALU ones, and each opcode's."""
    import re

    body = sass_function(sass_text(lib), kernel)
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9]*)", body)
    check("EXIT" in ops, f"{kernel}: no EXIT in its SASS")
    return opcode_counts(ops[:len(ops) - ops[::-1].index("EXIT")])


def loop_counts(sass: str, kernel: str, anchor: str,
                outer: bool = False) -> dict:
    """Instructions one pass of a kernel's hot loop issues: the innermost
    loop (a backward branch's range) holding the first instruction that
    starts with ``anchor`` (``outer``: the loop around that one), less
    the loops nested in it and the branches it skips that hold an atomic
    (the planes' expansion, at most once in kMaxSteps passes); counted
    as `sass_counts` counts, with the loop's address range."""
    import re

    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9]*)([^;]*);",
                         sass_function(sass, kernel)):
        rest = m.group(4)
        tgt = re.search(r"0x([0-9a-f]+)\s*$", rest) \
            if m.group(3) == "BRA" else None
        ins.append((int(m.group(1), 16), m.group(3),
                    bool(m.group(2)) or rest.lstrip().startswith(("P", "!P")),
                    (m.group(3) + rest).replace(" ", ""),
                    int(tgt.group(1), 16) if tgt else None))
    loops = [(t, a) for a, op, _, _, t in ins
             if op == "BRA" and t is not None and t < a]
    first = next(a for a, _, _, text, _ in ins if text.startswith(anchor))
    around = sorted((lp for lp in loops if lp[0] <= first <= lp[1]),
                    key=lambda lp: lp[1] - lp[0])
    lo, hi = around[1 if outer else 0]
    nested = [lp for lp in loops if lo <= lp[0] and lp[1] <= hi
              and lp != (lo, hi)]
    atomic = [a for a, op, _, _, _ in ins
              if op in ("ATOMS", "ATOM", "ATOMG", "RED", "REDG")]
    skipped = [(a, t) for a, op, cond, _, t in ins
               if op == "BRA" and cond and t is not None and lo <= a < t <= hi
               and any(a < x < t for x in atomic)]
    ops = [op for a, op, _, _, _ in ins if lo <= a <= hi
           and not any(x <= a <= y for x, y in nested)
           and not any(x < a < y for x, y in skipped)]
    return dict(opcode_counts(ops), loop=[hex(lo), hex(hi)])


def instruction_floor(torch, passes) -> dict:
    """The least time the built instructions of a data-dependent kernel
    take: ``passes`` is ``[(loop_counts(...), warp passes), ...]``; each
    warp pass issues the loop's instructions once (its lanes each run
    the integer-ALU ones), at Hopper's issue rate and integer-ALU lanes
    at the card's maximum SM clock (as `coin_bound`)."""
    clk, _ = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp = sum(c["total"] * k for c, k in passes)
    lanes = sum(c["int_alu"] * 32 * k for c, k in passes)
    return dict(issue_floor_ms=warp / (ISSUE_PER_SM_CLK * sms * clk) * 1e3,
                int_alu_floor_ms=lanes / (INT_LANES_PER_SM_CLK * sms * clk)
                * 1e3)


def coin_bound(torch, kernel: str, count: int, nbytes: int) -> dict:
    """The bound of a threefry coin kernel over ``count`` coins (one a
    thread, so a thread issues its kernel's instructions once): the
    larger of its bytes at the HBM rate, (a) its SASS instructions at
    the issue rate and (b) its integer-ALU instructions at the ALU
    lanes, at the card's maximum SM clock; beside it the nominal
    ``OPS_PER_COIN`` at the f32 rate, the bound used before."""
    from repro_torch.kernels import build, coins

    sass = sass_counts(build.lib_path("coins"), kernel)
    clk, clk_txt = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_s = count * sass["total"] / 32 / (ISSUE_PER_SM_CLK * sms * clk)
    int_s = count * sass["int_alu"] / (INT_LANES_PER_SM_CLK * sms * clk)
    b_s, b_by = max((nbytes / HBM_BYTES_PER_S, "bytes"),
                    (issue_s, "operations"), (int_s, "operations"))
    emit("coin_sass", kernel=kernel, sm_clock=clk_txt, sms=sms,
         power=nvidia_smi(), **sass)
    return dict(bound_ms=b_s * 1e3, bound_by=b_by,
                issue_bound_ms=issue_s * 1e3, int_alu_bound_ms=int_s * 1e3,
                nominal_bound_ms=bound(nbytes,
                                       count * coins.OPS_PER_COIN)[0],
                sass_per_coin=sass["total"],
                int_alu_per_coin=sass["int_alu"],
                ops_per_coin_nominal=coins.OPS_PER_COIN,
                sm_clock_mhz=clk / 1e6)


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


#: arena_commit's edge cases: all-ones and all-zero batches at each B
#: (byte lanes of 255 rows and past) and each ragged n, then random rows
COMMIT_EDGE_B, COMMIT_EDGE_N = (255, 256, 257, 511), (1, 7, 9, 15, 16, 17,
                                                     4099)
COMMIT_RANDOM = ((70, 1000), (3, 17), (5, 1), (256, 4099), (1, 334_863))


def commit_batch(torch, gen, Bc: int, nc: int, fill: str):
    """A ``(Bc, nc)`` view of a row-padded batch whose pad bytes hold 1s:
    all ones, all zeros or 15% random."""
    from repro_torch.kernels import ops
    src = torch.ones((Bc, ops.padded_width(nc)), dtype=torch.uint8,
                     device="cuda")
    if fill != "ones":
        src[:, :nc] = (0 if fill == "zeros" else torch.randint(
            0, 100, (Bc, nc), generator=gen, device="cuda") < 15)
    return src[:, :nc]


def commit_case(torch, gen, kind: str, rows, lo: int):
    """``rows`` committed into arena rows [lo, lo + B) by the kernel and
    by the plain version, each with a stale sizes slice: the whole arena
    (rows before lo and row padding untouched), counter and sizes
    bitwise.  Returns the kernel's operands, the plain version's and the
    kernel's arena."""
    from repro_torch.kernels import commit, ops
    Bc, nc = rows.shape
    w = nc if kind == "bitmap" else -(-nc // 8)
    arena = torch.zeros((lo + Bc, ops.padded_width(w)), dtype=torch.uint8,
                        device="cuda")
    cnt = torch.randint(0, 50, (nc,), generator=gen, device="cuda",
                        dtype=torch.int32)
    sizes = torch.randint(-9, 9, (lo + Bc,), generator=gen, device="cuda",
                          dtype=torch.int32)
    whole = (arena, cnt, sizes)
    want = [t.clone() for t in whole]
    got = (rows, arena[lo:, :w], cnt, sizes[lo:])
    ref = (rows, want[0][lo:, :w], want[1], want[2][lo:])
    ops.arena_commit(*got[:3], kind=kind, sizes=got[3])
    plain = (commit.arena_commit_plain if kind == "bitmap"
             else commit.arena_commit_packed_plain)
    plain(*ref)
    for a, b, what in zip(whole, want, ("rows", "counter", "sizes")):
        check(torch.equal(a, b), f"arena_commit {kind} {Bc}x{nc} {what}")
    return got, ref, arena


def commit_rows(torch, gen, B: int, n: int) -> dict:
    """Both kinds of arena_commit against their plain versions (edge
    cases, random rows and the main path's batch of sampler-shaped rows
    into rows [B, 2B) of an arena); times at that batch; the bitmap row's
    copy yardsticks; and the commit step against the parent's form."""
    from repro_torch.kernels import commit, ops
    out, step = {}, {}
    buf, rows = bitmap_arena(torch, B, n, gen, ld=ops.padded_width(n))
    for kind in ("bitmap", "packed"):
        for Bc in COMMIT_EDGE_B:
            for nc in COMMIT_EDGE_N:
                for fill in ("ones", "zeros"):
                    batch = commit_batch(torch, gen, Bc, nc, fill)
                    got, _, _ = commit_case(torch, gen, kind, batch, 3)
                    check(bool((got[3] == (nc if fill == "ones" else 0))
                               .all()), f"arena_commit {kind} {fill} sizes")
        for Bc, nc in COMMIT_RANDOM:
            commit_case(torch, gen, kind,
                        commit_batch(torch, gen, Bc, nc, "random"), Bc)
        got, ref, arena = commit_case(torch, gen, kind, rows, B)
        cuda = (commit.arena_commit_cuda if kind == "bitmap"
                else commit.arena_commit_packed_cuda)
        plain = (commit.arena_commit_plain if kind == "bitmap"
                 else commit.arena_commit_packed_plain)
        rows_, dst, cnt, sizes = got

        def kernel():
            cuda(rows_, dst, cnt, sizes)

        def parent():
            # the parent's commit step: the kernel, then a PyTorch row sum
            cuda(rows_, dst, cnt)
            sizes.copy_(rows_.sum(dim=1, dtype=torch.int32))

        w = dst.shape[1]
        b_ms, b_by = bound(B * n + B * w + 8 * n + 4 * B)
        name = commit.KERNEL if kind == "bitmap" else commit.KERNEL_PACKED
        out[name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/commit.cu",
            replaces="src/repro/kernels/commit.py:"
                     + ("75" if kind == "bitmap" else "118"),
            max_abs_err=0, ms=time_cuda(torch, kernel, iters=20),
            graph_ms=time_graph(torch, kernel),
            plain_ms=time_cuda(torch, lambda: plain(*ref), iters=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=[B, n])
        step[kind] = dict(parent_graph_ms=time_graph(torch, parent),
                          graph_ms=time_graph(torch, kernel))
        if kind == "bitmap":
            # yardsticks, not the function: torch's copy of the same rows
            # as one padded block (a memcpy) and as (B, n) views
            block = arena[B:]
            out[name].update(
                copy_block_ms=time_cuda(torch, lambda: block.copy_(buf),
                                        iters=20),
                copy_view_ms=time_cuda(torch, lambda: dst.copy_(rows_),
                                       iters=20))
        del got, ref, arena
    emit("commit_step", shape=[B, n], **step)
    return out


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


def count_edge_arenas(torch, gen):
    """``(tag, R)`` of the edge cases the decode-and-count kernels are
    held to: ``R (theta, n)`` 0/1 row-padded uint8 views on the card."""
    from repro_torch.kernels import ops

    def blank(theta, n):
        buf = torch.zeros((theta, ops.padded_width(n)), dtype=torch.uint8,
                          device="cuda")
        return buf[:, :n]

    def rand(theta, n, p):
        R = blank(theta, n)
        R.copy_(torch.rand((theta, n), generator=gen, device="cuda") < p)
        return R

    R = blank(37, 512)
    R[:, ::8] = 1                  # 64 literals a row: s_pad 64, no sentinel
    yield "no_sentinel", R
    R = blank(50, 2048)
    R[::2] = 1                     # rows of runs only, and empty rows
    yield "runs_only", R
    R = rand(40, 2304, 0.2)
    R[1::3, -256:] = 1             # a run in the last superblock
    yield "last_superblock_run", R
    R = rand(1000, 5000, 0.05)
    R[:, [0, 1234, 4999]] = 1      # hub columns: count = theta
    yield "hub_columns", R
    n = 5 * 8192 + 3
    R = rand(600, n, 0.02)
    R[:, [c for k in range(0, n + 1, 4096) for c in (k - 1, k, k + 1)
          if 0 <= c < n]] = 1      # both sides of every 4,096-column edge
    yield "span_edges", R
    yield "n_1_mod_8", rand(300, 4097, 0.3)
    yield "theta_1013", rand(1013, 3000, 0.1)


def store_arenas(torch, R, *, chunk: int = 1024):
    """The rows of ``R (theta, n)`` written into a packed and a
    compressed store on the card; their ``st.R`` views, as the greedy
    rounds hand them to the kernels."""
    from repro_torch.core.store import make_store

    theta, n = R.shape
    stores = {kind: make_store(kind, n, device="cuda")
              for kind in ("packed", "compressed")}
    for s in range(0, theta, chunk):
        for st in stores.values():
            st.add_batch(R[s:s + chunk])
    check(all(st.count == theta for st in stores.values()), "store rows")
    return stores["packed"], stores["compressed"]


def segment_reads(torch, T, seg, n: int, *, chunk: int = 1024) -> int:
    """Tokens token_count's literal reads ask for with every row alive:
    for each row's nonempty segment of a span (``seg`` from
    `token_segments`), the 16-byte loads from the segment's start to the
    kernel's read limit (as many tokens as the span has bytes from the
    first literal's block on, and one more), taking the first literal's
    token as known (at a group's first span the kernel reads from the
    span's first byte instead)."""
    from repro_torch.core.pack import codec as pc
    from repro_torch.kernels import packed_count as pcm

    theta, s_pad = T.shape
    nbp = pc.n_blocks_padded(n)
    spans = seg.shape[1] - 1
    b1 = (torch.arange(1, spans + 1, device=T.device) * pcm.SPAN_BYTES
          ).clamp(max=nbp)
    total = 0
    for s in range(0, theta, chunk):
        start, end = seg[s:s + chunk, :-1], seg[s:s + chunk, 1:]
        first = T[s:s + chunk].long().gather(1, start.clamp(max=s_pad - 1))
        limit = torch.minimum(start + (b1 - (first >> pc.TOKEN_SHIFT)) + 1,
                              torch.full_like(start, s_pad))
        ask = ((limit + 3) & ~3) - (start & ~3)
        total += int(ask[end > start].sum())
    return total


def count_rows(torch, R, gen) -> dict:
    """packed_count and token_count against their plain versions and
    against coverage_matvec over the same rows: ragged shapes, saturated
    runs, the edge arenas (`count_edge_arenas`), arenas as the stores
    hand them over and token views at odd strides and offsets, with
    random, full, all-zero and float ``alive``; then at the main path's
    shape, the ``(theta, n)`` arena ``R`` (with saturated rows added)
    packed and as tokens, their times there beside their byte bounds and
    the built kernels' instruction floors; and their times on a store
    arena at compressed_full's s_pad (32,768)."""
    from repro_torch.core.pack import codec as pc
    from repro_torch.kernels import build
    from repro_torch.kernels import coverage_matvec as cov
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_count as pcm

    def agree(Rc, tag, P=None, T=None):
        theta, n = Rc.shape
        need = None
        if P is None:
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
    for tag, Rc in count_edge_arenas(torch, gen):
        P, T, _ = agree(Rc, tag)
        if tag == "no_sentinel":
            check(T.shape[1] == 64
                  and bool((T != pc.token_sentinel(Rc.shape[1])).all()),
                  "no_sentinel: every token real")
        if tag == "n_1_mod_8":
            theta, s_pad = T.shape
            Ps, Ts = store_arenas(torch, Rc)
            agree(Rc, f"{tag} store views", Ps.R[:theta], Ts.R[:theta])
            wide = torch.zeros((theta + 1, s_pad + 8), dtype=torch.int32,
                               device="cuda")
            for off in (0, 4, 1):   # row stride s_pad + 8; 16-byte loads
                wide.zero_()        # at offsets 0 and 4, one by one at 1
                wide[1:, off:off + s_pad] = T
                agree(Rc, f"{tag} tokens at offset {off}", P,
                      wide[1:, off:off + s_pad])

    theta, n = R.shape
    R[5::64] = 1                           # whole rows of saturated runs
    R[37::64, 2560:2560 + 256 * 40] = 1    # superblock-aligned spans
    P, T, need = agree(R, "full size")
    full = torch.ones(theta, dtype=torch.bool, device="cuda")
    nb = P.shape[1]
    # the instruction floors: a packed_count warp pass adds 8 rows of one
    # 512-byte slice; a token_count pass reads one row's literals of one
    # span (its round loop) in one batch (the loop around it)
    seg = pcm.token_segments(T, n)
    pairs = int((seg[:, 1:] > seg[:, :-1]).sum())
    requested = segment_reads(torch, T, seg, n)
    del seg
    p_sass = sass_text(build.lib_path("packed_count"))
    t_sass = sass_text(build.lib_path("token_count"))
    p_loop = loop_counts(p_sass, "packed_count_kernel", "LDG.E.128")
    t_round = loop_counts(t_sass, "token_count_kernelILb1", "LDG.E.128")
    t_batch = loop_counts(t_sass, "token_count_kernelILb1", "LDG.E.128",
                          outer=True)
    steps = -(-nb // 512) * -(-theta // 8)
    floors = {"packed_count": instruction_floor(torch, [(p_loop, steps)]),
              "token_count": instruction_floor(
                  torch, [(t_round, pairs), (t_batch, pairs)])}
    emit("count_sass", power=nvidia_smi(), steps=steps, segments=pairs,
         packed_loop=p_loop, token_round_loop=t_round,
         token_batch_loop=t_batch)
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
            bound_ms=b_ms, bound_by=b_by, library_ms=None, **floors[name],
            shape=[theta, n] if name == "packed_count"
            else [theta, T.shape[1]])
    emit("count_arenas", theta=theta, n=n, packed_bytes=theta * nb,
         s_pad=T.shape[1], token_bytes=T.numel() * 4,
         real_token_bytes=4 * int(need.sum()),
         segment_read_bytes=4 * requested,
         rows_holding_tokens=int((need > 1).sum()))
    del P, T, need

    # a store arena at compressed_full's s_pad: the dense rows hold 15%
    # of the vertices (about 30,400 tokens), the others one vertex
    dense = torch.arange(theta, device="cuda") % 16 >= 9
    for s in range(0, theta, 1024):
        d = dense[s:s + 1024].nonzero().squeeze(1) + s
        R[d] = (torch.rand((d.numel(), n), generator=gen, device="cuda")
                < 0.15).to(torch.uint8)
    Ps, Ts = store_arenas(torch, R)
    check(Ts.codec.s_pad == 32768, f"store arena s_pad {Ts.codec.s_pad}")
    real = 4 * sum(int((Ts.R[s:s + 1024] != Ts.codec.fill).sum())
                   for s in range(0, theta, 1024))
    want = cov.coverage_matvec_plain(full, R).to(torch.int32)
    check(torch.equal(ops.packed_count(Ps.R, full, n=n), want)
          and torch.equal(ops.token_count(Ts.R, full, n=n), want),
          "count kernels on the store arena")
    seg = pcm.token_segments(Ts.R, n)
    requested = segment_reads(torch, Ts.R, seg, n)
    del seg
    emit("count_store_arena", theta=theta, n=n, s_pad=Ts.codec.s_pad,
         real_token_bytes=real, segment_read_bytes=4 * requested,
         power=nvidia_smi(),
         packed_ms=time_cuda(torch, lambda: pcm.packed_count_cuda(
             Ps.R, full, n)),
         packed_bound_ms=bound(theta * nb + theta + 4 * n)[0],
         token_ms=time_cuda(torch, lambda: pcm.token_count_cuda(
             Ts.R, full, n)),
         token_bound_ms=bound(real + theta + 4 * n)[0])
    return rows


def random_logq(torch, gen, n: int, per_col: int, pmax: float = 1.0):
    """An ``(n, n)`` log(1-p) table on the card with about ``per_col``
    nonzeros a column (all of them when ``per_col >= n``), p ~ U(0, pmax)."""
    L = torch.zeros((n, n), dtype=torch.float32, device="cuda")
    if per_col >= n:
        L.copy_(torch.log1p(-pmax * torch.rand((n, n), generator=gen,
                                               device="cuda")))
    else:
        rows = torch.randint(0, n, (per_col * n,), generator=gen,
                             device="cuda")
        cols = torch.arange(n, device="cuda").repeat(per_col)
        L[rows, cols] = torch.log1p(-pmax * torch.rand(
            per_col * n, generator=gen, device="cuda"))
    return L.clamp_(min=-30.0)


def frontier_inputs(torch, gen, B: int, n: int, density: float,
                    padded: bool):
    """frontier, visited (row-padded views when ``padded``), rand."""
    from repro_torch.kernels import ops

    ld = ops.padded_width(n) if padded else n
    f = torch.zeros((B, ld), dtype=torch.bool, device="cuda")
    v = torch.zeros((B, ld), dtype=torch.bool, device="cuda")
    f[:, :n] = torch.rand((B, n), generator=gen, device="cuda") < density
    v[:, :n] = (torch.rand((B, n), generator=gen, device="cuda") < 0.2) \
        | f[:, :n]
    rand = torch.rand((B, n), generator=gen, device="cuda")
    return f[:, :n], v[:, :n], rand


def frontier_row(torch, gen, lj_logq) -> dict:
    """ic_frontier_step against its plain version, bitwise: the solve's
    shape (B 256 x the com-LJ replica's logq, n 3,997) at frontier
    densities 0, 0.1%, 1%, 30% and 100%; B 256 x n 16,384 (logq 1.07 GB,
    32 nonzeros a column); a logq with -0.0 entries; a fully dense logq at
    n 4,099; ragged shapes; coins on the threshold.  Timed at the solve's
    shape, at n 16,384 and on the dense logq, each beside the column
    form's build, ``torch.matmul`` and cuSPARSE (``torch.sparse.mm``)."""
    from repro_torch.core import ties
    from repro_torch.kernels import ic_frontier as icf
    from repro_torch.kernels import ops

    def agree(F, V, L, R, tag, cols=None):
        got = ops.ic_frontier_step(F, V, L, R, cols=cols)
        want = icf.ic_frontier_step_plain(F, V, L, R, cols)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"ic_frontier_step {tag}: {bad} cells differ")
        rows, n = got.shape
        whole = torch.as_strided(got, (rows, got.stride(0)), (got.stride(0),
                                                              1))
        check(int(whole[:, n:].sum()) == 0, f"ic_frontier_step {tag}: pad")
        return got

    def near_ties(acc, F, L, R, V, got, tag):
        """Cells where a library's sum decides otherwise than the kernel:
        each must be a near-tie."""
        b, u = torch.nonzero(icf.activation(acc, R, V) != got.bool(),
                             as_tuple=True)
        _, tie = ties.classify_cells(F, L, R, b.cpu().numpy(),
                                     u.cpu().numpy())
        check(bool(tie.all()), f"{tag}: {int((~tie).sum())} cells are not "
              f"near-ties")
        return int(b.numel())

    for n in (1, 7, 129, 513, 4099):
        L = random_logq(torch, gen, n, n if n <= 513 else 24)
        for B in (1, 3, 70):
            for padded in (False, True):
                F, V, R = frontier_inputs(torch, gen, B, n, 0.3, padded)
                agree(F, V, L, R, f"{B}x{n}")
    B, n = BATCH, lj_logq.shape[0]
    lj_cols = icf.column_form(lj_logq)
    for density in (0.0, 0.001, 0.01, 0.3, 1.0):
        F, V, R = frontier_inputs(torch, gen, B, n, density, True)
        if density == 1.0:
            V = V & (torch.rand(V.shape, generator=gen, device="cuda") < 0.2)
        agree(F, V, lj_logq, R, f"{B}x{n} density {density}", lj_cols)
    # -0.0 and +0.0 entries: neither is a term
    L = random_logq(torch, gen, 4099, 24)
    L[(L == 0) & (torch.rand(L.shape, generator=gen, device="cuda") < 0.5)
      ] = -0.0
    check(bool(torch.signbit(L[L == 0]).any()), "a logq with -0.0 entries")
    F, V, R = frontier_inputs(torch, gen, B, 4099, 0.3, True)
    agree(F, V, L, R, f"{B}x4099 signed zeros")
    # past 49,152 vertices the kernel stages the frontier in chunks: a
    # form spread over n = 100,000, the whole table (no dense logq)
    nc, per = 100_000, 6
    start = torch.randint(0, nc // per, (nc, 1), generator=gen,
                          device="cuda")
    far = icf.ColumnForm(
        (per * torch.arange(nc + 1, device="cuda")).to(torch.int32),
        (start + nc // per * torch.arange(per, device="cuda")).to(
            torch.int32).reshape(-1),
        torch.log1p(-torch.rand(nc * per, generator=gen, device="cuda")),
        nc, nc * per)
    F, V, R = frontier_inputs(torch, gen, 40, nc, 0.3, True)
    agree(F, V, None, R, f"40x{nc} chunked", far)
    del far
    # coins on the threshold: rand = p fires nothing, p's lower f32
    # neighbour fires every live cell, its upper one none
    F, V, _ = frontier_inputs(torch, gen, B, n, 0.01, True)
    V = V & False
    p = torch.expm1(icf.ascending_acc(F, lj_logq, lj_cols).double()
                    ).neg_().float()
    live = p > 0
    for shift, fires in ((0.0, False), (-1.0, True), (1.0, False)):
        R = p if not shift else torch.nextafter(
            p, torch.full_like(p, shift * float("inf")))
        got = agree(F, V, lj_logq, R.contiguous(), f"tie {shift:+}", lj_cols)
        check(bool((got[live] == fires).all()),
              f"ic_frontier_step tie {shift:+}: wrong side")
    del L, F, V, R, p, live
    # column blocks of logq, as a tile of the meshed BFS hands them (all
    # n frontier vertices, w output columns): the whole table's columns
    # bit for bit; timed at a 2x2 mesh's tile (128 rows, half the columns)
    block = {}
    for lo, hi, rows in ((0, n // 2, B // 2), (n // 2, n, B // 2),
                         (3990, n, 3), (0, 1, 70)):
        blk = lj_logq[:, lo:hi].contiguous()
        bcols = icf.column_form(blk)
        F, V, R = frontier_inputs(torch, gen, rows, n, 0.3, True)
        got = agree(F, V[:, lo:hi], blk, R[:, lo:hi], f"block {lo}:{hi}",
                    bcols)
        whole = ops.ic_frontier_step(F, V, lj_logq, R, cols=lj_cols)
        check(torch.equal(got, whole[:, lo:hi]),
              f"ic_frontier_step block {lo}:{hi}: not the table's columns")
        if lo == 0 and rows == B // 2:
            block = dict(shape=[rows, n, hi - lo], ms=time_cuda(
                torch, lambda: ops.ic_frontier_step(
                    F, V[:, lo:hi], None, R[:, lo:hi], cols=bcols)),
                graph_ms=time_graph(torch, lambda: ops.ic_frontier_step(
                    F, V[:, lo:hi], None, R[:, lo:hi], cols=bcols)),
                whole_ms=time_cuda(torch, lambda: ops.ic_frontier_step(
                    F, V, None, R, cols=lj_cols)))
    del F, V, R, blk, bcols

    times, lib_ties = {}, {}
    tables = (("solve", lambda: lj_logq, (0.3, 0.01)),
              ("n16384", lambda: random_logq(torch, gen, 16_384, 32),
               (0.3, 0.01)),
              # every entry a term; p small enough that the sums do not
              # all saturate at p = 1
              ("dense4099", lambda: random_logq(torch, gen, 4099, 4099,
                                                pmax=1e-3), (0.3,)))
    for name, make, densities in tables:
        L = make()
        nn = L.shape[0]
        form_ms = time_cuda(torch, lambda: icf.column_form(L), warmup=1,
                            iters=3)
        cols = icf.column_form(L)
        check(cols.nnz == int((L != 0).sum()), f"column form {name}: nnz")
        # logq^T in CSR is the column form itself: cuSPARSE's SpMM
        csr = torch.sparse_csr_tensor(cols.col_ptr.long(), cols.rows.long(),
                                      cols.vals, (nn, nn))

        def spmm(F):
            return torch.sparse.mm(csr, F.float().t().contiguous()).t()

        for density in densities:
            tag = f"{name}_{density}"
            F, V, R = frontier_inputs(torch, gen, B, nn, density, True)
            got = agree(F, V, L, R, f"{B}x{nn} {tag}", cols)
            # a loop of eager calls, as every kernel and library time
            # here, and the device time alone from a CUDA graph (a
            # call's host cost, ~0.05 ms, is above the kernel's at the
            # sparse shapes)
            ms = time_cuda(torch, lambda: icf.ic_frontier_step_cuda(
                F, V, L, R, cols))
            graph_ms = time_graph(torch, lambda: icf.ic_frontier_step_cuda(
                F, V, L, R, cols))
            plain_ms = time_cuda(torch, lambda: icf.ic_frontier_step_plain(
                F, V, L, R, cols), warmup=1, iters=2)
            # the library products sum in their own orders: every cell
            # where one disagrees with the kernel is a near-tie
            lib_ties[tag] = dict(
                matmul=near_ties(F.float() @ L, F, L, R, V, got,
                                 f"torch.matmul {tag}"),
                sparse_mm=near_ties(spmm(F), F, L, R, V, got,
                                    f"torch.sparse.mm {tag}"))
            library_ms = time_cuda(torch, lambda: icf.activation(
                F.float() @ L, R, V))
            sparse_library_ms = time_cuda(torch, lambda: icf.activation(
                spmm(F), R, V))
            # the work these inputs need: the four (B, n) operands and
            # the column form read once, and one f32 add (an FMA's two
            # operations) for each frontier entry and nonzero of logq's
            # row v; the zero terms are none of the function's work
            terms = int((F.sum(0, dtype=torch.int64)
                         * (L != 0).sum(1, dtype=torch.int64)).sum())
            b_ms, b_by = bound(7 * B * nn + cols.nbytes, 2 * terms)
            row = dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       sparse_library_ms=sparse_library_ms, bound_ms=b_ms,
                       bound_by=b_by,
                       dense_bound_ms=bound(4 * nn * nn + 7 * B * nn)[0],
                       column_form_ms=form_ms,
                       column_form_bytes=cols.nbytes, nnz=cols.nnz,
                       terms=terms, shape=[B, nn])
            times[tag] = row
        del F, V, R, L, cols, csr
        torch.cuda.empty_cache()
    emit("ic_frontier_step", library_near_ties=lib_ties, column_block=block,
         **times)
    row = times["solve_0.3"]
    return dict(route="cuda", source="src/repro_torch/kernels/csrc/"
                "ic_frontier.cu", replaces="src/repro/kernels/"
                "ic_frontier.py:55", max_abs_err=0, **row)



#: (name, B, Hq, Hkv, S, D, window): the serving cell's prefill, Qwen's
#: 8k prefill, Danube's attention shape, and prefill_32k (lm_shapes)
ATTN_TIMED = (("serve_prefill", 4, 16, 16, 512, 64, 0),
              ("qwen_8k", 1, 16, 16, 8192, 64, 0),
              ("danube_8k", 1, 32, 8, 8192, 120, 4096),
              ("prefill_32k", 1, 16, 16, 32768, 64, 0))
#: the SIMT kernel's timed shapes in f32 (name, B, Hq, Hkv, S, D, window):
#: the serving prefill, Qwen's 8k prefill, and qwen-100m's training shape
#: (examples/train_lm.py, 8 x 256); the f32 forward's probe adds
#: danube_8k (scripts/attention_bwd_probe.py --forward)
ATTN_F32_TIMED = (("serve_prefill", 4, 16, 16, 512, 64, 0),
                  ("qwen_8k", 1, 16, 16, 8192, 64, 0),
                  ("qwen_100m", 8, 8, 8, 256, 64, 0))
#: flash_attention against its plain version: |err| <= tol * (1 + |ref|).
#: f32: the same f32 arithmetic summed in another order (~1e-6 seen in
#: the CPU tests); bf16: both round the same f32 value once, so they differ
#: by at most one bf16 step (2**-8 of |ref|) where their f32 sums straddle
#: a rounding boundary
ATTN_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def attention_inputs(torch, gen, B, Hq, Hkv, Sq, Skv, D, dtype):
    def draw(h, s):
        return torch.randn((B, h, s, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    return draw(Hq, Sq), draw(Hkv, Skv), draw(Hkv, Skv)


def attention_err(torch, got, want, dtype_name: str, tag: str):
    """(max abs err, max err / (1 + |ref|)), checked against ATTN_TOL."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"flash_attention {tag}: not finite")
    diff = (g - w).abs()
    rel = float((diff / (1 + w.abs())).max())
    check(rel <= ATTN_TOL[dtype_name], f"flash_attention {tag}: err "
          f"{rel:.3g} > {ATTN_TOL[dtype_name]} (max abs {float(diff.max())})")
    return float(diff.max()), rel


def attention_bound(B, Hq, Hkv, Sq, Skv, D, window, f32: bool = False):
    """(flops, bytes, bound ms, bound_by) of one call: 4 D flops per
    admitted pair, at the bf16 tensor-core rate, or with ``f32`` (the SIMT
    kernel's operands) at the f32 rate outside the tensor cores; q, k, v
    read once and the output written once, 2 or 4 bytes an element."""
    from repro_torch.kernels import flash_attention as fa

    flops = 4 * D * B * Hq * fa.admitted_pairs(Sq, Skv, window=window)
    nbytes = (4 if f32 else 2) * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)
    return (flops, nbytes) + bound(
        nbytes, flops, ALU_OPS_PER_S if f32 else BF16_FLOPS_PER_S)


def sdpa(torch, q, k, v, window: int):
    """The library call for the same function (timed, never in the port):
    causal, GQA without a repeat in memory, a boolean mask for a window."""
    F = torch.nn.functional
    if not window:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    S = q.shape[2]
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def attention_rows(torch, gen) -> dict:
    """flash_attention against its plain version on the card: ragged,
    decode-shaped, GQA, windowed, D 8-256, f32 (the SIMT kernel) and bf16
    (the tensor-core kernel), and the four timed shapes in bf16 (the 32k
    one too, in query blocks); the kernel's, the plain version's and
    SDPA's times there, with the bound, the share of the 989 TFLOP/s bf16
    rate the kernel reaches and the ratio to SDPA; the SIMT kernel's f32
    rows at ``ATTN_F32_TIMED`` (`attention_f32_row`); and the host cost
    of encoding the tensor-core kernel's TMA maps at the serving
    prefill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    cases = []
    for B, Hq, Hkv, Sq, Skv, D, window in (
            (4, 16, 16, 512, 512, 64, 0), (2, 4, 2, 1000, 1000, 64, 0),
            (4, 16, 16, 1, 512, 64, 0), (2, 4, 4, 100, 1000, 64, 64),
            (2, 4, 2, 77, 77, 16, 8), (1, 4, 1, 300, 300, 120, 0),
            (1, 2, 2, 130, 130, 256, 0), (3, 2, 1, 65, 65, 8, 5),
            (1, 4, 2, 129, 129, 128, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attention_inputs(torch, gen, B, Hq, Hkv, Sq, Skv, D,
                                       dtype)
            name = str(dtype).split(".")[1]
            tag = f"{B}x{Hq}:{Hkv}x{Sq}/{Skv}xD{D} w{window} {name}"
            abs_e, rel_e = attention_err(
                torch, ops.flash_attention(q, k, v, window=window),
                fa.flash_attention_plain(q, k, v, window=window), name, tag)
            cases.append(dict(case=tag, impl=fa.design(q, k, v),
                              max_abs_err=abs_e, max_rel_err=rel_e))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(torch, gen, 2, 4, 2, 50, 90, 32, dtype)
        name = str(dtype).split(".")[1]
        abs_e, rel_e = attention_err(
            torch, ops.flash_attention(q, k, v, causal=False, window=16),
            fa.flash_attention_plain(q, k, v, causal=False, window=16), name,
            f"non-causal {name}")
        cases.append(dict(case=f"non-causal 2x4:2x50/90xD32 w16 {name}",
                          impl=fa.design(q, k, v), max_abs_err=abs_e,
                          max_rel_err=rel_e))

    timed = {}
    for name, B, Hq, Hkv, S, D, window in ATTN_TIMED:
        q, k, v = attention_inputs(torch, gen, B, Hq, Hkv, S, S, D,
                                   torch.bfloat16)
        big = S > 2048
        want = fa.flash_attention_plain(q, k, v, window=window)
        abs_e, rel_e = attention_err(
            torch, ops.flash_attention(q, k, v, window=window), want,
            "bfloat16", name)
        del want
        ms = time_cuda(torch, lambda: fa.flash_attention_cuda(
            q, k, v, window=window), warmup=1 if big else 2,
            iters=3 if big else 10)
        plain_ms = time_cuda(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=window), warmup=1 if big else 2,
            iters=1 if big else 5)
        library_ms = time_cuda(torch, sdpa(torch, q, k, v, window),
                               iters=3 if big else 10)
        flops, nbytes, b_ms, b_by = attention_bound(B, Hq, Hkv, S, S, D,
                                                    window)
        timed[name] = dict(shape=[B, Hq, Hkv, S, D], window=window,
                           impl=fa.design(q, k, v), ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=b_ms, bound_by=b_by, flops=flops,
                           bytes=nbytes, tflops=flops / ms / 1e9,
                           flops_share=flops / ms * 1e3 / BF16_FLOPS_PER_S,
                           vs_sdpa=ms / library_ms,
                           max_abs_err=abs_e, max_rel_err=rel_e)
        if name == "serve_prefill":
            timed[name]["host_us"] = attention_host_us(torch, q, k, v)
        del q, k, v
        torch.cuda.empty_cache()
    for name, B, Hq, Hkv, S, D, window in ATTN_F32_TIMED:
        timed.setdefault(name, {})["f32"] = attention_f32_row(
            torch, gen, name, B, Hq, Hkv, S, D, window)
    emit("flash_attention", tol=ATTN_TOL, cases=cases, **timed)
    row = timed["serve_prefill"]
    return dict(route="cuda", source="src/repro_torch/kernels/csrc/"
                "flash_attention_tc.cu", replaces="src/repro/kernels/"
                "flash_attention.py:72",
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "shape")})


def attention_f32_row(torch, gen, name, B, Hq, Hkv, S, D, window) -> dict:
    """The SIMT kernel in f32 at one timed shape: held to its plain
    version, two calls bitwise equal; its ms beside the plain version's,
    SDPA's in f32 and the bound at the f32 rate, with the share of that
    bound it reaches and its ratio to SDPA."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = attention_inputs(torch, gen, B, Hq, Hkv, S, S, D,
                               torch.float32)
    big = S > 2048
    got = fa.flash_attention_cuda(q, k, v, window=window)
    abs_e, rel_e = attention_err(
        torch, got, fa.flash_attention_plain(q, k, v, window=window),
        "float32", f"{name} f32")
    check(torch.equal(got, fa.flash_attention_cuda(q, k, v, window=window)),
          f"flash_attention {name} f32: two calls differ")
    del got
    ms = time_cuda(torch, lambda: fa.flash_attention_cuda(
        q, k, v, window=window), warmup=1, iters=3 if big else 10)
    plain_ms = time_cuda(torch, lambda: fa.flash_attention_plain(
        q, k, v, window=window), warmup=1, iters=1 if big else 5)
    library_ms = time_cuda(torch, sdpa(torch, q, k, v, window), warmup=1,
                           iters=3 if big else 10)
    flops, nbytes, b_ms, b_by = attention_bound(B, Hq, Hkv, S, S, D, window,
                                                f32=True)
    del q, k, v
    torch.cuda.empty_cache()
    return dict(shape=[B, Hq, Hkv, S, D], window=window, impl="simt", ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, flops=flops, bytes=nbytes,
                tflops=flops / ms / 1e9, bound_share=b_ms / ms,
                vs_sdpa=ms / library_ms, max_abs_err=abs_e,
                max_rel_err=rel_e, bitwise_twice=True)


def attention_host_us(torch, q, k, v, calls: int = 2000):
    """Microseconds of host time a call: the tensor-core kernel's three
    TMA maps encoded alone (its C entry point that encodes and launches
    nothing), and the whole wrapper call (checks, maps, launch) enqueued
    on a busy stream."""
    from repro_torch.kernels import _common as C
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    encode = C.bind(build.library("flash_attention_tc"),
                    "repro_flash_attention_tc_encode",
                    (C.VOIDP,) * 3 + (C.I32,) * 6)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Hq, Hkv, S, S, D)
    check(encode(*args) == 0, "flash_attention_tc: the TMA maps")
    t0 = time.perf_counter()
    for _ in range(calls):
        encode(*args)
    encode_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls // 10):
        fa.flash_attention_cuda(q, k, v)
    call_us = (time.perf_counter() - t0) / (calls // 10) * 1e6
    torch.cuda.synchronize()
    return dict(encode_maps=encode_us, wrapper_call=call_us)


#: fm_interaction's timed shapes: the FM arch's serve_p99, train_batch and
#: serve_bulk batches at full width (39 fields x K 10)
FM_TIMED = (("serve_p99", 512), ("train_batch", 65_536),
            ("serve_bulk", 262_144))
FM_F, FM_K = 39, 10


def fm_input(torch, gen, B, F, K, dtype):
    """A ``(B, F, K)`` batch at the model's init scale (normal * 0.01)."""
    return (torch.randn((B, F, K), generator=gen, device="cuda") * 0.01
            ).to(dtype)


def fm_same_bits(torch, got, want, tag: str) -> None:
    """Equal bits where ``want`` is a number, NaN where it is NaN."""
    got, want = got.cpu(), want.cpu()
    check(got.dtype == want.dtype == torch.float32
          and got.shape == want.shape, f"{tag}: shape/dtype")
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"{tag}: NaN rows differ")
    bad = int((got.view(torch.int32) != want.view(torch.int32))[~nan].sum())
    check(bad == 0, f"{tag}: {bad} rows differ from the plain version")


def fm_rows(torch, gen) -> dict:
    """fm_interaction against its plain version, bitwise: B 1 and 1,025,
    F/K (6, 4), (16, 8) and (39, 10), and the three timed batches, each in
    f32 and bf16; the kernel's times at the timed batches (eager calls,
    and ``graph_ms``, the device time from a CUDA graph: an eager call at
    serve_p99 times the host's launch), the plain version's, with the
    byte bound (no single PyTorch call computes this function, so no
    library time)."""
    from repro_torch.kernels import fm_interaction as fmk
    from repro_torch.kernels import ops

    timed = {}
    cases = [(1, FM_F, FM_K), (1025, FM_F, FM_K), (1025, 6, 4), (1, 6, 4),
             (1025, 16, 8), (77, 16, 8)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, F, K in cases:
            v = fm_input(torch, gen, B, F, K, dtype)
            fm_same_bits(torch, ops.fm_interaction(v),
                         fmk.fm_interaction_plain(v),
                         f"fm_interaction {B}x{F}x{K} {name}")
        for shape_name, B in FM_TIMED:
            v = fm_input(torch, gen, B, FM_F, FM_K, dtype)
            fm_same_bits(torch, ops.fm_interaction(v),
                         fmk.fm_interaction_plain(v),
                         f"fm_interaction {shape_name} {name}")
            ms = time_cuda(torch, lambda: fmk.fm_interaction_cuda(v))
            graph_ms = time_graph(torch, lambda: fmk.fm_interaction_cuda(v))
            plain_ms = time_cuda(torch, lambda: fmk.fm_interaction_plain(v),
                                 warmup=1, iters=3)
            # v read once, the output written once; an add, a multiply
            # and an add an element, four operations a (row, k)
            nbytes = v.numel() * v.element_size() + 4 * B
            b_ms, b_by = bound(nbytes, 3 * v.numel() + 4 * B * FM_K)
            timed[f"{shape_name}_{name}"] = dict(
                shape=[B, FM_F, FM_K], dtype=name, ms=ms, graph_ms=graph_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, gbytes_per_s=nbytes / ms / 1e6,
                bound_share=b_ms / graph_ms)
            del v
    torch.cuda.empty_cache()
    emit("fm_interaction", cases=[list(c) for c in cases], **timed)
    row = timed["serve_bulk_float32"]
    return dict(route="cuda", source="src/repro_torch/kernels/csrc/"
                "fm_interaction.cu", replaces="src/repro/kernels/"
                "fm_interaction.py:28", max_abs_err=0, library_ms=None,
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "shape")})


def fm_table(torch, gen, rows: int, K: int, dtype):
    """``v ~ N(0, 0.01)``, ``w ~ N(0, 0.01)``, ``b ~ N(0, 0.1)`` on the
    card, rounded to ``dtype``: `fm_params`'s draws."""
    return {"v": (torch.randn((rows, K), generator=gen, device="cuda")
                  * 0.01).to(dtype),
            "w": (torch.randn(rows, generator=gen, device="cuda")
                  * 0.01).to(dtype),
            "b": (torch.randn((), generator=gen, device="cuda")
                  * 0.1).to(dtype)}


def fm_row_ids(torch, idx, V: int):
    """``(B, F)`` int64 table rows of per-field ids ``idx``."""
    return idx.to(torch.int64) + torch.arange(
        0, idx.shape[1] * V, V, dtype=torch.int64, device=idx.device)[None]


def fm_unfused_chain(torch, t, V: int, idx):
    """A serving call without the fused kernel (the training route's
    forward, and the serving call before it): int64 row ids, the gathers
    with their repair, a float32 copy, the unfused kernel (through its
    autograd Function) and PyTorch's sums."""
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import fm

    B, F = idx.shape
    v, w = fm._gather(t, fm_row_ids(torch, idx, V).reshape(-1))
    pair = ops.fm_interaction(v.view(B, F, -1).to(torch.float32))
    return t["b"] + w.view(B, F).sum(dim=-1) + pair


def fm_gather_bound(torch, t, V: int, idx) -> dict:
    """The fused call's bound: the ids, each (request, field)'s v and w
    rows and b read once, a float each request written (bytes); and the
    32-byte sectors this run's rows touch (a v row's span, a w entry's
    sector), with the ids and the output: the gathers' floor."""
    B, F = idx.shape
    K, isz = t["v"].shape[1], t["v"].element_size()
    nbytes = B * F * (idx.element_size() + K * isz + isz) + isz + 4 * B
    start = fm_row_ids(torch, idx, V) * (K * isz)
    v_sectors = int(((start + K * isz - 1) // 32 - start // 32 + 1).sum())
    sector_bytes = (32 * (v_sectors + B * F) + B * F * idx.element_size()
                    + 4 * B)
    b_ms, b_by = bound(nbytes)
    return dict(bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                sector_bytes=sector_bytes,
                sector_floor_ms=bound(sector_bytes)[0])


#: fm_gather_interaction's edge cases: (B, F, K, vocab, dtype, ids),
#: with a wrapped negative id and an id past the table where B > 3
FM_GATHER_CASES = (
    (1, FM_F, FM_K, 1000, "float32", "int32"),
    (1025, FM_F, FM_K, 1000, "bfloat16", "int64"),
    (1025, 6, 4, 500, "float32", "int64"), (1025, 16, 8, 300, "bfloat16",
                                             "int32"),
    (1025, 16, 8, 300, "float32", "int32"), (777, 7, 5, 101, "bfloat16",
                                             "int64"),
    (1, 6, 4, 500, "bfloat16", "int32"), (300, FM_F, FM_K, 50, "float32",
                                          "int64"))


def fm_gather_rows(torch, gen) -> dict:
    """fm_gather_interaction against its plain version, bitwise with the
    NaN rows in the same places: the edge cases, the retrieval constant
    (B 1 x F 4) and the serve_p99 and serve_bulk batches at full width
    (a 39,000,000-row table, f32 and bf16, int32 and int64 ids).  The
    timed rows give ms a call (eager) and ``graph_ms`` (a CUDA graph of
    20), the bound and the sector floor, the plain version's time, the
    unfused chain (`fm_unfused_chain`) timed in turns with the kernel
    (kernel, chain, kernel, chain), two bare ``index_select``s of the
    rows, and the kernel on all-zero ids (``hot_graph_ms``: its rows in
    cache); no single PyTorch call computes this function, so no library
    time."""
    from repro_torch.kernels import fm_interaction as fmk
    from repro_torch.kernels import ops

    for B, F, K, V, dt, it in FM_GATHER_CASES:
        t = fm_table(torch, gen, F * V, K, getattr(torch, dt))
        idx = torch.randint(0, V, (B, F), generator=gen, device="cuda",
                            dtype=getattr(torch, it))
        if B > 3:
            idx[1, 0] = -1
            idx[2, F - 1] = V
        got = ops.fm_gather_interaction(idx, V, t["v"], t["w"], t["b"])
        want = fmk.fm_gather_interaction_plain(idx, V, t["v"], t["w"],
                                               t["b"])
        tag = f"fm_gather_interaction {B}x{F}x{K} {dt} {it}"
        fm_same_bits(torch, got, want, tag)
        check(torch.isnan(got).nonzero().flatten().tolist()
              == ([2] if B > 3 else []), f"{tag}: NaN rows")
    timed = {}
    for dt in ("float32", "bfloat16"):
        t = fm_table(torch, gen, FM_F * 1_000_000, FM_K, getattr(torch, dt))
        user = torch.randint(0, 1_000_000, (1, 4), generator=gen,
                             device="cuda", dtype=torch.int32)
        fm_same_bits(torch, ops.fm_gather_interaction(
            user, 1_000_000, t["v"], t["w"], t["b"]),
            fmk.fm_gather_interaction_plain(user, 1_000_000, t["v"], t["w"],
                                            t["b"]),
            f"fm_gather_interaction retrieval constant {dt}")
        for shape_name, B in (("serve_p99", 512), ("serve_bulk", 262_144)):
            for it in ("int32", "int64"):
                idx = torch.randint(0, 1_000_000, (B, FM_F), generator=gen,
                                    device="cuda", dtype=getattr(torch, it))
                args = (idx, 1_000_000, t["v"], t["w"], t["b"])
                got = ops.fm_gather_interaction(*args)
                fm_same_bits(torch, got,
                             fmk.fm_gather_interaction_plain(*args),
                             f"fm_gather_interaction {shape_name} {dt} {it}")
                # the yardstick computes the same function: within
                # FM_REL of the terms' magnitudes; in bf16 also a bf16
                # step of them (it rounds PyTorch's sum of w, not ours)
                chain = fm_unfused_chain(torch, t, 1_000_000, idx)
                rows = fm_row_ids(torch, idx, 1_000_000)
                vs = t["v"][rows].float()
                s = vs.sum(1)
                lin = (t["w"][rows].float().abs().sum(-1)
                       + t["b"].float().abs())
                tol = FM_REL * (0.5 * (s * s + (vs * vs).sum(1)).sum(-1)
                                + lin)
                if dt == "bfloat16":
                    tol = tol + 2.0 ** -6 * lin
                check(bool(((chain - got).abs() <= tol).all()),
                      f"fm_gather_interaction {shape_name} {dt} {it}: the "
                      f"unfused chain differs")
                del vs, s, lin, tol
                # the gathers alone, as PyTorch does them: v's and w's
                # rows by two index_selects (a part of the function, so
                # a yardstick of the card's random-row rate, not a
                # library time)
                flat = rows.reshape(-1)
                select_ms = time_cuda(torch, lambda: (
                    t["v"].index_select(0, flat),
                    t["w"].index_select(0, flat)))
                del rows, flat
                turns = {"kernel": [], "chain": []}
                graph = {"kernel": [], "chain": []}
                for name in ("kernel", "chain", "kernel", "chain"):
                    fn = ((lambda: fmk.fm_gather_interaction_cuda(*args))
                          if name == "kernel" else
                          (lambda: fm_unfused_chain(torch, t, 1_000_000,
                                                   idx)))
                    turns[name].append(time_cuda(torch, fn))
                    graph[name].append(time_graph(torch, fn))
                plain_ms = time_cuda(
                    torch, lambda: fmk.fm_gather_interaction_plain(*args),
                    warmup=1, iters=3)
                # the same call with every id 0: each field reads one row,
                # from cache, so what is left is the kernel's own work
                hot = torch.zeros_like(idx)
                hot_ms = time_graph(
                    torch, lambda: fmk.fm_gather_interaction_cuda(
                        hot, 1_000_000, t["v"], t["w"], t["b"]))
                del hot
                timed[f"{shape_name}_{dt}_{it}"] = dict(
                    shape=[B, FM_F, FM_K], dtype=dt, ids=it,
                    ms=min(turns["kernel"]), graph_ms=min(graph["kernel"]),
                    unfused_ms=min(turns["chain"]),
                    unfused_graph_ms=min(graph["chain"]),
                    index_select_ms=select_ms, hot_graph_ms=hot_ms,
                    turns=turns,
                    graph_turns=graph, plain_ms=plain_ms,
                    **fm_gather_bound(torch, t, 1_000_000, idx))
                del idx, got, chain
        del t
        torch.cuda.empty_cache()
    for row in timed.values():
        row["bound_share"] = row["bound_ms"] / row["graph_ms"]
        row["sector_share"] = row["sector_floor_ms"] / row["graph_ms"]
    emit("fm_gather_interaction",
         cases=[list(c) for c in FM_GATHER_CASES], **timed)
    row = timed["serve_bulk_float32_int32"]
    return dict(route="cuda", source="src/repro_torch/kernels/csrc/"
                "fm_interaction.cu", replaces="src/repro/kernels/"
                "fm_interaction.py:28", max_abs_err=0, library_ms=None,
                **{k: row[k] for k in ("ms", "graph_ms", "plain_ms",
                                       "unfused_ms", "unfused_graph_ms",
                                       "index_select_ms", "hot_graph_ms",
                                       "bound_ms",
                                       "bound_by", "sector_floor_ms",
                                       "shape")})


def kernel_phase(torch, graph, lj_logq):
    from repro_torch import prng
    from repro_torch.kernels import coins, ops
    from repro_torch.kernels import coverage_matvec as cov
    from repro_torch.kernels import fused_select as fsel

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, m, B, theta = graph.n, graph.m, BATCH, THETA
    ld = ops.padded_width(n)
    rows_out = {}

    # ---- arena_commit, both kinds: one batch into rows [B, 2B)
    rows_out.update(commit_rows(torch, gen, B, n))

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
    # a theta shard's block of a mesh batch: its rows of the whole draw
    for lo, hi in ((B // 2, B), (3, 7), (B - 1, B)):
        check(torch.equal(ops.ic_sparse_hits(key, prob, B, rows=(lo, hi)),
                          hits[lo:hi]), f"ic_sparse_hits rows {lo}:{hi}")
    for Bc, mc in ((5, 1001), (1, 3)):
        p = torch.rand(mc, generator=gen, device="cuda")
        check(torch.equal(ops.ic_sparse_hits(key, p, Bc),
                          coins.ic_sparse_hits_plain(key, p, Bc)),
              f"ic_sparse_hits {Bc}x{mc}")
    ms = time_cuda(torch, lambda: coins.ic_sparse_hits_cuda(key, prob, B))
    plain_ms = time_cuda(torch, lambda: coins.ic_sparse_hits_plain(
        key, prob, B), warmup=1, iters=2)
    rows_out["ic_sparse_hits"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/coins.cu",
        replaces="src/repro/core/sampler.py:470", max_abs_err=0,
        ms=ms, plain_ms=plain_ms, library_ms=None, shape=[B, m],
        **coin_bound(torch, "ic_sparse_hits_kernel", B * m, B * m + 4 * m))
    del hits
    torch.cuda.empty_cache()
    rows_out["ic_frontier_step"] = frontier_row(torch, gen, lj_logq)
    rows_out["flash_attention"] = attention_rows(torch, gen)
    rows_out["fm_interaction"] = fm_rows(torch, gen)
    rows_out["fm_gather_interaction"] = fm_gather_rows(torch, gen)

    # ---- uniform_draw: the dense backends' (B, n) coin draw
    for shape in ((1, 1), (3, 7), (70, 4099), (B, lj_logq.shape[0])):
        got = ops.uniform(key, shape, device="cuda")
        check(torch.equal(got, prng.uniform(key, shape, device="cuda")),
              f"uniform_draw {shape}")
        # a row block at an offset, as a theta shard draws it
        lo = shape[0] // 2 * shape[1]
        check(torch.equal(ops.uniform(key, shape, device="cuda", start=lo,
                                      count=got.numel() - lo).reshape(-1),
                          got.reshape(-1)[lo:]),
              f"uniform_draw {shape} from {lo}")
    shape = (B, lj_logq.shape[0])
    out = torch.empty(shape, device="cuda")
    ms = time_cuda(torch, lambda: coins.uniform_cuda(key, out))
    plain_ms = time_cuda(torch, lambda: prng.uniform(key, shape,
                                                     device="cuda"))
    count = shape[0] * shape[1]
    rows_out["uniform_draw"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/coins.cu",
        replaces="src/repro/core/sampler.py:401", max_abs_err=0,
        ms=ms, plain_ms=plain_ms, library_ms=None, shape=list(shape),
        **coin_bound(torch, "uniform_kernel", count, 4 * count))
    emit("kernels", **{k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms",
                                                "library_ms", "shape")}
                       for k, v in rows_out.items()})
    return rows_out


# -------------------------------------------------------------- parity ----

def parity_phase(torch, lj):
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
    dense = dense_parity(torch, g)
    lt = lt_parity(torch, g)
    tier = tier_parity(torch)
    mesh = mesh_parity(torch, g)
    lj_mesh = lj_mesh_parity(torch, lj)
    emit("parity", n=g.n, m=g.m, theta=rh.theta, rounds=rh.rounds,
         dense=dense, lt=lt, tier=tier, mesh=mesh, lj_mesh=lj_mesh,
         seeds=[int(s) for s in rh.seeds], covered_frac=rh.covered_frac,
         cuda_s=c["s"], cpu_s=h["s"], launches=c["launches"],
         packed_s=out[DEV, "packed"]["s"],
         compressed_s=out[DEV, "compressed"]["s"],
         packed_launches=out[DEV, "packed"]["launches"],
         compressed_launches=out[DEV, "compressed"]["launches"])


def lt_parity(torch, g) -> dict:
    """imm() under LT on ``g`` with the positional and the stable walk,
    on the card and on the host: seeds, theta, coverage, counter and
    arena identical."""
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.kernels import ops

    out = {}
    for name in ("LT/walk", "LT/walk+stable"):
        got = {}
        for dev in (DEV, "cpu"):
            cfg = IMMConfig(k=10, model="LT", sampler=name, max_theta=4096,
                            seed=0)
            ops.reset_launches()
            eng = InfluenceEngine(g, cfg, device=dev)
            res = eng.run()
            got[dev] = (res, eng.store.R[:res.theta].cpu(),
                        ops.launch_counts())
        (rc, Rc, lc), (rh, Rh, _) = got[DEV], got["cpu"]
        check(list(rc.seeds) == list(rh.seeds) and rc.theta == rh.theta
              and rc.covered_frac == rh.covered_frac
              and (rc.counter == rh.counter).all() and torch.equal(Rc, Rh),
              f"parity {name}: card and host differ")
        check(lc.get("uniform_draw", 0) > 0 if name == "LT/walk"
              else lc.get("uniform_draw", 0) == 0,
              f"parity {name}: uniform_draw launches {lc}")
        out[name] = dict(seeds=[int(s) for s in rc.seeds], theta=rc.theta,
                         covered_frac=rc.covered_frac,
                         uniform_draw=lc.get("uniform_draw", 0))
    return out


def batch_keys(seed: int, count: int):
    """The engine's first ``count`` batch keys for ``seed``."""
    from repro_torch import prng

    key, keys = prng.PRNGKey(seed), []
    for _ in range(count):
        key, sub = prng.split(key)
        keys.append(sub)
    return keys


def differing_rows(eng_a, eng_b):
    """Indices (on the host) of the arena rows, up to the shorter store's
    count, on which two engines' bitmap stores differ."""
    count = min(eng_a.store.count, eng_b.store.count)
    a, b = eng_a.store.R[:count], eng_b.store.R[:count]
    return (a != b.to(a.device)).any(dim=1).nonzero().squeeze(1).cpu()


def classify_arenas(torch, eng_a, eng_b):
    """Trace every arena row on which two positional dense-family solves
    of one graph, model and seed on the card differ (say the ``dense``
    and the ``pallas`` backend) to its first differing BFS step and
    classify it; checks that each batch re-samples to its arena rows and
    that every difference is a near-tie.  Returns ``(rows that differ,
    cells, near-ties, batches classified)``."""
    from repro_torch.core import sampler, ties

    B, n = eng_a.cfg.batch, eng_a.graph.n
    diff = differing_rows(eng_a, eng_b)
    batches = sorted({int(r) // B for r in diff.tolist()})
    keys = batch_keys(eng_a.cfg.seed, max(batches, default=-1) + 1)
    logq = sampler.logq_from_probs(eng_a.graph, sampler._edge_probs(
        sampler.get_model(eng_a.cfg.model), eng_a.graph))
    kernels = [e.sampler_name.split("/")[1].startswith("pallas")
               for e in (eng_a, eng_b)]
    cells = tie_count = 0
    for j in batches:
        def run(kernel, key=keys[j]):
            return lambda t: sampler._dense_loop(
                key, logq, batch=B, max_steps=t,
                kernel=kernel)[0].cpu().numpy()

        _, _, roots = sampler._dense_loop(keys[j], logq, batch=B,
                                          max_steps=1)
        for eng, kernel in zip((eng_a, eng_b), kernels):
            rerun = torch.from_numpy(run(kernel)(n))
            check(torch.equal(rerun, eng.store.R[j * B:(j + 1) * B].cpu()),
                  f"batch {j} of {eng.sampler_name} does not re-sample")
        rep = ties.classify_runs(
            run(kernels[0]), run(kernels[1]),
            lambda t, key=keys[j]: sampler.dense_coins(
                key, t, batch=B, n_nodes=n, device=logq.device),
            logq, roots.cpu().numpy(), max_steps=n)
        check(rep["faults"] == [], f"not near-ties: {rep['faults'][:3]}")
        cells += rep["cells"]
        tie_count += rep["ties"]
    return int(diff.numel()), cells, tie_count, len(batches)


#: the dense-path parity cells: (model, backend, stable)
DENSE_CELLS = (("IC", None, False), ("IC", "pallas", False),
               ("WC", "pallas", False), ("GT", "pallas", False),
               ("IC", "pallas", True))
#: the dense cells' theta cap, and the mesh cells' (4,096 and 2,048 until
#: the launchers' cells phase: the host's runs of these cells were 100 s
#: of the smoke, and WC and GT reach the cap)
DENSE_PARITY_THETA, MESH_PARITY_THETA = 2048, 1024


def dense_parity(torch, g) -> dict:
    """The dense-path cells of the parity graph (its default sampler is
    IC/dense) on cuda and on cpu: pallas cuda == cpu bitwise, dense cuda
    vs pallas cuda equal up to classified near-ties, ic_frontier_step
    launched on cuda only, and a positions resample of the stable cell."""
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.kernels import ops

    out, summary = {}, {}
    for model, backend, stable in DENSE_CELLS:
        for dev in (DEV, "cpu"):
            cfg = IMMConfig(k=10, model=model, backend=backend,
                            stable=stable, max_theta=DENSE_PARITY_THETA,
                            seed=0,
                            store="bitmap")
            ops.reset_launches()
            t0 = time.perf_counter()
            eng = InfluenceEngine(g, cfg, device=dev)
            res = eng.run()
            if dev == DEV:
                torch.cuda.synchronize()
            out[eng.sampler_name, dev] = dict(
                eng=eng, res=res, s=time.perf_counter() - t0,
                launches=ops.launch_counts())
    for (name, dev), o in out.items():
        for kname, wanted in (
                ("ic_frontier_step", name.split("/")[1].startswith("pallas")),
                ("uniform_draw", not name.endswith("+stable"))):
            got = o["launches"].get(kname, 0)
            check(got > 0 if (wanted and dev == DEV) else got == 0,
                  f"parity {name} on {dev}: {kname} launched {got}")
        kernel = name.split("/")[1].startswith("pallas")
        if not kernel or dev != DEV:
            continue
        c, h = o, out[name, "cpu"]
        rc, rh = c["res"], h["res"]
        check(list(rc.seeds) == list(rh.seeds), f"parity {name} seeds")
        check((rc.theta, rc.rounds) == (rh.theta, rh.rounds),
              f"parity {name} theta")
        check(rc.covered_frac == rh.covered_frac, f"parity {name} coverage")
        check((rc.counter == rh.counter).all(), f"parity {name} counter")
        check(torch.equal(c["eng"].store.R.cpu(), h["eng"].store.R),
              f"parity {name} arena")
        summary[name] = dict(seeds=[int(x) for x in rc.seeds],
                             theta=rc.theta, covered_frac=rc.covered_frac,
                             cuda_s=c["s"], cpu_s=h["s"],
                             launches=c["launches"])
    rows, cells, n_ties, _ = classify_arenas(
        torch, out["IC/dense", DEV]["eng"], out["IC/pallas", DEV]["eng"])
    d = out["IC/dense", DEV]["res"]
    summary["IC/dense"] = dict(
        seeds=[int(x) for x in d.seeds], theta=d.theta,
        covered_frac=d.covered_frac, cuda_s=out["IC/dense", DEV]["s"],
        cpu_s=out["IC/dense", "cpu"]["s"],
        rows_differing_from_pallas=rows, cells=cells, near_ties=n_ties,
        rows_differing_cuda_cpu=int(differing_rows(
            out["IC/dense", DEV]["eng"], out["IC/dense", "cpu"]["eng"])
            .numel()))
    # a positions resample of the stable cell regenerates its arena rows
    eng = out["IC/pallas+stable", DEV]["eng"]
    key = batch_keys(0, 3)[2]
    pos = [255, 0, 17, 128]
    part, _ = eng.resample(key, positions=pos)
    check(torch.equal(part, eng.store.R[2 * BATCH:3 * BATCH][pos]),
          "parity resample(positions)")
    return summary


# --------------------------------------------------------- full solves ----

#: the kernels each store's solve must launch, and those it must not
PATH_KERNELS = {
    "bitmap": ("arena_commit", "coverage_matvec", "fused_select"),
    "packed": ("arena_commit_packed", "packed_count"),
    "compressed": ("token_count",),
}
PHASE = {"bitmap": "imm_full", "packed": "packed_full",
         "compressed": "compressed_full"}
#: the full run whose launches the kernel table reports for each kernel
KERNEL_PATH = {
    **{name: PHASE[kind] for kind, names in PATH_KERNELS.items()
       for name in names},
    "ic_sparse_hits": "imm_full",
    "ic_frontier_step": "pallas_full", "uniform_draw": "pallas_full",
    "flash_attention": "lm_full", "flash_attention_bwd": "lm_train",
    "fm_interaction": "fm_full",
    "fm_gather_interaction": "fm_full",
}


def influence_sets(torch, graph, seeds):
    """The four influence queries of a full solve: its seeds, its first
    10, the 50 highest out-degree vertices, 50 evenly spaced ones."""
    deg = torch.bincount(graph.edge_src.long(), minlength=graph.n)
    return [list(seeds), list(seeds[:10]),
            torch.topk(deg, 50).indices.tolist(),
            list(range(0, graph.n, graph.n // 50))[:50]]


def full_phase(torch, graph, max_theta: int, store: str = "bitmap",
               ref: dict = None, keep: dict = None):
    """imm() on the full-size replica with ``store``, then the fused
    selections and four influence queries; checks the arena against the
    counter and sizes and, given the bitmap run's ``ref``, every result
    against it.  Given ``keep``, fills it with the solve's counter,
    gains and snapshot tree (mesh_full's reference).  Returns (launches,
    summary)."""
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
    sets = influence_sets(torch, graph, res.seeds)
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
    if keep is not None:
        keep.update(counter=res.counter, gains=engine.select(50).gains,
                    tree=engine.snapshot_tree())
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
         store_write_s=spans["store.write"],
         select_s=spans["select"], fused_selects_s=fused_s,
         influences_s=influences_s, influence=res.influence,
         covered_frac=res.covered_frac,
         seeds=[int(s) for s in res.seeds[:10]],
         influences=[float(x) for x in infl],
         arena_bytes=st.arena_bytes, at_rest_row_bytes=st._row_bytes(),
         max_memory_allocated=peak, launches=launches, **extra)
    return launches, summary


# --------------------------------------------------------------- meshes ----

#: the parity phase's mesh cells: (theta x vertex shape, partition)
MESH_PARITY_LAYOUTS = (((2, 2), "equal"), ((1, 2), "balanced"))
#: their samplers and the coin/step kernels each must launch on the card
MESH_PARITY_SAMPLERS = (("IC/sparse", ("ic_sparse_hits",)),
                        ("IC/pallas", ("ic_frontier_step", "uniform_draw")),
                        ("LT/walk", ("uniform_draw",)))
#: mesh_full's layouts: (name, theta x vertex shape, store, partition)
MESH_LAYOUTS = (("2x2_bitmap", (2, 2), "auto", "equal"),
                ("1x4_packed_balanced", (1, 4), "packed", "balanced"),
                ("4x1_compressed", (4, 1), "compressed", "equal"))
#: the kernels mesh_full's solves must launch on the tiles
MESH_KERNELS = ("arena_commit", "arena_commit_packed", "coverage_matvec",
                "packed_count", "token_count", "ic_sparse_hits")


def grid(dev, shape):
    """A theta x vertex `Mesh` of ``shape`` tiles, every one on ``dev``."""
    from repro_torch.mesh import Mesh
    return Mesh([[dev] * shape[1] for _ in range(shape[0])],
                ("data", "vertex"))


def mesh_parity(torch, g) -> dict:
    """imm() on ``g`` on meshes of the card and of the host (2x2 equal,
    1x2 balanced) under IC/sparse, IC/pallas and LT/walk, beside the
    single-device run on the host: seeds, theta, rounds, coverage and
    counter identical.  The card's runs sample each theta shard's rows
    at a row offset (ic_sparse_hits, uniform_draw) and step the pallas
    BFS with ic_frontier_step under the placement."""
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.kernels import ops

    out = {}
    for sampler, kernels in MESH_PARITY_SAMPLERS:
        cfg = IMMConfig(k=10, sampler=sampler, max_theta=MESH_PARITY_THETA,
                        seed=0)
        ref = InfluenceEngine(g, cfg, device="cpu").run()
        for shape, part in MESH_PARITY_LAYOUTS:
            mcfg = dataclasses.replace(cfg, partition=part)
            cell = f"{sampler} {shape[0]}x{shape[1]} {part}"
            for dev in (DEV, "cpu"):
                ops.reset_launches()
                t0 = time.perf_counter()
                res = InfluenceEngine(g, mcfg, mesh=grid(dev, shape),
                                      vertex_axis="vertex").run()
                s = time.perf_counter() - t0
                launches = ops.launch_counts()
                check(list(res.seeds) == list(ref.seeds),
                      f"parity mesh {cell} on {dev}: seeds")
                check((res.theta, res.rounds) == (ref.theta, ref.rounds),
                      f"parity mesh {cell} on {dev}: theta")
                check(res.covered_frac == ref.covered_frac,
                      f"parity mesh {cell} on {dev}: coverage")
                check((res.counter == ref.counter).all(),
                      f"parity mesh {cell} on {dev}: counter")
                for name in kernels:
                    got = launches.get(name, 0)
                    check(got > 0 if dev == DEV else got == 0,
                          f"parity mesh {cell} on {dev}: {name} {got}")
                out[f"{cell} {dev}"] = dict(s=s, theta=res.theta,
                                            launches=launches)
    return out


def shard_rows(torch, rows, D: int, batch: int):
    """A single-device store's rows ``(theta, n)`` (whole batches in
    order) as a ``D``-shard store holds them: shard ``t`` keeps rows
    ``[t b, (t + 1) b)`` of every batch, ``b = ceil(batch / D)``, in
    batch order; the shards' rows concatenated, as ``state()`` gives
    them."""
    b = -(-batch // D)
    per = rows.reshape(-1, batch, rows.shape[1])
    return torch.cat([per[:, t * b:(t + 1) * b].reshape(-1, rows.shape[1])
                      for t in range(D)])


def lj_mesh_parity(torch, lj) -> dict:
    """pallas_full's cell (the com-LJ replica, IC, k 50, eps 0.5, the
    pallas backend) on a 2x2 mesh of the card with the column-blocked
    BFS, ``overlap`` on and off: every row (in its shard), the seeds,
    theta and influence bitwise the single-device pallas run."""
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.kernels import ops

    cfg = IMMConfig(k=50, eps=0.5, model="IC", backend="pallas",
                    batch=BATCH, max_theta=LJ_THETA, seed=0)
    ref_eng = InfluenceEngine(lj, cfg, device=DEV)
    ref = ref_eng.run()
    out = {}
    for overlap in (True, False):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = InfluenceEngine(lj, dataclasses.replace(cfg, overlap=overlap),
                              mesh=grid(DEV, (2, 2)), vertex_axis="vertex")
        res = eng.run()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = ops.launch_counts()
        tag = f"com-LJ 2x2 pallas overlap={overlap}"
        check(list(res.seeds) == list(ref.seeds) and res.theta == ref.theta
              and res.influence == ref.influence
              and res.covered_frac == ref.covered_frac,
              f"parity {tag}: seeds, theta or influence")
        check((res.counter == ref.counter).all(), f"parity {tag}: counter")
        want = shard_rows(torch, ref_eng.store.R[:ref.theta].cpu(), 2, BATCH)
        got = torch.from_numpy(eng.store.state()["R"])
        check(torch.equal(got, want), f"parity {tag}: rows")
        check(launches.get("ic_frontier_step", 0) > 0,
              f"parity {tag}: no ic_frontier_step on the tiles")
        out[f"overlap={overlap}"] = dict(s=s, theta=res.theta,
                                         launches=launches)
    return out


def tile_checks(torch, store) -> dict:
    """Each tile's padding is zero — pad columns (decoded) and, on a
    bitmap or packed tile, the row stride's pad bytes — and each tile's
    counter partial equals its rows' column sums; returns the tiles'
    bytes and devices."""
    codec = store.codec
    for t in range(store.D):
        c = int(store.counts[t])
        for v in range(store.Dv):
            tile = store._tiles[t][v]
            w = store.col_width[v]
            if codec.kind != "compressed":
                check(int(tile[:, codec.width:].sum()) == 0,
                      f"mesh_full tile ({t}, {v}) pad bytes zero")
            col = torch.zeros(store.n_local, dtype=torch.int32,
                              device=tile.device)
            for lo in range(0, c, 1024):
                bits = codec.decode(tile[lo:min(lo + 1024, c),
                                         :codec.width])
                check(int(bits[:, w:].sum()) == 0,
                      f"mesh_full tile ({t}, {v}) pad columns zero")
                col += bits.sum(dim=0, dtype=torch.int32)
            check(torch.equal(col, store._counter[t][v]),
                  f"mesh_full tile ({t}, {v}) partial == column sums")
    return dict(tile_bytes=store.tile_bytes(),
                tile_devices=[str(d) for row in store.devices for d in row],
                n_local=store.n_local, cap_local=store.cap_local,
                counts=[int(c) for c in store.counts])


def mesh_solve(torch, graph, cfg, shape, part):
    """One meshed imm() and its two fused selections on the card, timed;
    the launches counted apart."""
    from repro_torch import obs
    from repro_torch.core.engine import InfluenceEngine
    from repro_torch.kernels import ops

    mcfg = dataclasses.replace(cfg, partition=part)
    obs.reset()
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng = InfluenceEngine(graph, mcfg, mesh=grid(DEV, shape),
                          vertex_axis="vertex")
    res = eng.run()
    torch.cuda.synchronize()
    imm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = [eng.select(50, method=m)
             for m in ("fused-rebuild", "fused-decrement")]
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    tracer = obs.get_tracer()
    spans = {name: sum(tracer.durations_s(name))
             for name in ("sample", "store.write", "select")}
    obs.reset()
    return eng, res, fused, dict(
        imm_s=imm_s, sample_s=spans["sample"] + spans["store.write"],
        store_write_s=spans["store.write"], select_s=spans["select"],
        fused_selects_s=fused_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches)


def mesh_full(torch, graph, max_theta: int, ref: dict = None) -> dict:
    """imm_full's cell (com-Amazon at full size, IC, k 50, eps 0.5) on
    meshes of the one card: 2x2 bitmap tiles (equal blocks), 1x4 packed
    tiles (balanced blocks), 4x1 token tiles.  Each gives imm_full's
    seeds, influence and theta (``ref``: imm_full's summary, counter,
    gains and snapshot tree; computed here when imm_full did not run);
    on the 2x2 store the fused selections, the sharded-sparse strategy
    over its index view, the tiles' padding and partial counters; a
    snapshot of it restored on a 1x1 mesh and into a BitmapStore,
    imm_full's snapshot restored on the 2x2 mesh, and a replica.
    Returns the phase's launches (the three solves and their fused
    selections, the checks' counted apart)."""
    from repro_torch.core.adaptive import l_pad_for
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.core.selection import get_selection
    from repro_torch.kernels import ops

    cfg = IMMConfig(k=50, eps=0.5, model="IC", max_theta=max_theta,
                    selection_method="rebuild", seed=0)
    t_phase = time.perf_counter()
    if ref is None:
        eng = InfluenceEngine(graph, dataclasses.replace(cfg, store="bitmap"),
                              device=DEV)
        res = eng.run()
        ref = dict(seeds=[int(x) for x in res.seeds], theta=res.theta,
                   influence=res.influence, covered_frac=res.covered_frac,
                   counter=res.counter, gains=eng.select(50).gains,
                   tree=eng.snapshot_tree())
        del eng
        torch.cuda.empty_cache()

    def same(sel_or_res, what):
        check([int(x) for x in sel_or_res.seeds] == ref["seeds"],
              f"mesh_full {what}: seeds differ from imm_full's")

    layouts, total = {}, {}
    checks = {}
    for name, shape, store, part in MESH_LAYOUTS:
        eng, res, fused, rec = mesh_solve(
            torch, graph, dataclasses.replace(cfg, store=store), shape, part)
        same(res, name)
        check(res.theta == ref["theta"] and res.influence == ref["influence"]
              and res.covered_frac == ref["covered_frac"],
              f"mesh_full {name}: theta/influence {res.theta} "
              f"{res.influence} vs {ref['theta']} {ref['influence']}")
        check((res.counter == ref["counter"]).all(),
              f"mesh_full {name}: counter")
        check(bool((eng.select(50).gains == ref["gains"]).all()),
              f"mesh_full {name}: gains")
        for sel in fused:
            same(sel, f"{name} fused")
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
        rec.update(store=eng.store.representation,
                   partition=part, influence=res.influence,
                   theta=res.theta, rounds=res.rounds,
                   **tile_checks(torch, eng.store))
        if name == "2x2_bitmap":
            ops.reset_launches()
            st = eng.store
            l_pad = l_pad_for(st.max_local_size())
            t0 = time.perf_counter()
            view = st.index_view(l_pad)
            sp = get_selection("rebuild", "sharded-sparse")(
                view, 50, mesh=st.mesh, vertex_axis="vertex",
                partition=st.partition)
            check([int(x) for x in sp[0].cpu()] == ref["seeds"],
                  "mesh_full sharded-sparse seeds")
            checks["sharded_sparse"] = dict(
                l_pad=l_pad, max_local_size=st.max_local_size(),
                index_bytes=sum(x.numel() * 4 for row in view.R
                                for x in row),
                s=time.perf_counter() - t0)
            st._idx_cache = None
            del view, sp, st
            torch.cuda.empty_cache()
            checks["restores"] = mesh_restores(torch, graph, cfg, eng, ref,
                                               same)
            checks["launches"] = ops.launch_counts()
        layouts[name] = rec
        del eng, res, fused
        torch.cuda.empty_cache()
    for name in MESH_KERNELS:
        check(total.get(name, 0) > 0,
              f"mesh_full: {name} launched no time on the tiles")
    emit("mesh_full", graph="com-Amazon", n=graph.n, m=graph.m, k=50,
         eps=0.5, max_theta=max_theta, seeds=ref["seeds"][:10],
         influence=ref["influence"], layouts=layouts, checks=checks,
         launches=total, phase_s=time.perf_counter() - t_phase)
    return total


def mesh_restores(torch, graph, cfg, eng, ref, same) -> dict:
    """The 2x2 engine's snapshot restored on a 1x1 mesh and into a
    single-device BitmapStore; imm_full's snapshot restored on the 2x2
    mesh; a replica of the 2x2 engine.  Same seeds each, timed."""
    from repro_torch.core.engine import InfluenceEngine

    out = {}
    t0 = time.perf_counter()
    tree = eng.snapshot_tree()
    out["snapshot_s"] = time.perf_counter() - t0
    out["snapshot_rows"] = int(tree["store"]["R"].shape[0])
    cases = (("on_1x1", dict(mesh=grid(DEV, (1, 1)), vertex_axis="vertex"),
              tree),
             ("into_bitmap", dict(device=DEV), tree),
             ("imm_full_on_2x2", dict(mesh=grid(DEV, (2, 2)),
                                      vertex_axis="vertex"), ref["tree"]))
    for name, kw, src in cases:
        c = cfg if "mesh" in kw else dataclasses.replace(cfg, store="bitmap")
        t0 = time.perf_counter()
        e = InfluenceEngine(graph, c, **kw)
        e.restore_tree(src)
        sel = e.select(50)
        torch.cuda.synchronize()
        same(sel, f"restore {name}")
        out[name] = dict(s=time.perf_counter() - t0,
                         store=type(e.store).__name__)
        del e, sel
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep = eng.replicate(tree)
    same(rep.select(50), "replicate")
    out["replicate_s"] = time.perf_counter() - t0
    del rep, tree
    torch.cuda.empty_cache()
    return out


def two_card_phase(torch) -> None:
    """With two or more cards: each kernel's operands on ``cuda:1`` while
    ``cuda:0`` is current (the launch follows its operands), and a 2x1
    mesh over ``cuda:0``/``cuda:1`` equal to the single-device run.
    With one card, one line saying it was skipped."""
    if torch.cuda.device_count() < 2:
        emit("two_cards", skipped=f"{torch.cuda.device_count()} card(s): "
             "the cuda:1 kernel rows and the 2x1 cross-card mesh need two")
        return
    from repro_torch import prng
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.graphs.generators import rmat_graph
    from repro_torch.core.pack.codec import pack_bits
    from repro_torch.kernels import coins, ops
    from repro_torch.kernels import coverage_matvec as cov
    from repro_torch.mesh import Mesh

    d1 = torch.device("cuda", 1)
    gen = torch.Generator().manual_seed(5)
    R = (torch.rand((300, 1000), generator=gen) < 0.2).to(torch.uint8)
    alive = torch.rand(300, generator=gen) < 0.7
    with torch.cuda.device(0):
        Rd = torch.zeros((300, 1008), dtype=torch.uint8, device=d1)[:, :1000]
        Rd.copy_(R)
        check(torch.equal(ops.coverage_matvec(alive.to(d1), Rd).cpu(),
                          cov.coverage_matvec_plain(alive, R)),
              "two_cards: coverage_matvec on cuda:1")
        out = torch.zeros_like(Rd)
        cnt = torch.zeros(1000, dtype=torch.int32, device=d1)
        ops.arena_commit(Rd, out, cnt)
        check(torch.equal(cnt.cpu(), R.sum(dim=0, dtype=torch.int32))
              and torch.equal(out.cpu(), R),
              "two_cards: arena_commit on cuda:1")
        P = torch.zeros((300, 128), dtype=torch.uint8, device=d1)[:, :125]
        P.copy_(pack_bits(R))
        check(torch.equal(ops.packed_count(P, alive.to(d1), n=1000).cpu(),
                          (R * alive[:, None]).sum(dim=0,
                                                   dtype=torch.int32)),
              "two_cards: packed_count on cuda:1")
        prob = torch.rand(4099, generator=gen)
        key = prng.PRNGKey(3)
        check(torch.equal(ops.ic_sparse_hits(key, prob.to(d1), 9,
                                             rows=(2, 9)).cpu(),
                          coins.ic_sparse_hits_plain(key, prob, 9,
                                                     rows=(2, 9))),
              "two_cards: ic_sparse_hits on cuda:1")
        check(torch.equal(ops.uniform(key, (9, 77), device=d1, start=77,
                                      count=300).cpu(),
                          prng.uniform(key, (9, 77), start=77, count=300)),
              "two_cards: uniform_draw on cuda:1")
    g = rmat_graph(2048, 16384, seed=0)
    cfg = IMMConfig(k=10, backend="sparse", max_theta=2048, seed=0)
    ref = InfluenceEngine(g, cfg, device="cpu").run()
    res = InfluenceEngine(g, cfg, mesh=Mesh([["cuda:0"], ["cuda:1"]],
                                            ("data", "vertex")),
                          vertex_axis="vertex").run()
    check(list(res.seeds) == list(ref.seeds)
          and (res.counter == ref.counter).all(), "two_cards: 2x1 mesh")
    emit("two_cards", cards=torch.cuda.device_count(),
         seeds=[int(x) for x in res.seeds])


def pallas_full(torch, graph, max_theta: int) -> dict:
    """imm() on the com-LJ Table III replica (n 3,997, m 56,070: the
    largest and densest of the six that take the dense backend) with the
    ``pallas`` backend, then the ``dense`` one, on the card: times, BFS
    steps, frontier density, the per-step cost of the coin draw, the
    kernel and the library product, the share of the pallas sampler's
    wall in which the device is busy, and the rows on which the two
    backends differ (each classified as a near-tie)."""
    from repro_torch import obs, prng
    from repro_torch.core import sampler
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.kernels import ic_frontier as icf
    from repro_torch.kernels import ops

    n, B = graph.n, BATCH
    out, engines = {}, {}
    for backend in ("pallas", "dense"):
        cfg = IMMConfig(k=50, eps=0.5, model="IC", backend=backend,
                        batch=B, max_theta=max_theta, seed=0)
        obs.reset()
        obs.enable()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        engine = InfluenceEngine(graph, cfg, device=DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = engine.run()
        torch.cuda.synchronize()
        imm_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        snap = obs.snapshot()["counters"]
        tracer = obs.get_tracer()
        spans = {name: sum(tracer.durations_s(name))
                 for name in ("sample", "store.write", "select")}
        obs.reset()
        steps = int(snap.get("sampler.steps", 0))
        cells = int(snap.get("sampler.frontier_cells", 0))
        st = engine.store
        check(res.theta == st.count > 0, f"pallas_full {backend} theta")
        check(len(set(int(x) for x in res.seeds)) == 50,
              f"pallas_full {backend} seeds unique")
        check(0.0 < res.covered_frac <= 1.0, f"pallas_full {backend} cover")
        check(torch.equal(st.R[:st.count].sum(0, dtype=torch.int32),
                          st.counter), f"pallas_full {backend} counter")
        got = launches.get("ic_frontier_step", 0)
        check(got == steps > 0 if backend == "pallas" else got == 0,
              f"pallas_full {backend}: ic_frontier_step launched {got} "
              f"times in {steps} BFS steps")
        check(launches.get("uniform_draw", 0) == steps,
              f"pallas_full {backend}: uniform_draw launched "
              f"{launches.get('uniform_draw', 0)} times in {steps} steps")
        engines[backend] = engine
        out[backend] = dict(
            init_s=init_s, imm_s=imm_s,
            sample_s=spans["sample"] + spans["store.write"],
            select_s=spans["select"], theta=res.theta, rounds=res.rounds,
            bfs_steps=steps, frontier_density=cells / max(steps * B * n, 1),
            influence=res.influence, covered_frac=res.covered_frac,
            seeds=[int(x) for x in res.seeds],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=launches)
    rows, ncells, n_ties, nb = classify_arenas(
        torch, engines["dense"], engines["pallas"])
    # per-step costs at the solve's shape and mean frontier density
    p = out["pallas"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    L = sampler.make_logq(engines["pallas"].graph)
    # the bound sampler's column form, built once in init_s, and what
    # that build costs on its own; the form is the kernel's whole table
    # (``logq=None``: L is a rebuild, equal to the bound logq)
    cols = engines["pallas"]._sample.cols
    check(cols is not None and cols.n == n, "pallas_full: no column form")
    rebuilt, form_s = timed(torch, lambda: icf.column_form(L))
    check(all(torch.equal(a, b) for a, b in (
        (rebuilt.col_ptr, cols.col_ptr), (rebuilt.rows, cols.rows),
        (rebuilt.vals, cols.vals))), "pallas_full: the bound column form")
    p.update(column_form_s=form_s, column_form_share=form_s / p["init_s"],
             column_form_nnz=cols.nnz)
    F, V, R = frontier_inputs(torch, gen, B, n, p["frontier_density"], True)
    key = prng.PRNGKey(3)
    # loops of eager calls, which the shares below read; beside them the
    # device times alone of the coin draw and the kernel (CUDA graphs:
    # no host launch cost)
    per_step = dict(
        coin_ms=time_cuda(torch, lambda: ops.uniform(key, (B, n),
                                                     device=DEV)),
        kernel_ms=time_cuda(torch, lambda: ops.ic_frontier_step(
            F, V, None, R, cols=cols)),
        matmul_ms=time_cuda(torch, lambda: icf.activation(F.float() @ L, R,
                                                          V)),
        coin_graph_ms=time_graph(torch, lambda: ops.uniform(
            key, (B, n), device=DEV)),
        kernel_graph_ms=time_graph(torch, lambda: ops.ic_frontier_step(
            F, V, None, R, cols=cols)))
    # the bound pallas sampler alone for a few batches, plain and under
    # the profiler: how much of its wall the device is busy
    sample = engines["pallas"]._sample
    keys = prng.split(prng.PRNGKey(5), 5)
    _, plain_s = timed(torch, lambda: [sample(k) for k in keys[1:]])
    wall, busy, top, _ = trace_device(torch,
                                   [lambda k=k: sample(k) for k in keys])
    p["sampler_profile"] = dict(batches=4, plain_wall_s=plain_s,
                                traced_wall_s=wall, device_busy_s=busy,
                                idle_share=1.0 - busy / wall, top=top[:6])
    for backend, step_ms in (("pallas", per_step["kernel_ms"]),
                             ("dense", per_step["matmul_ms"])):
        o = out[backend]
        wall_ms = 1e3 * o["sample_s"] / max(o["bfs_steps"], 1)
        o.update(step_wall_ms=wall_ms,
                 coin_share=per_step["coin_ms"] / wall_ms,
                 step_share=step_ms / wall_ms)
    emit("pallas_full", graph="com-LJ", scale=LJ_SCALE, n=n, m=graph.m,
         k=50, eps=0.5, batch=B, max_theta=max_theta, per_step=per_step,
         rows_differing=rows, differing_cells=ncells, near_ties=n_ties,
         batches_classified=nb,
         **{f"{b}": {k: v for k, v in o.items() if k != "seeds"}
            for b, o in out.items()},
         seeds={b: o["seeds"][:10] for b, o in out.items()})
    return out["pallas"]["launches"]


#: prefill logits, cuda vs cpu: |err| <= atol + rtol |cpu|.  f32: the same
#: arithmetic summed in another order; bf16: every product rounds to
#: bf16 on both devices, in other orders (the CPU tests hold the port to
#: JAX by the same bound)
#: the three engines of indices_full: C4 index lists emitted natively
#: by the sparse sampler; a bitmap store with the C4 chooser on; a bitmap
#: store with it off
INDICES_ENGINES = (("indices", "indices", True),
                   ("bitmap_c4", "bitmap", True),
                   ("bitmap", "bitmap", False))


def indices_full(torch, graph, max_theta: int) -> dict:
    """imm() on the full-size com-Amazon replica under WC (k 50, eps 0.5,
    rebuild, the sparse backend) with three engines (`INDICES_ENGINES`):
    seeds, theta, influence, covered_frac, counter and four influence
    queries identical across them; the IndexStore's counter equal to a
    count of its rows, its sizes to their members; C4's choice with its
    average coverage and l_max; then a snapshot of the index engine,
    restored into a fresh engine and replicated: identical selections
    and influences, and two more batches on the primary and the restored
    engine give identical counters.  Returns the index engine's
    launches."""
    from repro_torch import obs
    from repro_torch.core.adaptive import choose_representation, l_pad_for
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.kernels import ops
    from repro_torch.sparse.scatter import bincount_weighted

    out, ref = {}, None
    for name, store, c4 in INDICES_ENGINES:
        cfg = IMMConfig(k=50, eps=0.5, model="WC", backend="sparse",
                        batch=BATCH, max_theta=max_theta, seed=0,
                        selection_method="rebuild", store=store,
                        adaptive_representation=c4)
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
        launches = ops.launch_counts()
        counters = obs.snapshot()["counters"]
        tracer = obs.get_tracer()
        spans = {k: sum(tracer.durations_s(k))
                 for k in ("sample", "store.write", "select")}
        obs.reset()
        peak = torch.cuda.max_memory_allocated()
        st = engine.store
        avg_cov, l_max = st.coverage_stats()
        chosen = choose_representation(avg_cov, graph.n, l_max,
                                       cfg.switch_ratio)
        sets = influence_sets(torch, graph, res.seeds)
        infl = [float(x) for x in engine.influences(sets)]
        row = dict(store=store, c4=c4, theta=res.theta, rounds=res.rounds,
                   representation=res.representation, imm_s=imm_s,
                   sample_s=spans["sample"] + spans["store.write"],
                   select_s=spans["select"], avg_coverage=avg_cov,
                   l_max=l_max, c4_choice=chosen,
                   arena_bytes=st.arena_bytes, max_memory_allocated=peak,
                   launches=launches, influence=res.influence,
                   covered_frac=res.covered_frac, influences=infl,
                   seeds=[int(x) for x in res.seeds[:10]])
        check(res.theta == st.count > 0, f"indices_full {name} theta")
        check(len(set(int(x) for x in res.seeds)) == 50,
              f"indices_full {name} seeds unique")
        check(0.0 < res.covered_frac <= 1.0, f"indices_full {name} cover")
        check(infl[0] == res.influence, f"indices_full {name} influence "
              f"of the seeds {infl[0]} vs {res.influence}")
        check(launches.get("ic_sparse_hits", 0) > 0,
              f"indices_full {name}: coins not launched")
        if name == "indices":
            check(st.representation == res.representation == "indices",
                  "indices_full: the index store")
            check(launches.get("arena_commit", 0) == 0,
                  "indices_full: arena_commit on the index store")
            check(engine._emit_l > 0 and engine._fused is None,
                  "indices_full: native emission")
            count = st.count
            rows = st.R[:count]
            check(torch.equal(bincount_weighted(
                rows, torch.ones((), dtype=torch.int32, device=DEV),
                graph.n), st.counter), "indices_full: counter == rows")
            check(torch.equal((rows < graph.n).sum(dim=1,
                                                   dtype=torch.int32),
                              st.sizes[:count]),
                  "indices_full: sizes == members")
            check(bool((rows[:, :-1] <= rows[:, 1:]).all()),
                  "indices_full: rows ascending")
            fr = engine.select(50, method="fused-rebuild")
            fd = engine.select(50, method="fused-decrement")
            for sel, tag in ((fr, "fused-rebuild"), (fd, "fused-decrement")):
                check(list(sel.seeds) == list(res.seeds)
                      and sel.covered_frac == res.covered_frac,
                      f"indices_full: {tag}")
            row.update(l_pad=st.l_pad, emit_l=engine._emit_l,
                       reemits=counters.get("engine.index_reemits", 0),
                       ic_sparse_hits=launches.get("ic_sparse_hits", 0))
            primary = engine
        else:
            check(res.representation == (chosen if c4 else store),
                  f"indices_full {name}: representation")
            if c4 and chosen == "indices":
                view = st.index_view(l_pad_for(l_max))
                row.update(index_view_l_pad=int(view.R.shape[1]))
                del view
            del engine, st
        summary = dict(seeds=list(res.seeds), theta=res.theta,
                       influence=res.influence,
                       covered_frac=res.covered_frac, influences=infl)
        if ref is None:
            ref, ref_counter = summary, res.counter
        for key in summary:
            check(summary[key] == ref[key], f"indices_full {name} {key}: "
                  f"{summary[key]} vs {ref[key]}")
        check(bool((res.counter == ref_counter).all()),
              f"indices_full {name} counter")
        out[name] = row
        torch.cuda.empty_cache()
    out["snapshot"] = snapshot_check(torch, primary, graph)
    emit("indices_full", graph="com-Amazon", model="WC", n=graph.n,
         m=graph.m, k=50, eps=0.5, max_theta=max_theta,
         arena_ratio=out["bitmap"]["arena_bytes"]
         / out["indices"]["arena_bytes"], **out)
    return out["indices"]["launches"]


def snapshot_check(torch, engine, graph) -> dict:
    """`snapshot` the engine to a temporary directory, `restore` it into a
    fresh engine and `replicate` it: select(50) and the influences
    identical on all three; two more batches on the primary and the
    restored engine give identical counters (the PRNG stream resumes)."""
    import tempfile

    from repro_torch.core.engine import InfluenceEngine

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = engine.snapshot(d)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        fresh = InfluenceEngine(graph, engine.cfg, device=DEV)
        t0 = time.perf_counter()
        check(fresh.restore(d), "snapshot: restore")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    replica = engine.replicate()
    torch.cuda.synchronize()
    replicate_s = time.perf_counter() - t0
    want = engine.select(50)
    sets = influence_sets(torch, graph, want.seeds)
    infl = list(engine.influences(sets))
    for other, tag in ((fresh, "restored"), (replica, "replica")):
        got = other.select(50)
        check(list(got.seeds) == list(want.seeds)
              and got.covered_frac == want.covered_frac,
              f"snapshot: {tag} select")
        check(list(other.influences(sets)) == infl,
              f"snapshot: {tag} influences")
        check(other.store.R.data_ptr() != engine.store.R.data_ptr(),
              f"snapshot: {tag} shares the arena")
    theta = engine.theta + 2 * BATCH
    engine.extend(theta)
    fresh.extend(theta)
    check(torch.equal(engine.store.counter, fresh.store.counter),
          "snapshot: counters after two more batches")
    check(replica.theta == want.theta, "snapshot: the replica moved")
    return dict(bytes_on_disk=nbytes, save_s=save_s, load_s=load_s,
                replicate_s=replicate_s, theta_after=theta)


# ------------------------------------------------------ LT and streaming ----

#: the lt_full cell: imm() under LT with the positional walk, bitmap store
LT_CFG = dict(k=50, eps=0.5, model="LT", sampler="LT/walk", batch=BATCH,
              store="bitmap", seed=0, selection_method="rebuild")
#: the kernels lt_full's imm() must launch: the walk's coins, the bitmap
#: commit and the counter rebuild (its selection is "rebuild": the fused
#: argmax runs only in the check selection after it)
LT_KERNELS = ("uniform_draw", "arena_commit", "coverage_matvec")
#: stream_full's deltas: fringe edits (destinations of in-degree <= 8)
STREAM_DELTA = dict(inserts=256, deletes=256, reweights=256,
                    max_dst_indeg=8)
STREAM_DELTAS, STREAM_SEED = 4, 21
#: the bounded stream's byte cap: 12 packed rows (41,858 bytes each), so
#: its first batch sends the arena down the ladder; at any token width
#: (4 * s_pad bytes, s_pad a power of two >= 8) the cap is 2**k - 1 rows,
#: below theta and no multiple of the batch, so the batch that crosses
#: it evicts
BOUNDED_BYTES = (1 << 19) - 1
#: the kernels stream_full prints, and those its streams must launch
#: (packed and then token rows: no bitmap commit or coverage count); the
#: fresh engine it is held against and the check selections count apart
STREAM_KERNELS = ("packed_count", "token_count", "coverage_matvec",
                  "arena_commit", "arena_commit_packed")
STREAM_LAUNCHED = ("packed_count", "token_count", "arena_commit_packed")


def dispatch_counts(snapshot: dict, impl: str = "cuda") -> dict:
    """``{kernel: calls}`` from the ``kernels.dispatch`` counters of an
    obs snapshot (the card's dispatches, or ``impl``'s)."""
    out = {}
    for key, v in snapshot["counters"].items():
        if key.startswith("kernels.dispatch") and f"impl={impl}" in key:
            name = key.split("kernel=")[1].split(",")[0].rstrip("}")
            out[name] = out.get(name, 0) + v
    return out


def arena_sums(torch, st, count: int):
    """Column and row sums of a store's first ``count`` rows, decoded a
    block at a time."""
    colsum = torch.zeros(st.n, dtype=torch.int32, device=DEV)
    rowsum = torch.empty(count, dtype=torch.int32, device=DEV)
    for s in range(0, count, 1024):
        blk = st.R[s:min(s + 1024, count)]
        if st.representation != "bitmap":
            blk = st.codec.decode(blk)
        colsum += blk.sum(dim=0, dtype=torch.int32)
        rowsum[s:s + blk.shape[0]] = blk.sum(dim=1, dtype=torch.int32)
    return colsum, rowsum


def lt_full(torch, graph, max_theta: int) -> dict:
    """imm() on the full-size com-Amazon replica under LT (positional
    walk, bitmap store, C4 off so selection runs the bitmap kernels),
    then, as a check, the fused selection and the C4 chooser's on the
    same store (same seeds); the first four batches' rows against the
    port on the host; and a device profile of the walk.  Returns imm()'s
    own launches; the check selections' are printed apart."""
    from repro_torch import obs
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.core.sampler import get_sampler, search_iters
    from repro_torch.kernels import ops

    cfg = IMMConfig(max_theta=max_theta, adaptive_representation=False,
                    **LT_CFG)
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
    launches = ops.launch_counts()
    snap = obs.snapshot()
    tracer = obs.get_tracer()
    spans = {name: sum(tracer.durations_s(name))
             for name in ("sample", "store.write", "select")}
    obs.reset()
    peak = torch.cuda.max_memory_allocated()
    for name in LT_KERNELS:
        check(launches.get(name, 0) > 0, f"lt_full: imm() launched no "
              f"{name}")
    st = engine.store
    count = st.count
    check(res.theta == count > 0, "lt_full theta")
    check(len(set(int(s) for s in res.seeds)) == 50, "lt_full seeds unique")
    check(0.0 < res.covered_frac <= 1.0, "lt_full covered_frac")
    check(res.representation == "bitmap", "lt_full representation")
    colsum, rowsum = arena_sums(torch, st, count)
    check(torch.equal(colsum, st.counter), "lt_full counter == arena sums")
    check(torch.equal(rowsum, st.sizes[:count]), "lt_full sizes == row sums")
    ops.reset_launches()
    fr = engine.select(50, method="fused-rebuild")
    engine.cfg.adaptive_representation = True
    c4 = engine.select(50)
    check_launches = ops.launch_counts()
    for sel, tag in ((fr, "fused-rebuild"), (c4, "C4")):
        check(list(sel.seeds) == list(res.seeds)
              and sel.covered_frac == res.covered_frac,
              f"lt_full {tag} selection differs")
    check(check_launches.get("fused_select", 0) > 0,
          "lt_full: the fused check selection launched no fused_select")
    # the first four batches against the port's walk on the host
    host = get_sampler("LT/walk")(graph.to("cpu"), cfg)
    for i, key in enumerate(batch_keys(0, 4)):
        rows = host(key)[0]
        check(torch.equal(st.R[i * BATCH:(i + 1) * BATCH].cpu(), rows),
              f"lt_full batch {i}: card rows differ from the host's")
    sample = engine._sample
    keys = batch_keys(99, 5)
    wall, busy, top, _ = trace_device(torch, [lambda k=k: sample(k)
                                           for k in keys])
    emit("lt_full", graph="com-Amazon", model="LT", sampler=cfg.sampler,
         store="bitmap", n=graph.n, m=graph.m, k=50, eps=0.5,
         max_theta=max_theta, theta=res.theta, rounds=res.rounds,
         imm_s=imm_s, sample_s=spans["sample"] + spans["store.write"],
         store_write_s=spans["store.write"], select_s=spans["select"],
         walk_steps=snap["counters"].get("sampler.steps", 0),
         walk_rows_stepped=snap["counters"].get("sampler.frontier_cells", 0),
         search_iters=search_iters(engine.graph.dst_offsets),
         influence=res.influence, covered_frac=res.covered_frac,
         seeds=[int(s) for s in res.seeds],
         avg_set_size=float(st.sizes[:count].sum()) / count,
         arena_bytes=st.arena_bytes, max_memory_allocated=peak,
         profile=dict(batches=len(keys) - 1, traced_wall_s=wall,
                      device_busy_s=busy, idle_share=1.0 - busy / wall,
                      top=top[:6]),
         dispatch=dispatch_counts(snap), launches=launches,
         check_select_launches=check_launches)
    return launches


def stream_cfg(store: str):
    from repro_torch.core.engine import IMMConfig

    return IMMConfig(k=50, eps=0.5, model="LT", sampler="LT/walk+stable",
                     batch=BATCH, seed=0, store=store,
                     adaptive_representation=False)


def stream_deltas(stream, rng, count: int, apply):
    """``count`` fringe deltas drawn from ``rng`` on the stream's graph,
    each handed to ``apply``; returns what ``apply`` returned."""
    from repro_torch.stream import random_delta

    return [apply(random_delta(stream.graph, rng, **STREAM_DELTA))
            for _ in range(count)]


def serve_through(torch, server, stream, probe, seed: int) -> list:
    """Two deltas through an IMServer, three tickets of ``probe`` around
    each (all three answered alike: one flush, one store state), then a
    drain; returns each flush's answer."""
    import numpy as np

    rng = np.random.default_rng(seed)
    answers = []
    for _ in range(2):
        t0 = server.submit(probe)
        stream_deltas(stream, rng, 1, server.apply_delta)
        t1, t2 = server.submit(probe), server.submit(probe)
        got = server.flush()
        check(got[t0] == got[t1] == got[t2], "stream_full: a flush mixed "
              "two store states")
        answers.append(got[t0])
    check(server.drain(timeout=600.0), "stream_full: the server did not "
          "drain")
    torch.cuda.synchronize()
    return answers


def serve_sync_async(torch, tag, stream, twin, probe) -> dict:
    """IMServer over ``stream`` (synchronous) and over ``twin``, a stream
    in the same state (its async worker), through the same two deltas
    (`serve_through`): equal answers, epochs, counters and seeds once
    drained.  Returns each run's numbers."""
    from repro_torch.launch.serve import IMServer

    runs = {}
    for mode, eng in (("sync", stream), ("async", twin)):
        with IMServer(eng, refresh_budget=512,
                      async_refresh=mode == "async") as server:
            t0 = time.perf_counter()
            answers = serve_through(torch, server, eng, probe, seed=33)
            runs[mode] = dict(
                s=time.perf_counter() - t0, answers=answers,
                drained=server.influence(probe), epoch=server.served_epoch,
                worker_slices=server.refreshes_run)
    check(runs["sync"]["drained"] == runs["async"]["drained"]
          and runs["sync"]["epoch"] == runs["async"]["epoch"],
          f"{tag}: the sync and async servers disagree once drained")
    check(torch.equal(stream.store.counter, twin.store.counter)
          and list(stream.select(50).seeds) == list(twin.select(50).seeds),
          f"{tag}: sync and async stores differ once drained")
    check(runs["async"]["worker_slices"] > 0, f"{tag}: async worker idle")
    return runs


def stream_full(torch, graph, max_theta: int, keep: dict = None) -> dict:
    """The streaming slice at full size on the com-Amazon replica under
    LT: a StreamEngine on a packed store extended to ``max_theta``, four
    fringe deltas, refresh until drained, equal to a fresh engine on the
    post-delta graph; a bounded stream that steps down the ladder and
    evicts under a byte cap; IMServer over the stream, synchronous and
    with its async worker, equal once drained.  Returns the launches;
    ``keep`` receives the drained stream's answers and timings (what
    mesh_stream_full is held to)."""
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.core.engine import InfluenceEngine
    from repro_torch.core.store import StorePressurePolicy
    from repro_torch.kernels import ops
    from repro_torch.stream import StreamEngine

    obs.reset()
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    cfg = stream_cfg("packed")
    stream, init_s = timed(torch, lambda: StreamEngine(graph, cfg,
                                                       device=DEV))
    _, extend_s = timed(torch, lambda: stream.extend(max_theta))
    check(stream.theta == max_theta, "stream_full theta")
    rng = np.random.default_rng(STREAM_SEED)
    stale, delta_s = [], []
    for _ in range(STREAM_DELTAS):
        n_stale, s = timed(torch, lambda: stream_deltas(
            stream, rng, 1, stream.apply_delta)[0])
        stale.append(n_stale)
        delta_s.append(s)
    backlog = stream.stale
    check(backlog == sum(stale) > 0, "stream_full backlog")
    left, refresh_s = timed(torch, stream.refresh)
    check(left == 0 and stream.consistent, "stream_full: refresh drained")
    sel, stream_select_s = timed(torch, lambda: stream.select(50))
    main_launches = ops.launch_counts()
    counters = obs.snapshot()["counters"]
    peak = torch.cuda.max_memory_allocated()
    # the reference it is held against: a fresh engine, counted apart
    ops.reset_launches()
    fresh = InfluenceEngine(stream.graph, stream.cfg, device=DEV)
    _, fresh_s = timed(torch, lambda: fresh.extend(stream.theta))
    want = fresh.select(50)
    fresh_launches = ops.launch_counts()
    check(list(sel.seeds) == list(want.seeds)
          and sel.covered_frac == want.covered_frac,
          "stream_full: the drained stream's seeds differ from a fresh "
          "engine's")
    check(torch.equal(stream.store.counter, fresh.store.counter),
          "stream_full: counter differs from a fresh engine's")
    colsum, _ = arena_sums(torch, stream.store, stream.store.count)
    check(torch.equal(colsum, stream.store.counter),
          "stream_full counter == arena sums")
    del fresh
    if keep is not None:
        keep.update(stale=list(stale), seeds=[int(x) for x in sel.seeds],
                    influence=sel.influence,
                    covered_frac=sel.covered_frac,
                    counter=stream.store.counter.cpu(), extend_s=extend_s,
                    delta_s=list(delta_s), refresh_s=refresh_s)

    # bounded: packed rows down the ladder to tokens, then evictions
    obs.reset()
    obs.enable()
    ops.reset_launches()
    policy = StorePressurePolicy(max_bytes=BOUNDED_BYTES,
                                 ladder=("compressed",))
    bounded = StreamEngine(graph, stream_cfg("packed"), policy=policy,
                           device=DEV)
    st = bounded.store
    writes = [0]

    def capped(write):
        def run(*a):
            out = write(*a)
            writes[0] += 1
            check(st.capacity * st._row_bytes() <= BOUNDED_BYTES,
                  f"bounded: {st.capacity} rows x {st._row_bytes()} bytes "
                  f"over the cap after write {writes[0]} ({write.__name__})")
            return out
        return run
    st.add_batch = capped(st.add_batch)
    st.replace_rows = capped(st.replace_rows)
    _, bounded_extend_s = timed(torch, lambda: (bounded.extend(max_theta),
                                                bounded.extend(max_theta)))
    b_counters = obs.snapshot()["counters"]
    check(st.representation == "compressed"
          and b_counters.get("store.compress_steps", 0) == 1,
          "bounded: the ladder did not step once")
    check(b_counters.get("store.rows_evicted", 0) > 0,
          "bounded: nothing was evicted")
    b_stale = stream_deltas(bounded, np.random.default_rng(STREAM_SEED), 2,
                            bounded.apply_delta)
    bounded.refresh()
    check(st.capacity * st._row_bytes() <= BOUNDED_BYTES
          and bounded.stale == 0 and st.count == st.row_cap,
          "bounded: over its cap or not drained after the refresh")
    colsum, _ = arena_sums(torch, st, st.count)
    check(torch.equal(colsum, st.counter), "bounded counter == arena sums")
    b_counters = obs.snapshot()["counters"]
    bounded_launches = ops.launch_counts()
    bounded_sel = bounded.select(50)

    # IMServer: the same stream state served twice, from a snapshot
    obs.reset()
    obs.enable()
    ops.reset_launches()
    probe = np.asarray(sel.seeds)
    with tempfile.TemporaryDirectory() as d:
        stream.snapshot(d)
        twin = StreamEngine(stream.graph, stream.cfg, device=DEV)
        check(twin.restore(d), "stream_full: snapshot restore")
    runs = serve_sync_async(torch, "stream_full", stream, twin, probe)
    serve_launches = ops.launch_counts()
    obs.reset()
    launches = {k: main_launches.get(k, 0) + bounded_launches.get(k, 0)
                + serve_launches.get(k, 0)
                for k in set(main_launches) | set(bounded_launches)
                | set(serve_launches)}
    for name in STREAM_LAUNCHED:
        check(launches.get(name, 0) > 0, f"stream_full: {name} not launched")
    emit("stream_full", graph="com-Amazon", model="LT",
         sampler=stream.cfg.sampler, store="packed", n=graph.n, m=graph.m,
         theta=stream.theta, deltas=STREAM_DELTAS, delta=STREAM_DELTA,
         init_s=init_s, extend_s=extend_s, delta_s=delta_s,
         stale_per_delta=stale, refresh_s=refresh_s,
         select_s=stream_select_s, fresh_extend_s=fresh_s,
         seeds=[int(s) for s in sel.seeds[:10]], influence=sel.influence,
         kills=counters.get("store.rows_killed", 0),
         replaced=counters.get("store.rows_replaced", 0),
         compactions=counters.get("store.compactions", 0),
         repaired=counters.get("stream.rows_repaired", 0),
         arena_bytes=stream.store.arena_bytes, max_memory_allocated=peak,
         bounded=dict(max_bytes=BOUNDED_BYTES, extend_s=bounded_extend_s,
                      representation=st.representation,
                      s_pad=st.codec.s_pad, row_bytes=st._row_bytes(),
                      capacity=st.capacity, row_cap=st.row_cap,
                      count=st.count, writes_checked=writes[0],
                      compress_steps=b_counters.get("store.compress_steps",
                                                    0),
                      evicted=b_counters.get("store.rows_evicted", 0),
                      kills=b_counters.get("store.rows_killed", 0),
                      compactions=b_counters.get("store.compactions", 0),
                      stale_per_delta=b_stale,
                      arena_bytes=st.arena_bytes,
                      influence=bounded_sel.influence),
         serve={m: {k: v for k, v in r.items()} for m, r in runs.items()},
         launches={k: launches.get(k, 0) for k in STREAM_KERNELS},
         launches_main=main_launches, launches_bounded=bounded_launches,
         launches_serve=serve_launches, launches_fresh=fresh_launches)
    return launches


# ------------------------------------------------ the meshed stream ----

#: mesh_stream_full's layout: stream_full's cell on a 2x2 mesh of the
#: card, packed tiles on balanced vertex blocks
MESH_STREAM_SHAPE = (2, 2)
#: the kernels its streams must launch on the tiles: packed writes and
#: repairs, kills counted on packed tiles, then on token tiles (bounded)
MESH_STREAM_LAUNCHED = ("arena_commit_packed", "packed_count",
                        "token_count")


def tile_colsum(torch, st):
    """The column sums of a sharded store's live rows, decoded tile by
    tile on the tiles' devices, in global vertex order."""
    out = []
    for v in range(st.Dv):
        col = torch.zeros(st.n_local, dtype=torch.int32,
                          device=st.devices[0][v])
        for t in range(st.D):
            tile, c = st.tile(t, v), int(st.counts[t])
            live = st._live[t].to(tile.device)
            for lo in range(0, c, 1024):
                hi = min(lo + 1024, c)
                bits = st.codec.decode(tile[lo:hi])[live[lo:hi]]
                col += bits.sum(dim=0, dtype=torch.int32).to(col.device)
        out.append(col[:st.col_width[v]])
    return torch.cat(out)


def shard_capped(st, max_bytes, writes, tag):
    """Wrap a sharded store's add_batch and replace_rows so that after
    every call each shard holds at most ``row_cap // D`` rows and
    capacity x row bytes stays within ``max_bytes``."""
    def capped(write):
        def run(*a):
            out = write(*a)
            writes[0] += 1
            check(max(st.counts) <= st.row_cap // st.D,
                  f"{tag}: a shard holds {max(st.counts)} rows, over "
                  f"{st.row_cap // st.D} after write {writes[0]} "
                  f"({write.__name__})")
            check(st.capacity * st._row_bytes() <= max_bytes,
                  f"{tag}: {st.capacity} rows x {st._row_bytes()} bytes "
                  f"over the cap after write {writes[0]} "
                  f"({write.__name__})")
            return out
        return run
    st.add_batch = capped(st.add_batch)
    st.replace_rows = capped(st.replace_rows)


def mesh_stream_full(torch, graph, max_theta: int, ref: dict) -> dict:
    """stream_full's cell (com-Amazon at full width, LT/walk+stable,
    theta 16,384, four fringe deltas, seed 21) on a 2x2 mesh of the card,
    packed tiles on balanced vertex blocks: the stale rows of each delta,
    and, drained, the seeds, influence and counter equal stream_full's
    single-device stream (``ref``) and a fresh meshed engine on the
    post-delta graph (its launches counted apart); the stream restored
    from its snapshot on a 1x1 mesh, that one's on 2x2 again, the next
    delta repairing all three to the same rows; a bounded meshed stream
    under stream_full's byte cap down the ladder and into evictions,
    checked against the per-shard rule after every write; IMServer over
    the meshed stream and its 2x2 restore, sync and async, equal once
    drained.  Returns the streams' launches."""
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.core.engine import InfluenceEngine
    from repro_torch.core.store import StorePressurePolicy
    from repro_torch.kernels import ops
    from repro_torch.stream import StreamEngine

    tag = "mesh_stream_full"
    kw = dict(mesh=grid(DEV, MESH_STREAM_SHAPE), vertex_axis="vertex")
    cfg = dataclasses.replace(stream_cfg("packed"), partition="balanced")
    obs.reset()
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stream, init_s = timed(torch, lambda: StreamEngine(graph, cfg, **kw))
    _, extend_s = timed(torch, lambda: stream.extend(max_theta))
    check(stream.theta == max_theta, f"{tag} theta")
    rng = np.random.default_rng(STREAM_SEED)
    stale, delta_s = [], []
    for i in range(STREAM_DELTAS):
        n_stale, sec = timed(torch, lambda: stream_deltas(
            stream, rng, 1, stream.apply_delta)[0])
        stale.append(n_stale)
        delta_s.append(sec)
        check(n_stale == ref["stale"][i], f"{tag}: delta {i} staled "
              f"{n_stale} rows, stream_full's {ref['stale'][i]}")
    left, refresh_s = timed(torch, stream.refresh)
    check(left == 0 and stream.consistent, f"{tag}: refresh drained")
    sel, select_s = timed(torch, lambda: stream.select(50))
    main_launches = ops.launch_counts()
    counters = obs.snapshot()["counters"]
    peak = torch.cuda.max_memory_allocated()
    st = stream.store
    check(torch.equal(tile_colsum(torch, st), st.counter),
          f"{tag}: counter != the tiles' live column sums")
    check([int(x) for x in sel.seeds] == ref["seeds"]
          and sel.influence == ref["influence"]
          and torch.equal(st.counter.cpu(), ref["counter"]),
          f"{tag}: the drained meshed stream differs from stream_full's")
    ops.reset_launches()
    fresh = InfluenceEngine(stream.graph, stream.cfg, **kw)
    _, fresh_s = timed(torch, lambda: fresh.extend(stream.theta))
    want = fresh.select(50)
    fresh_launches = ops.launch_counts()
    check(list(sel.seeds) == list(want.seeds)
          and sel.covered_frac == want.covered_frac
          and torch.equal(st.counter, fresh.store.counter),
          f"{tag}: the drained stream differs from a fresh meshed engine")
    del fresh

    # snapshots across layouts: 2x2 -> 1x1 -> 2x2, then one more delta
    ops.reset_launches()
    moves = {}
    with tempfile.TemporaryDirectory() as d:
        _, moves["snapshot_2x2_s"] = timed(
            torch, lambda: stream.snapshot(f"{d}/a"))
        one = StreamEngine(stream.graph, cfg, mesh=grid(DEV, (1, 1)),
                           vertex_axis="vertex")
        ok, moves["restore_1x1_s"] = timed(torch, lambda: one.restore(
            f"{d}/a"))
        check(ok, f"{tag}: restore on 1x1")
        one.snapshot(f"{d}/b")
        back = StreamEngine(stream.graph, cfg, **kw)
        ok, moves["restore_2x2_s"] = timed(torch, lambda: back.restore(
            f"{d}/b"))
        check(ok, f"{tag}: restore on 2x2")
    next_stale = []
    for s in (stream, one, back):
        drng = np.random.default_rng(STREAM_SEED + 1)
        next_stale.append(stream_deltas(s, drng, 1, s.apply_delta)[0])
        s.refresh()
    check(len(set(next_stale)) == 1, f"{tag}: the next delta staled "
          f"{next_stale} rows across the layouts")
    for s, name in ((one, "1x1"), (back, "2x2 again")):
        check(torch.equal(s.store.counter, stream.store.counter)
              and list(s.select(50).seeds) == list(stream.select(50).seeds),
              f"{tag}: the {name} restore repaired to other rows")
    moves["launches"] = ops.launch_counts()
    del one

    # bounded: packed tiles down the ladder to tokens, then evictions
    obs.reset()
    obs.enable()
    ops.reset_launches()
    policy = StorePressurePolicy(max_bytes=BOUNDED_BYTES,
                                 ladder=("compressed",))
    bounded = StreamEngine(graph, cfg, policy=policy, **kw)
    bst = bounded.store
    writes = [0]
    shard_capped(bst, BOUNDED_BYTES, writes, f"{tag} bounded")
    _, bounded_extend_s = timed(torch, lambda: (bounded.extend(max_theta),
                                                bounded.extend(max_theta)))
    b_counters = obs.snapshot()["counters"]
    check(bst.representation == "compressed"
          and b_counters.get("store.compress_steps", 0) == 1,
          f"{tag} bounded: the ladder did not step once")
    check(b_counters.get("store.rows_evicted", 0) > 0,
          f"{tag} bounded: nothing was evicted")
    b_stale = stream_deltas(bounded, np.random.default_rng(STREAM_SEED), 2,
                            bounded.apply_delta)
    bounded.refresh()
    check(bounded.stale == 0 and bst.live_count == bst.row_cap,
          f"{tag} bounded: not drained to its cap")
    check(torch.equal(tile_colsum(torch, bst), bst.counter),
          f"{tag} bounded counter == the tiles' live column sums")
    b_counters = obs.snapshot()["counters"]
    bounded_launches = ops.launch_counts()
    bounded_sel = bounded.select(50)
    bounded_info = dict(
        max_bytes=BOUNDED_BYTES, extend_s=bounded_extend_s,
        representation=bst.representation, s_pad=bst.codec.s_pad,
        row_bytes=bst._row_bytes(), capacity=bst.capacity,
        cap_local=bst.cap_local, row_cap=bst.row_cap,
        counts=[int(c) for c in bst.counts], writes_checked=writes[0],
        compress_steps=b_counters.get("store.compress_steps", 0),
        evicted=b_counters.get("store.rows_evicted", 0),
        compactions=b_counters.get("store.compactions", 0),
        stale_per_delta=b_stale, tile_bytes=bst.tile_bytes(),
        influence=bounded_sel.influence)
    del bounded

    # IMServer: the same meshed stream state served twice (the stream
    # and its 2x2 restore, which holds the same rows)
    obs.reset()
    obs.enable()
    ops.reset_launches()
    probe = np.asarray(sel.seeds)
    twin = back
    runs = serve_sync_async(torch, tag, stream, twin, probe)
    serve_launches = ops.launch_counts()
    obs.reset()
    del twin
    parts = (main_launches, moves["launches"], bounded_launches,
             serve_launches)
    launches = {k: sum(p.get(k, 0) for p in parts)
                for k in set().union(*parts)}
    for name in MESH_STREAM_LAUNCHED:
        check(launches.get(name, 0) > 0, f"{tag}: {name} not launched")
    emit(tag, graph="com-Amazon", model="LT", sampler=stream.cfg.sampler,
         mesh="x".join(map(str, MESH_STREAM_SHAPE)), store="packed",
         partition="balanced", n=graph.n, m=graph.m, theta=stream.theta,
         deltas=STREAM_DELTAS, delta=STREAM_DELTA, init_s=init_s,
         extend_s=extend_s, delta_s=delta_s, stale_per_delta=stale,
         refresh_s=refresh_s, select_s=select_s, fresh_extend_s=fresh_s,
         single_device={k: ref[k] for k in ("extend_s", "delta_s",
                                            "refresh_s", "stale",
                                            "influence")},
         seeds=[int(x) for x in sel.seeds[:10]], influence=sel.influence,
         kills=counters.get("store.rows_killed", 0),
         replaced=counters.get("store.rows_replaced", 0),
         compactions=counters.get("store.compactions", 0),
         repaired=counters.get("stream.rows_repaired", 0),
         n_local=st.n_local, cap_local=st.cap_local,
         counts=[int(c) for c in st.counts], tile_bytes=st.tile_bytes(),
         tile_devices=[str(x) for row in st.devices for x in row],
         arena_bytes=st.arena_bytes, max_memory_allocated=peak,
         layouts=dict(next_stale=next_stale, **{
             k: v for k, v in moves.items() if k != "launches"}),
         bounded=bounded_info, serve=runs,
         launches={k: launches.get(k, 0) for k in STREAM_KERNELS},
         launches_main=main_launches, launches_layouts=moves["launches"],
         launches_bounded=bounded_launches, launches_serve=serve_launches,
         launches_fresh=fresh_launches)
    return launches


# -------------------------------------------------------- IMServe tier ----

#: tier_full: the reference's full serving-tier run (``benchmarks/
#: serve_tier.py --users 262144 --scale 1``, five tenants): four R-MAT
#: campaigns of n 262,144 and m 8n under WC weights, graph seeds 10-13,
#: a trace of 2.0 virtual seconds at 96 q/s a tenant (Zipf skew 1.0)
#: with a delta every 0.5 s (4 inserts, deletes and reweights at
#: in-degree <= 8); theta 1,024 an engine, the bench's own (8,192 until
#: the meshed cells pushed the whole smoke past 900 s, 4,096 until the
#: launchers' cells phase pushed it past 1,080 s: registration, the
#: streams' stable coins in plain PyTorch, scales with theta)
TIER_N, TIER_THETA = 262_144, 1_024
TIER_TRACE = dict(duration=2.0, qps=96.0, skew=1.0, delta_ops=4, seed=0)
TIER_SERVE = dict(quantum=8, refresh_budget=512)
TIER_MAX_PENDING, TIER_REPLICAS, TIER_K, TIER_PUMP = 4_096, 2, 10, 16
#: each campaign's store and selection, so the tier crosses every store
#: kind it serves (the bench runs them all on "auto")
TIER_STORES = (
    dict(store="bitmap", adaptive_representation=False,
         selection_method="fused-rebuild"),
    dict(store="packed"),
    dict(store="auto"),
    dict(store="bitmap", adaptive_representation=False,
         selection_method="rebuild"),
)
#: the kernels the tier's own window must launch: the commits (static
#: extends, the packed stream's batches and repairs), the counter rebuilds
#: (campaign-3's kills and rebuild selection), the fused argmax
#: (campaign-0's selection), the packed count and the positional coins
TIER_KERNELS = ("arena_commit", "arena_commit_packed", "coverage_matvec",
                "fused_select", "packed_count", "ic_sparse_hits")
#: mesh_tier_full: tier_full's tenants with every engine on a 2x2 mesh of
#: the card at the bench's own theta, 1,024, as tier_full's
#: (registration and the fresh streams are the streams' stable coins,
#: plain PyTorch, ROADMAP B10); the sharded selections
#: reduce partials, so no fused_select
MESH_TIER_SHAPE, MESH_TIER_THETA = (2, 2), 1_024
#: the parity tier's theta (1,024 until the launchers' cells phase: its
#: four replays, two on the host, took ~100 s of the smoke)
TIER_PARITY_THETA = 512
MESH_TIER_KERNELS = ("arena_commit", "arena_commit_packed",
                     "coverage_matvec", "packed_count", "ic_sparse_hits")


def tier_specs(n: int, theta: int, replicas: int, max_pending: int,
               meshed: bool = False):
    """The bench's tenant mix (``serve_tier._specs``): campaign-0 static,
    strict, weight 2; campaign-1 and -3 streaming; campaign-2 static,
    relaxed, with replicas; campaign-4 a slot on campaign-0's engine at
    weight 0.5; every engine on the sparse sampler (a stream on its
    ``+stable`` form).  ``meshed``: the bitmap stores are "auto" (bitmap
    tiles; a mesh takes no single-device kind)."""
    from repro_torch.core.engine import IMMConfig
    from repro_torch.graphs import rmat_graph
    from repro_torch.serve import TenantSpec

    specs = []
    for i, store in enumerate(TIER_STORES):
        if meshed and store["store"] == "bitmap":
            store = dict(store, store="auto")
        cfg = IMMConfig(k=TIER_K, batch=max(theta // 4, 64),
                        max_theta=max(theta, 1 << 20), seed=i,
                        sampler="IC/sparse", **store)
        specs.append(TenantSpec(
            f"campaign-{i}", graph=rmat_graph(n, 8 * n, seed=10 + i,
                                              weighted_ic="wc"),
            cfg=cfg, theta=theta, streaming=i % 2 == 1,
            slo="relaxed" if i == 2 else "strict",
            replicas=replicas if i == 2 else 0,
            weight=2.0 if i == 0 else 1.0, max_pending=max_pending))
    specs.append(TenantSpec("campaign-4", share_engine_with="campaign-0",
                            weight=0.5, max_pending=max_pending))
    return specs


def tier_trace(tier, duration: float, qps: float, skew: float,
               delta_ops: int, seed: int):
    """The bench's trace over the tier's tenants (streaming: the tenants
    that own a stream)."""
    import numpy as np

    from repro_torch.serve import make_trace, zipf_rates

    graphs = {t.name: t.graph for t in tier.tenants.values()}
    streaming = {t.name: t.streaming and t.owns_engine
                 for t in tier.tenants.values()}
    names = sorted(graphs)
    return make_trace(
        graphs, duration=duration,
        qps=zipf_rates(names, qps * len(names), skew,
                       np.random.default_rng(seed)),
        streaming=streaming, delta_period=duration / 4,
        delta_ops=delta_ops, seed=seed + 1)


def served_record(r) -> tuple:
    """A ServedQuery without its latency."""
    return (r.ticket, r.tenant, r.value, r.epoch, r.cached, r.replica)


def tier_replay(torch, dev, mesh_kwargs=None) -> dict:
    """The five-tenant mix at n 2,048 and `TIER_PARITY_THETA` on ``dev``
    (every engine on ``mesh_kwargs``'s mesh when given), its trace
    replayed synchronously (a refresh step after every pump, no
    worker)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import KIND_DELTA, IMServe

    ops.reset_launches()
    t0 = time.perf_counter()
    tier = IMServe(device=dev, quantum=8, refresh_budget=64,
                   mesh_kwargs=mesh_kwargs)
    for spec in tier_specs(2048, TIER_PARITY_THETA, TIER_REPLICAS,
                           TIER_MAX_PENDING,
                           meshed=mesh_kwargs is not None):
        tier.register(spec)
    events = tier_trace(tier, duration=1.0, qps=96.0, skew=1.0,
                        delta_ops=4, seed=0)
    tickets = []
    for e in events:
        if e.kind == KIND_DELTA:
            tier.apply_delta(e.tenant, e.delta)
        else:
            tickets.append(tier.submit(e.tenant, e.seeds))
        if tier.pending >= TIER_PUMP:
            tier.pump()
            tier.refresh_step()
    while tier.pending:
        tier.pump()
        tier.refresh_step()
    check(tier.drain(timeout=600.0), f"tier parity {dev}: drain")
    stats = tier.stats()
    shipped = stats["replicas"]["campaign-2"]["bytes_shipped"]
    check(shipped > 0, f"tier parity {dev}: nothing shipped")
    return dict(
        events=[(e.t, e.tenant, e.kind,
                 None if e.seeds is None else e.seeds.tolist())
                for e in events],
        recs=[served_record(tier.result(t)) for t in tickets], stats=stats,
        epochs={n: sorted(tier.cache.epochs(n)) for n in tier.tenants},
        sels={n: [int(s) for s in tier.select(n, TIER_K).seeds]
              for n in tier.tenants},
        s=time.perf_counter() - t0, launches=ops.launch_counts())


def tier_parity(torch) -> dict:
    """The five-tenant mix at n 2,048 and `TIER_PARITY_THETA` (sparse
    sampler), the same trace replayed synchronously on the card and on
    the host, then with every engine on a 2x2 mesh of the card and of the
    host:
    every ServedQuery but its latency, the stats, the cache's epochs and
    the selections equal the unmeshed replay."""
    out = {dev: tier_replay(torch, dev) for dev in (DEV, "cpu")}
    for dev in (DEV, "cpu"):
        out[f"{dev} 2x2"] = tier_replay(torch, dev, {
            "mesh": grid(dev, (2, 2)), "theta_axes": ("data",),
            "vertex_axis": "vertex"})
    c = out[DEV]
    # the replica fan-out ships the store's snapshot tree, whose size is
    # its layout's (live rows compacted on a mesh, the arena off it): the
    # meshed runs' bytes_shipped equal each other's, every other stat
    # equals the unmeshed replay's
    meshed = [out[f"{dev} 2x2"]["stats"] for dev in (DEV, "cpu")]
    shipped = [m["replicas"]["campaign-2"].pop("bytes_shipped")
               for m in meshed]
    check(shipped[0] == shipped[1], f"tier parity: bytes_shipped differ on "
          f"{DEV} 2x2 and cpu 2x2: {shipped}")
    unmeshed = copy.deepcopy(c["stats"])
    unmeshed["replicas"]["campaign-2"].pop("bytes_shipped")
    for run, o in out.items():
        for key in ("events", "recs", "stats", "epochs", "sels"):
            want = unmeshed if key == "stats" and "2x2" in run else c[key]
            check(o[key] == want, f"tier parity: {key} differ on {run} "
                  f"and {DEV}")
        on_card = sum(o["launches"].values())
        check(on_card > 0 if run.startswith(DEV) else on_card == 0,
              f"tier parity {run}: launches on the wrong device")
    flags = {(r[4], r[5]) for r in c["recs"]}
    check((True, False) in flags and (False, True) in flags,
          "tier parity: no cached or no replica answer")
    return dict(queries=len(c["recs"]),
                s={run: o["s"] for run, o in out.items()},
                cached=sum(r[4] for r in c["recs"]),
                replica=sum(r[5] for r in c["recs"]),
                epochs=max(r[3] for r in c["recs"]),
                cache=c["stats"]["cache"], refresh=c["stats"]["refresh"],
                launches=c["launches"],
                mesh_launches=out[f"{DEV} 2x2"]["launches"])


def percentiles_ms(lat_s) -> dict:
    import numpy as np

    arr = np.asarray(lat_s, np.float64) * 1e3
    return {"n": int(arr.size), "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99))}


def tier_full(torch, mesh_shape=None) -> dict:
    """The IMServe tier at the reference bench's full size: five tenants
    registered on the card (timed one by one), the bench's trace built
    (timed apart: its deltas rebuild each graph on the host), replayed
    in arrival order through admission, DRR, the cache and the replicas
    while the refresh worker repairs, then a drain, a top-k selection
    per tenant and an admission flood.  Checks every answer against the
    primaries and fresh engines (launches counted apart).  Returns the
    tier's own launches.  With ``mesh_shape`` (mesh_tier_full) every
    engine, replicas and fresh streams too, is on a mesh of the card of
    that shape, at theta 1,024 an engine (the bench's own, as
    tier_full's: registration and the fresh streams are the streams'
    stable coins, plain PyTorch, ROADMAP B10), and it must drain with no
    deadlock (the meshed tenants share one dispatch lock)."""
    import gc
    import hashlib

    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        KIND_DELTA, AdmissionError, IMServe, trace_summary,
    )
    from repro_torch.stream import StreamEngine

    meshed = mesh_shape is not None
    tag = "mesh_tier_full" if meshed else "tier_full"
    theta = MESH_TIER_THETA if meshed else TIER_THETA
    mesh_kw = ({"mesh": grid(DEV, mesh_shape), "theta_axes": ("data",),
                "vertex_axis": "vertex"} if meshed else {})
    gc.collect()
    torch.cuda.empty_cache()
    obs.reset()
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    specs = tier_specs(TIER_N, theta, TIER_REPLICAS, TIER_MAX_PENDING,
                       meshed=meshed)
    ops.reset_launches()
    tier = IMServe(device=DEV, mesh_kwargs=mesh_kw or None, **TIER_SERVE)
    register_s = {}
    for spec in specs:
        _, register_s[spec.name] = timed(torch, lambda: tier.register(spec))
    events, trace_s = timed(torch, lambda: tier_trace(tier, **TIER_TRACE))
    seeds_of, stale, rejected = {}, [], 0
    check_s, checked_cached = 0.0, 0
    streams = [n for n, t in tier.tenants.items()
               if t.streaming and t.owns_engine]

    def check_round(answered):
        """Every cached answer of a stream this round equals a recompute
        at its epoch (deltas land only on this thread, so the tenant is
        still at that consistent epoch), and no cache entry outlives its
        tenant's served epoch."""
        nonlocal checked_cached
        for name in streams:
            t = tier.tenants[name]
            recs = [tier.result(k) for k in answered
                    if tier.result(k).tenant == name
                    and tier.result(k).cached]
            if recs:
                with t.lock:
                    check(t.backlog == 0 and all(
                        r.epoch == t.epoch for r in recs),
                        f"{tag} {name}: a cached answer off its epoch")
                    want = t.engine.influences(
                        [seeds_of[r.ticket] for r in recs])
                check(all(float(w) == r.value for w, r in zip(want, recs)),
                      f"{tag} {name}: a cached answer differs from a "
                      f"recompute at its epoch")
                checked_cached += len(recs)
        for name, t in tier.tenants.items():
            check(tier.cache.epochs(name) <= {t.served_epoch},
                  f"{tag} {name}: a cache entry outlived its epoch")

    with tier:
        tier.start_refresh_worker()
        t0 = time.perf_counter()
        answered = {}
        for e in events:
            if e.kind == KIND_DELTA:
                stale.append((e.tenant, tier.apply_delta(e.tenant, e.delta)))
            else:
                tid = tier.try_submit(e.tenant, e.seeds)
                if tid is None:
                    rejected += 1
                else:
                    seeds_of[tid] = e.seeds
            if tier.pending >= TIER_PUMP:
                got = tier.pump()
                answered.update(got)
                c0 = time.perf_counter()
                check_round(got)
                check_s += time.perf_counter() - c0
        got = tier.flush()
        answered.update(got)
        c0 = time.perf_counter()
        check_round(got)
        check_s += time.perf_counter() - c0
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0 - check_s
        (drained, drain_s) = timed(torch, lambda: tier.drain(timeout=600.0))
    check(drained, f"{tag}: the tier did not drain")
    check(not tier.refreshing, f"{tag}: the worker outlived close")
    if meshed:
        owners = [t for t in tier.tenants.values() if t.owns_engine]
        check(all(t.engine.store.__class__.__name__ == "ShardedStore"
                  for t in owners) and len({id(t.lock) for t in
                                            tier.tenants.values()}) == 1,
              f"{tag}: a tenant off the mesh or off the dispatch lock")
    n_queries = sum(1 for e in events if e.kind != KIND_DELTA)
    check(len(answered) + rejected == n_queries and all(
        tier.result(t) is not None for t in answered),
        f"{tag}: an admitted query went unanswered")
    sels, select_s = timed(torch, lambda: {
        n: tier.select(n, TIER_K) for n in tier.tenants})
    stats = tier.stats()
    snap = obs.snapshot()

    # check 4: a flood of max_pending + 64 submits to one tenant
    frng = np.random.default_rng(99)
    flood_ids, flood_rejected = [], 0
    for _ in range(TIER_MAX_PENDING + 64):
        try:
            flood_ids.append(tier.submit(
                "campaign-0", frng.choice(TIER_N, 4, replace=False)))
        except AdmissionError:
            flood_rejected += 1
    others = {n: [tier.submit(n, frng.choice(TIER_N, 3, replace=False))
                  for _ in range(8)] for n in tier.tenants
              if n != "campaign-0"}
    first = tier.pump()
    per_round = {}
    for tid in first:
        per_round[tier.result(tid).tenant] = per_round.get(
            tier.result(tid).tenant, 0) + 1
    want_round = {n: int(TIER_SERVE["quantum"] * t.spec.weight)
                  for n, t in tier.tenants.items()}
    check(flood_rejected == 64, f"{tag}: the flood gave "
          f"{flood_rejected} rejections, not 64")
    check(per_round == want_round, f"{tag}: the flood's first round "
          f"served {per_round}, not {want_round}")
    _, flood_s = timed(torch, tier.flush)
    check(all(tier.result(t) is not None for t in flood_ids)
          and all(tier.result(t) is not None
                  for ids in others.values() for t in ids),
          f"{tag}: the flood left queries unanswered")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in MESH_TIER_KERNELS if meshed else TIER_KERNELS:
        check(launches.get(name, 0) > 0,
              f"{tag}: the tier launched no {name}")

    # check 2: static answers (primary, replica or cache) == the primary's
    ops.reset_launches()
    recs = [tier.result(t) for t in answered]
    static = {}
    for r in recs:
        t = tier.tenants[r.tenant]
        if not t.streaming:
            static.setdefault(r.tenant, []).append(r)
    for name, rs in static.items():
        with tier.tenants[name].lock:
            want = tier.tenants[name].engine.influences(
                [seeds_of[r.ticket] for r in rs])
        check(all(float(w) == r.value for w, r in zip(want, rs)),
              f"{tag} {name}: an answer differs from the primary's")
    group = tier.replica_groups["campaign-2"]
    primary = tier.tenants["campaign-2"].engine

    def rows_of(store):
        """A store's rows as a multiset of digests (a meshed replica
        holds the primary's live rows in its own slots)."""
        if not meshed:
            return store.R
        return sorted(hashlib.sha1(r.tobytes()).digest()
                      for r in store.state()["R"])
    for rep in group.replicas:
        same = (torch.equal(rep.store.R, primary.store.R) if not meshed
                else rows_of(rep.store) == rows_of(primary.store))
        check(same and torch.equal(rep.store.counter, primary.store.counter),
              f"{tag}: a replica's store differs from the primary's")
    # check 3: each drained stream == a fresh stream on its graph
    fresh_s = {}
    for name in streams:
        t = tier.tenants[name]
        fresh = StreamEngine(t.graph, t.engine.cfg, device=DEV, **mesh_kw)
        _, fresh_s[name] = timed(torch, lambda: fresh.extend(theta))
        check(torch.equal(t.engine.store.counter, fresh.store.counter),
              f"{tag} {name}: counter differs from a fresh stream's")
        check(list(sels[name].seeds) == list(fresh.select(TIER_K).seeds),
              f"{tag} {name}: select({TIER_K}) differs from a fresh "
              f"stream's")
        del fresh
    check_launches = ops.launch_counts()
    obs.reset()

    by_tenant = {}
    for r in recs:
        by_tenant.setdefault(r.tenant, []).append(r.latency_s)
    hist = snap["histograms"]
    ctr = snap["counters"]
    lat_hist = {n: {k: hist[f"serve.latency_ms{{tenant={n}}}"][k]
                    for k in ("count", "p50", "p99", "max")}
                for n in tier.tenants
                if f"serve.latency_ms{{tenant={n}}}" in hist}
    changed = (["theta 1,024 an engine (the bench's own, as "
                "tier_full's)",
                "every engine on a 2x2 mesh of the card",
                "stores and selections vary across campaigns (bitmap "
                "tiles fused-rebuild, packed tiles, auto, bitmap tiles "
                "rebuild)"] if meshed else
               ["stores and selections vary across campaigns "
                "(bitmap fused-rebuild, packed, auto, bitmap rebuild)"])
    emit(tag, source="benchmarks/serve_tier.py --users 262144 "
         "--scale 1 --tenants 5", n=TIER_N,
         m={n: t.graph.m for n, t in tier.tenants.items() if t.owns_engine},
         theta=theta, trace=TIER_TRACE, serve=TIER_SERVE,
         mesh=None if not meshed else "x".join(map(str, mesh_shape)),
         max_pending=TIER_MAX_PENDING, replicas=TIER_REPLICAS,
         changed=changed + [
             "campaign-2 has 2 replicas, not 1",
             "sampler IC/sparse named (the bench's default at this n)"],
         reduced=[], stores={n: t.engine.store.representation
                             for n, t in tier.tenants.items()},
         tile_bytes={n: t.engine.store.tile_bytes()
                     for n, t in tier.tenants.items()
                     if meshed and t.owns_engine},
         register_s=register_s, trace_build_s=trace_s,
         events=trace_summary(events),
         serve_s=serve_s, check_s=check_s, drain_s=drain_s,
         select_s=select_s, flood_s=flood_s,
         answered=len(answered), rejected=rejected,
         qps=len(answered) / serve_s,
         latency_ms=dict(all=percentiles_ms(
             [r.latency_s for r in recs]),
             **{n: percentiles_ms(v) for n, v in sorted(by_tenant.items())}),
         latency_hist_ms=lat_hist,
         cache=stats["cache"],
         cache_bypass=sum(v for k, v in ctr.items()
                          if k.startswith("serve.cache_bypass")),
         cached_checked=checked_cached,
         stale_per_delta=stale, refresh=stats["refresh"],
         tenants={n: {k: ts[k] for k in ("served", "cache_hits",
                                        "replica_reads", "epoch",
                                        "refreshes", "rows_repaired")}
                  for n, ts in stats["tenants"].items()},
         replica=dict(**stats["replicas"]["campaign-2"],
                      sync_ms={k: hist["serve.replica_sync_ms"][k]
                               for k in ("count", "sum", "min", "max")}),
         selections={n: [int(v) for v in s.seeds]
                     for n, s in sels.items()},
         flood=dict(submitted=TIER_MAX_PENDING + 64,
                    rejected=flood_rejected, first_round=per_round),
         fresh_extend_s=fresh_s, max_memory_allocated=peak,
         nvidia_smi=nvidia_smi(), launches=launches,
         check_launches=check_launches)
    return launches


# ------------------------------------------------------------ LM serving ----

LOGIT_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.05, 0.02)}
PARITY_B, PARITY_PROMPT, PARITY_GEN = 2, 48, 16
FULL_B, FULL_PROMPT, FULL_GEN = 4, 512, 32


LM_ARCHS = ("qwen1.5-0.5b", "h2o-danube-3-4b", "minicpm-2b",
            "moonshot-v1-16b-a3b", "grok-1-314b")


def parity_configs():
    """The five smoke configs and a narrow bf16 config of Qwen1.5-0.5B's
    shape (head dim 64, QKV bias, its vocab)."""
    import dataclasses

    from repro_torch.configs import get_arch

    qwen = get_arch("qwen1.5-0.5b").config
    narrow = dataclasses.replace(qwen, name="qwen-narrow", n_layers=2,
                                 d_model=256, n_heads=4, n_kv_heads=4,
                                 d_ff=704)
    return [get_arch(a).smoke_config for a in LM_ARCHS] + [narrow]


#: gradients, cuda against cpu: |err| <= GRAD_TOL * (1 + |cpu|), the f32
#: LM tolerance of the CPU tests against JAX (PERF.md section 2)
GRAD_TOL = 1e-4
GRAD_B, GRAD_S = 2, 48


def lm_grad_parity(torch) -> dict:
    """lm_loss and every gradient leaf of the five smoke configs (f32,
    remat on) on cuda against the same on cpu, from the same weights and
    tokens; on cuda attention runs through FlashAttention, whose forward
    launches twice a layer (the forward and the checkpoint's
    recompute) and whose backward, the SIMT kernel in f32, once."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (_tree_map, init_lm,
                                                lm_value_and_grad, tree_leaves)

    out = {}
    for arch in LM_ARCHS:
        cfg = get_arch(arch).smoke_config
        params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
        toks = prng.randint(prng.PRNGKey(4), (GRAD_B, GRAD_S + 1), 0,
                            cfg.vocab)
        res = {}
        for dev in (DEV, "cpu"):
            p = _tree_map(lambda t: t.to(dev), params)
            ops.reset_launches()
            loss, grads = lm_value_and_grad(p, cfg, toks[:, :-1].to(dev),
                                            toks[:, 1:].to(dev))
            counts = ops.launch_counts()
            res[dev] = (float(loss), {"/".join(k): g.float().cpu()
                                      for k, g in tree_leaves(grads)},
                        (counts.get("flash_attention", 0),
                         counts.get("flash_attention_bwd:simt", 0)))
        (lc, gc, nc), (lh, gh, nh) = res[DEV], res["cpu"]
        check(nc == (2 * cfg.n_layers, cfg.n_layers) and nh == (0, 0),
              f"lm_grad {arch}: flash_attention and flash_attention_bwd:"
              f"simt launched {nc} (cuda) / {nh} (cpu) times, want "
              f"{(2 * cfg.n_layers, cfg.n_layers)} / (0, 0)")
        check(abs(lc - lh) <= GRAD_TOL * (1 + abs(lh)),
              f"lm_grad {arch}: loss {lc} (cuda) against {lh} (cpu)")
        worst = {}
        for name, want in gh.items():
            got = gc[name]
            check(bool(torch.isfinite(got).all()), f"lm_grad {arch}: {name}"
                  f" not finite")
            err = float(((got - want).abs() / (1 + want.abs())).max())
            check(err <= GRAD_TOL, f"lm_grad {arch}: d{name} differs by "
                  f"{err:.3g} (relative to 1 + |cpu|)")
            worst[name] = err
        name = max(worst, key=worst.get)
        out[arch] = dict(loss_cuda=lc, loss_cpu=lh, leaves=len(worst),
                         worst_leaf=name, worst_err=worst[name],
                         qkv_err=max(worst[f"layers/w{c}"] for c in "qkv"),
                         flash_attention_launches=nc[0],
                         flash_attention_bwd_launches=nc[1])
    return out


def moe_mesh_parity(torch) -> dict:
    """The meshed MoE FFN (`moe_sharded`, ep and tpe) on 1x2 and 2x2
    meshes of the card against the single-device `_moe_ffn` on the same
    layer and tokens, at a capacity factor where no choice drops (local
    and global capacities then give the same sums): y and aux within
    GRAD_TOL, and the gradient of x finite."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.mesh import Mesh
    from repro_torch.models import moe, moe_sharded
    from repro_torch.models.transformer import _layers, _moe_ffn, init_lm

    out = {}
    saved = moe_sharded.MESH
    try:
        for arch in ("moonshot-v1-16b-a3b", "grok-1-314b"):
            cfg = dataclasses.replace(get_arch(arch).smoke_config,
                                      capacity_factor=64.0)
            p = _layers(init_lm(torch.Generator(device=DEV).manual_seed(0),
                                cfg, device=DEV))[0]
            x = torch.randn((4, 16, cfg.d_model), device=DEV,
                            generator=torch.Generator(
                                device=DEV).manual_seed(1))
            x2d = x.reshape(-1, cfg.d_model)
            r = moe.route(x2d, p["router"], cfg.n_experts, cfg.top_k,
                          cfg.capacity_factor)
            check(bool(r.keep.all()), f"moe_mesh {arch}: a choice dropped")
            y0, a0 = _moe_ffn(p, x2d, cfg)
            for shape in ((1, 2), (2, 2)):
                moe_sharded.MESH = Mesh([[DEV] * shape[1]] * shape[0],
                                        ("data", "model"))
                for part in ("ep", "tpe"):
                    c2 = dataclasses.replace(cfg, moe_impl="shard_map",
                                             moe_shard_axes=("data",),
                                             moe_partition=part)
                    xx = x.clone().requires_grad_()
                    y, a = moe_sharded.moe_ffn_sharded(p, xx, c2)
                    (gx,) = torch.autograd.grad(y.sum() + a, xx)
                    y, a = y.detach().reshape(-1, cfg.d_model), a.detach()
                    err = float(((y - y0).abs() / (1 + y0.abs())).max())
                    aerr = abs(float(a) - float(a0))
                    tag = f"moe_mesh {arch} {shape[0]}x{shape[1]} {part}"
                    check(err <= GRAD_TOL and aerr <= GRAD_TOL
                          * (1 + abs(float(a0))), f"{tag}: y err {err:.3g}"
                          f", aux err {aerr:.3g}")
                    check(bool(torch.isfinite(gx).all()),
                          f"{tag}: gradient not finite")
                    out[f"{arch} {shape[0]}x{shape[1]} {part}"] = dict(
                        y_err=err, aux_err=aerr)
    finally:
        moe_sharded.MESH = saved
    return out


def greedy_with_gaps(torch, server, prompts, n: int):
    """generate's tokens, step by step, with the top-2 logit gap of every
    step (prefill's logits give token 0)."""
    from repro_torch.models.transformer import decode_logits

    logits, _ = server.prefill(prompts)
    _, cache = server.seed_cache(prompts)
    toks, gaps = [], []
    for _ in range(n):
        top2 = logits.float().topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        tok = torch.argmax(logits, dim=-1)[:, None].to(prompts.dtype)
        toks.append(tok)
        logits, cache = decode_logits(server.params, server.cfg, cache, tok)
        logits = logits[:, 0]
    return torch.cat(toks, dim=1), torch.stack(gaps, dim=1)


def lm_parity_phase(torch) -> dict:
    """Each parity config served on cuda and on cpu from the same weights
    (drawn on the cpu): prefill logits and caches within LOGIT_TOL, prefill
    through flash_attention on cuda only, and greedy tokens equal except
    from a step where the cpu's top-2 gap is within the tolerance; a
    prompt and a decode token out of the vocabulary give NaN logits in
    their rows on both devices, and the other rows within LOGIT_TOL."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMServer
    from repro_torch.models.transformer import decode_logits, init_lm

    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    try:
        for cfg in parity_configs():
            prompts = prng.randint(prng.PRNGKey(1),
                                   (PARITY_B, PARITY_PROMPT), 0, cfg.vocab)
            res = {}
            for dev in (DEV, "cpu"):
                server = LMServer(cfg, init_lm(
                    torch.Generator().manual_seed(0), cfg, device=dev),
                    max_len=PARITY_PROMPT + PARITY_GEN, device=dev)
                ops.reset_launches()
                p = prompts.to(dev)
                logits, cache = server.prefill(p)
                launches = ops.launch_counts().get("flash_attention", 0)
                # an out-of-range token in row 1 of the prompt, and as the
                # decode token of row 0: NaN in those rows only
                bad = p.clone()
                bad[1, PARITY_PROMPT // 2] = cfg.vocab
                bad_logits, _ = server.prefill(bad)
                _, bad_cache = server.seed_cache(p)
                bad_step, _ = decode_logits(
                    server.params, server.cfg, bad_cache,
                    torch.tensor([[cfg.vocab], [3]], dtype=p.dtype,
                                 device=dev))
                toks, gaps = greedy_with_gaps(torch, server, p, PARITY_GEN)
                check(torch.equal(toks, server.generate(p, PARITY_GEN)),
                      f"lm_parity {cfg.name} {dev}: generate differs from "
                      f"its own steps")
                res[dev] = dict(logits=logits.float().cpu(),
                                k=cache["k"].float().cpu(), toks=toks.cpu(),
                                gaps=gaps.cpu(), launches=launches,
                                bad_prefill=bad_logits.float().cpu(),
                                bad_decode=bad_step[:, 0].float().cpu())
            c, h = res[DEV], res["cpu"]
            check(c["launches"] == cfg.n_layers and h["launches"] == 0,
                  f"lm_parity {cfg.name}: flash_attention launched "
                  f"{c['launches']} (cuda) / {h['launches']} (cpu) times")
            atol, rtol = LOGIT_TOL[cfg.dtype]
            lerr = (c["logits"] - h["logits"]).abs()
            kerr = (c["k"] - h["k"]).abs()
            check(bool((lerr <= atol + rtol * h["logits"].abs()).all()),
                  f"lm_parity {cfg.name}: logits differ by "
                  f"{float(lerr.max())}")
            check(bool((kerr <= atol + rtol * h["k"].abs()).all()),
                  f"lm_parity {cfg.name}: prefill cache differs by "
                  f"{float(kerr.max())}")
            for key, nan_row in (("bad_prefill", 1), ("bad_decode", 0)):
                cn, hn = torch.isnan(c[key]), torch.isnan(h[key])
                check(torch.equal(cn, hn) and bool(hn[nan_row].all())
                      and not bool(hn[1 - nan_row].any()),
                      f"lm_parity {cfg.name}: {key} NaN rows "
                      f"{cn.any(-1).tolist()} (cuda), "
                      f"{hn.any(-1).tolist()} (cpu)")
                ok = 1 - nan_row
                berr = (c[key][ok] - h[key][ok]).abs()
                check(bool((berr <= atol + rtol * h[key][ok].abs()).all()),
                      f"lm_parity {cfg.name}: {key} row {ok} differs by "
                      f"{float(berr.max())}")
            diverged = []
            for b in range(PARITY_B):
                ne = (c["toks"][b] != h["toks"][b]).nonzero()
                if ne.numel() == 0:
                    continue
                j = int(ne[0])
                top = float(h["logits"][b].abs().max())
                gap = float(h["gaps"][b, j])
                check(gap <= atol + rtol * top,
                      f"lm_parity {cfg.name}: row {b} differs at step {j} "
                      f"with a cpu top-2 gap of {gap}")
                diverged.append(dict(row=b, step=j, gap=gap))
            out[cfg.name] = dict(
                dtype=cfg.dtype, vocab=cfg.vocab, d_model=cfg.d_model,
                logits_max_abs_err=float(lerr.max()),
                cache_max_abs_err=float(kerr.max()),
                tokens_equal=bool(torch.equal(c["toks"], h["toks"])),
                diverged=diverged,
                min_cpu_gap=float(h["gaps"].min()),
                tokens=c["toks"][0, :8].tolist())
        grads = lm_grad_parity(torch)
        meshed = moe_mesh_parity(torch)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved
    emit("lm_parity", batch=PARITY_B, prompt=PARITY_PROMPT, gen=PARITY_GEN,
         tol=LOGIT_TOL, allow_bf16_reduced_precision_reduction=False,
         allow_tf32=False, **out)
    emit("lm_grad_parity", batch=GRAD_B, seq=GRAD_S, tol=GRAD_TOL, **grads)
    emit("moe_mesh_parity", tol=GRAD_TOL, **meshed)
    return out


def lm_full_phase(torch) -> dict:
    """LMServer on the full-width Qwen1.5-0.5B config: init, one timed
    generate with the launch counts set to 0 just before it, then its
    pieces (prefill, the prompt replay through decode_step, the decode
    loop) timed one by one, and a prefill's device time under the
    profiler; returns the generate's launch counts."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMServer

    cfg = get_arch("qwen1.5-0.5b").config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LMServer(cfg, max_len=FULL_PROMPT + FULL_GEN, seed=0,
                      device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = prng.randint(prng.PRNGKey(1), (FULL_B, FULL_PROMPT), 0,
                           cfg.vocab, device=DEV)
    server.generate(prompts[:, :16], 2)            # warm-up: cuBLAS, caches
    torch.cuda.synchronize()

    ops.reset_launches()
    out1, generate_s = timed(torch,
                             lambda: server.generate(prompts, FULL_GEN))
    launches = ops.launch_counts()
    check(launches.get("flash_attention", 0) == cfg.n_layers,
          f"lm_full: flash_attention launched "
          f"{launches.get('flash_attention', 0)} times in one prefill of "
          f"{cfg.n_layers} layers")
    check(launches.get("flash_attention:tc", 0) == cfg.n_layers,
          f"lm_full: {launches.get('flash_attention:tc', 0)} of the "
          f"{cfg.n_layers} prefill launches went through the tensor-core "
          f"kernel")
    (logits, _), prefill_s = timed(torch, lambda: server.prefill(prompts))
    (last, cache), replay_s = timed(torch,
                                    lambda: server.seed_cache(prompts))
    first = torch.argmax(logits, dim=-1)[:, None].to(prompts.dtype)
    out2, decode_s = timed(torch,
                           lambda: server.decode(cache, first, FULL_GEN))
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits.float()).all()), "lm_full: logits")
    check(tuple(out1.shape) == (FULL_B, FULL_GEN), "lm_full: shape")
    check(bool(((out1 >= 0) & (out1 < cfg.vocab)).all()), "lm_full: ids")
    check(torch.equal(out1, out2), "lm_full: a second generate differs")
    # prefill (through the kernel) and the replay's last step (plain
    # decode attention over a bf16 cache) compute the same logits in bf16
    # by two routes: they pick the same next token, or prefill's top-2 gap
    # is within the bf16 logit tolerance (and its bf16 step is printed)
    top2 = logits.float().topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    steps = (2.0 ** (torch.floor(torch.log2(top2[:, 0].abs())) - 7)).tolist()
    agree = (first == last).squeeze(1).tolist()
    atol, rtol = LOGIT_TOL["bfloat16"]
    for b in range(FULL_B):
        check(agree[b] or gaps[b] <= atol + rtol * float(top2[b, 0].abs()),
              f"lm_full: request {b}: prefill picks {int(first[b])}, the "
              f"replay {int(last[b])}, with a top-2 gap of {gaps[b]}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = attention_inputs(torch, gen, FULL_B, cfg.n_heads,
                               cfg.n_kv_heads, FULL_PROMPT, FULL_PROMPT,
                               cfg.head_dim, torch.bfloat16)
    kernel_ms = time_cuda(torch, lambda: fa.flash_attention_cuda(q, k, v))
    # where a prefill's time goes: device-busy time and its kernels under
    # torch.profiler, 3 prefills after a profiled warm-up
    wall, busy, top, _ = trace_device(
        torch, [lambda: server.prefill(prompts)] * 4)
    prefill_profile = dict(traced_wall_ms=wall / 3 * 1e3,
                           device_busy_ms=busy / 3 * 1e3,
                           idle_share=1.0 - busy / wall, top=top[:6])
    emit("lm_full", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
         params=cfg.param_count(), batch=FULL_B, prompt=FULL_PROMPT,
         gen=FULL_GEN, max_len=FULL_PROMPT + FULL_GEN, init_s=init_s,
         prefill_s=prefill_s, replay_s=replay_s,
         replay_ms_per_step=replay_s / FULL_PROMPT * 1e3,
         decode_ms_per_token=decode_s / FULL_GEN * 1e3,
         generate_s=generate_s, tok_per_s=FULL_B * FULL_GEN / generate_s,
         max_memory_allocated=peak,
         flash_attention_launches=launches.get("flash_attention", 0),
         tensor_core_launches=launches.get("flash_attention:tc", 0),
         kernel_ms=kernel_ms,
         kernel_share_of_prefill=kernel_ms * cfg.n_layers / 1e3 / prefill_s,
         prefill_profile=prefill_profile,
         prefill_vs_replay_agree=agree, top2_gaps=gaps,
         top_logit_bf16_steps=steps,
         tokens=out1[0, :8].tolist(), launches=launches)
    return launches


# ------------------------------------------------------------ LM training ----

#: train_4k's sequence (`configs/_lm_common.lm_shapes`) with its global
#: batch of 256 cut to what one card's step takes: 4 for Qwen1.5-0.5B, 2
#: for moonshot at full width cut to 2 layers.  Qwen's two loops take 6
#: steps with a checkpoint every 3; run B's step 4 fails until its two
#: retries are used up, and the loop restores step 3's checkpoint
TRAIN_S, QWEN_B, QWEN_STEPS, QWEN_SAVE_EVERY, QWEN_FAULT_STEP = (
    4096, 4, 6, 3, 4)
MOON_B, MOON_STEPS, MOON_LAYERS = 2, 2, 2
MOON_PROMPT, MOON_GEN = 512, 8
#: examples_torch/train_lm.py's run of its ~100M member of the qwen
#: family (`register_100m` holds the config): 200 steps of 8 x 256, a
#: checkpoint every 50
Q100M_STEPS, Q100M_B, Q100M_S, Q100M_SAVE = 200, 8, 256, 50


def instrument(torch, loop, record: dict) -> None:
    """Wrap a `TrainLoop`'s step, batch source and checkpoint manager so
    that ``record`` gets, for each call of the step, its flash_attention
    launches (all and tensor-core), its flash_attention_bwd launches and
    the MoE choices routed and dropped
    (`moe.route`'s obs counters; 0 while obs is off); the host clock at
    each batch call; each checkpoint's step, seconds (from a device sync)
    and bytes on disk, and each restore's seconds."""
    from repro_torch import obs
    from repro_torch.kernels import ops

    record.update(calls=[], batches=[], saves=[], loads=[])
    step_fn, batch_fn, m = loop.step_fn, loop.batch_fn, loop.manager

    def routed():
        return (obs.counter("moe.choices").value,
                obs.counter("moe.dropped").value)

    def step(state, batch):
        before, moe0 = ops.launch_counts(), routed()
        out = step_fn(state, batch)
        after = ops.launch_counts()
        record["calls"].append(dict(
            launches=after.get("flash_attention", 0)
            - before.get("flash_attention", 0),
            tc=after.get("flash_attention:tc", 0)
            - before.get("flash_attention:tc", 0),
            bwd=after.get("flash_attention_bwd", 0)
            - before.get("flash_attention_bwd", 0),
            routed=[a - b for a, b in zip(routed(), moe0)]))
        return out

    def batch(s):
        record["batches"].append((s, time.perf_counter()))
        return batch_fn(s)

    loop.step_fn, loop.batch_fn = step, batch

    def saver(fn):
        def save(s, tree):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = fn(s, tree)
            if path is not None:
                record["saves"].append(dict(
                    step=s, s=time.perf_counter() - t,
                    bytes=os.path.getsize(path)))
            return path
        return save

    restore = m.restore_or_init

    def restore_or_init(init_fn):
        t = time.perf_counter()
        out = restore(init_fn)
        record["loads"].append(dict(step=out[0],
                                    s=time.perf_counter() - t))
        return out

    m.maybe_save, m.save = saver(m.maybe_save), saver(m.save)
    m.restore_or_init = restore_or_init


class NoCheckpoints:
    """A `TrainLoop` manager that writes nothing: moonshot's state at full
    width (~18 GB with its moments) is not written inside the time
    limit."""

    def maybe_save(self, step, tree):
        return None

    def save(self, step, tree):
        return None

    def restore_or_init(self, init_fn):
        return 0, init_fn()


def loop_steps(loop, record) -> dict:
    """The loop's history as the phase reports it: per step the loss,
    gradient norm, ms (`TrainLoop`'s device-synced step time), retries
    and restore; per step call (replays too) the launches."""
    return dict(losses=[float(r.metrics["loss"]) for r in loop.history],
                grad_norms=[float(r.metrics["grad_norm"])
                            for r in loop.history],
                step_ms=[r.step_time * 1e3 for r in loop.history],
                retried=[r.retried for r in loop.history],
                restored=[r.restored for r in loop.history],
                launches_per_call=[c["launches"] for c in record["calls"]],
                bwd_launches_per_call=[c["bwd"] for c in record["calls"]],
                saves=record["saves"],
                loads=[x for x in record["loads"] if x["step"]])


def same_bits(torch, a, b, what: str) -> int:
    """Check every leaf of ``a`` equal to ``b``'s bit for bit (same dtype
    and device); the number of leaves."""
    from repro_torch.models.transformer import tree_leaves

    leaves = tree_leaves(a)
    check(len(leaves) == len(tree_leaves(b)), f"{what}: leaf counts")
    for path, leaf in leaves:
        other = b
        for k in path:
            other = other[k]
        check(leaf.dtype == other.dtype and leaf.device == other.device,
              f"{what}: {path} {leaf.dtype}/{leaf.device} against "
              f"{other.dtype}/{other.device}")
        check(bool(torch.equal(leaf, other)), f"{what}: {path} differs")
    return len(leaves)


def qwen_loops(torch, cfg, root: str) -> tuple:
    """Run A (6 steps, a checkpoint every 3) and run B (the same, its
    step 4 failing until the retries are used up, then restored from step
    3's checkpoint and replayed) of `launch.train.lm_loop` on ``cfg``:
    B's final params, moments and step bitwise A's.  -> (A's final state,
    A's loop, the report)."""
    from repro_torch.launch.train import lm_loop

    def make(name, inject=None):
        return lm_loop(cfg, steps=QWEN_STEPS, batch=QWEN_B, seq_len=TRAIN_S,
                       checkpoint_dir=os.path.join(root, name),
                       save_every=QWEN_SAVE_EVERY, device=DEV,
                       inject_fault=inject)

    rec_a, rec_b = {}, {}
    loop_a = make("a")
    instrument(torch, loop_a, rec_a)
    state_a = loop_a.run()
    faults = []

    def inject(step, retries):
        if step == QWEN_FAULT_STEP and len(faults) < 3:
            faults.append(time.perf_counter())
            return True
        return False

    loop_b = make("b", inject)
    instrument(torch, loop_b, rec_b)
    state_b = loop_b.run()
    torch.cuda.synchronize()
    check(loop_a.recoveries == 0 and loop_b.recoveries == 1,
          f"lm_train qwen: recoveries {loop_a.recoveries}, "
          f"{loop_b.recoveries}")
    check([r.restored for r in loop_b.history]
          == [s == QWEN_FAULT_STEP for s in range(QWEN_STEPS)],
          "lm_train qwen: run B's history does not mark the restore")
    leaves = same_bits(torch, state_b, state_a, "lm_train replay")
    back = min(t for s, t in rec_b["batches"]
               if s == QWEN_FAULT_STEP and t > faults[-1])
    a, b = loop_steps(loop_a, rec_a), loop_steps(loop_b, rec_b)
    check(b["losses"] == a["losses"], f"lm_train qwen: run B's losses "
          f"{b['losses']}, run A's {a['losses']}")
    check([x["step"] for x in b["loads"]] == [QWEN_SAVE_EVERY],
          f"lm_train qwen: run B restored {b['loads']}")
    files = sorted(os.listdir(os.path.join(root, "a")))
    del state_b, loop_b
    return state_a, loop_a, dict(
        run_a=a, run_b=b, replay_bitwise_leaves=leaves,
        recover_s=back - faults[-1], restore_load_s=b["loads"][0]["s"],
        files_a=files)


def index_add_repeats(torch, rows, ids, vocab: int,
                      repeats: int = 5) -> dict:
    """Whether ``index_add_`` (index_select's own backward) and
    `stable_segment_sum` give the same bits on every one of ``repeats``
    runs over the rows of a Zipf batch."""
    from repro_torch.sparse.segment import stable_segment_sum

    def runs(fn):
        first = fn()
        return sum(bool(torch.equal(fn(), first))
                   for _ in range(repeats - 1)) + 1

    def atomics():
        return torch.zeros((vocab,) + tuple(rows.shape[1:]),
                           dtype=rows.dtype, device=rows.device).index_add_(
            0, ids, rows)

    return dict(repeats=repeats,
                index_add_equal_runs=runs(atomics),
                stable_equal_runs=runs(lambda: stable_segment_sum(
                    rows, ids, vocab)),
                index_add_ms=time_cuda(torch, atomics, iters=5),
                stable_ms=time_cuda(torch, lambda: stable_segment_sum(
                    rows, ids, vocab), iters=5))


def elastic_check(torch, root: str, params_a) -> dict:
    """Run A's last checkpoint's params resharded onto a 2x2 mesh of the
    card (``embed``'s vocab axis split over ``data``, the rest
    replicated): every tile on its device with its block, gathered back
    bitwise A's final params."""
    import numpy as np

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.mesh import Mesh
    from repro_torch.runtime import ElasticPlan, gather_tree, reshard_tree

    t = time.perf_counter()
    step, tree = load_checkpoint(os.path.join(root, "a"))
    load_s = time.perf_counter() - t
    check(step == QWEN_STEPS, f"lm_train elastic: newest checkpoint {step}")
    mesh = Mesh([[DEV] * 2] * 2, ("data", "model"))
    plan = ElasticPlan(mesh, lambda path: (("data",) if path == ("embed",)
                                           else ()))
    out, reshard_s = timed(torch, lambda: reshard_tree(tree["params"], plan))
    del tree
    e = out["embed"]
    rows = e.shape[0] // 2
    for (i, j), tile in np.ndenumerate(e.tiles):
        check(tile.device == mesh.devices[i, j] and tuple(tile.shape)
              == (rows,) + e.shape[1:], f"lm_train elastic: tile {(i, j)}")
        check(bool(torch.equal(tile, params_a["embed"][rows * i:
                                                       rows * (i + 1)])),
              f"lm_train elastic: tile {(i, j)}'s block")
    tiles = 0
    for _, leaf in _leaf_items(out):
        for c, tile in np.ndenumerate(leaf.tiles):
            check(tile.device == mesh.devices[c],
                  f"lm_train elastic: a tile off its device")
            tiles += 1
    back, gather_s = timed(torch, lambda: gather_tree(out))
    leaves = same_bits(torch, back, params_a, "lm_train elastic")
    return dict(mesh="2x2", spec_embed=["data"], load_s=load_s,
                reshard_s=reshard_s, gather_s=gather_s, tiles=tiles,
                leaves=leaves, embed_tile_rows=rows, bitwise=True)


def compression_check(torch, cfg, params, batch) -> dict:
    """`compress_with_feedback` over one full-width gradient tree (one
    `lm_value_and_grad`) on the card, timed; its q, scale and residual
    on the embedding's and layer 0's gradients bitwise the same call on
    their CPU copies."""
    from repro_torch.models.transformer import lm_value_and_grad
    from repro_torch.runtime import (compress_with_feedback,
                                     init_error_feedback)

    _, grads = lm_value_and_grad(params, cfg, *batch)
    ef = init_error_feedback(grads)
    n = sum(g.numel() for _, g in _leaf_items(grads))
    ms = time_cuda(torch, lambda: compress_with_feedback(grads, ef),
                   warmup=1, iters=3)
    # read the gradient and the residual, write q and the new residual
    nbytes = sum(g.numel() * (g.element_size() + 4 + 1 + 4)
                 for _, g in _leaf_items(grads))
    sub = {"embed": grads["embed"],
           "layer0": {k: v[0] for k, v in grads["layers"].items()}}
    host = {"embed": sub["embed"].cpu(),
            "layer0": {k: v.cpu() for k, v in sub["layer0"].items()}}
    got, gef = compress_with_feedback(sub, init_error_feedback(sub))
    want, wef = compress_with_feedback(host, init_error_feedback(host))
    checked = 0
    for (path, pair), (_, wpair) in zip(_leaf_items(got),
                                        _leaf_items(want)):
        check(bool(torch.equal(pair[0].cpu(), wpair[0])) and bool(
            torch.equal(pair[1].cpu().view(torch.int32),
                        wpair[1].view(torch.int32))),
              f"lm_train compression: {path} q or scale differ from cpu")
        checked += pair[0].numel()
    for (path, r), (_, wr) in zip(_leaf_items(gef["residual"]),
                                  _leaf_items(wef["residual"])):
        check(bool(torch.equal(r.cpu().view(torch.int32),
                               wr.view(torch.int32))),
              f"lm_train compression: {path} residual differs from cpu")
    del grads, ef
    return dict(elements=n, ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", elements_checked_on_cpu=checked,
                bitwise=True)


def _leaf_items(tree, path=()):
    """``(path, leaf)`` of nested dicts in sorted key order (a ``(q,
    scale)`` pair, a `ShardedLeaf`, is a leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], path + (k,))
    else:
        yield path, tree


def qwen_100m(torch, root: str) -> dict:
    """examples_torch/train_lm.py's default run on the card: ``qwen-100m``
    registered by the example's `register_100m`, `train_lm` for 200 steps
    of 8 x 256 with a checkpoint every 50; the mean of the last 10 losses
    below the first 10's; the f32 attention kernels' launches over the
    run and a step.  (The examples phase runs the example's ``--tiny``,
    so these 200 steps run once a smoke.)"""
    import contextlib

    import numpy as np

    from examples_torch.train_lm import register_100m
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_lm

    with contextlib.redirect_stdout(sys.stderr):
        cfg = register_100m().config
    d = os.path.join(root, "qwen-100m")
    before = ops.launch_counts()
    t = time.perf_counter()
    _, losses, loop = train_lm("qwen-100m", smoke=True, steps=Q100M_STEPS,
                               batch=Q100M_B, seq_len=Q100M_S,
                               checkpoint_dir=d, save_every=Q100M_SAVE,
                               log=lambda *a: None, device=DEV)
    total_s = time.perf_counter() - t
    launches = {key: n - before.get(key, 0)
                for key, n in ops.launch_counts().items()
                if key in ("flash_attention:simt", "flash_attention_bwd:simt")}
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(all(math.isfinite(x) for x in losses) and last < first,
          f"lm_train qwen-100m: first-10 mean {first}, last-10 {last}")
    ms = sorted(r.step_time * 1e3 for r in loop.history)
    files = sorted(os.listdir(d))
    return dict(params=cfg.param_count(), dtype=cfg.dtype, steps=len(losses),
                batch=Q100M_B, seq=Q100M_S, first10_mean=first,
                last10_mean=last, losses_every_10=losses[::10],
                step_ms_median=ms[len(ms) // 2], step_ms_max=ms[-1],
                total_s=total_s, files=files, attention_launches=launches,
                attention_launches_per_step={
                    key: n / len(losses) for key, n in launches.items()},
                checkpoint_bytes=os.path.getsize(
                    os.path.join(d, files[-1])))


#: the backward's shapes, (name, B, Hq, Hkv, S, D, window, dtype): one
#: Qwen1.5-0.5B layer at the training shape (QWEN_B x 16 heads x TRAIN_S
#: x 64), which attention_grad_check runs; then grok-1's heads (48:8, D
#: 128) and h2o-danube-3's (32:8, D 120, its window of 4,096 inside S) at
#: a small B, and qwen-100m's training shape in f32 (examples/train_lm.py:
#: 8 x 256, 8 heads of 64), which attention_bwd_shapes runs
ATTN_BWD_TRAIN = ("qwen", QWEN_B, 16, 16, TRAIN_S, 64, 0, "bfloat16")
ATTN_BWD_SHAPES = (("grok", 1, 48, 8, 2048, 128, 0, "bfloat16"),
                   ("danube", 1, 32, 8, 6144, 120, 4096, "bfloat16"),
                   ("qwen-100m", 8, 8, 8, 256, 64, 0, "float32"))
#: the f32 backward's timed shapes, (name, B, Hq, Hkv, S, D, window):
#: ATTN_F32_TIMED's (the serving prefill, Qwen's 8k prefill, qwen-100m's
#: training shape) and Danube's attention with its window (danube_8k of
#: ATTN_TIMED), which attention_bwd_f32_rows runs
ATTN_BWD_F32_TIMED = ATTN_F32_TIMED + tuple(
    row for row in ATTN_TIMED if row[0] == "danube_8k")


def attention_bwd_bound(B, Hq, Hkv, S, D, window, f32: bool = False):
    """(bound ms at the gradient's 10 D flops a pair, bound_by, the same
    at the design's flops, bytes): q, k, v, dO and lse read once, dq, dk,
    dv written once (delta and the dQ sums one pass hands the next are
    scratch, not counted); bf16 at the tensor-core rate and the
    tensor-core design's 16 D at D <= 64 (delta's S and dP, then S, dP,
    dV with P in two parts, dK and dQ) or 22 D above it (the dQ pass's
    two walks, dK with dS in two parts), f32 at the f32 rate outside the
    tensor cores and 14 D (the SIMT design: the dQ pass's S, dP and dQ
    in one walk, delta from the f32 output; the dK/dV pass's S, dP, dV
    and dK)."""
    from repro_torch.kernels import flash_attention as fa

    pairs = B * Hq * fa.admitted_pairs(S, S, window=window)
    nbytes = (4 if f32 else 2) * D * (3 * B * Hq * S + 4 * B * Hkv * S) \
        + 4 * B * Hq * S
    rate = ALU_OPS_PER_S if f32 else BF16_FLOPS_PER_S
    b_ms, by = bound(nbytes, 10 * D * pairs, rate)
    design = 14 if f32 else 16 if D <= 64 else 22
    design_ms, _ = bound(nbytes, design * D * pairs, rate)
    return b_ms, by, design_ms, nbytes


def attention_bwd_yardsticks(torch, q, k, v, dout, window: int):
    """``(plain ms, library ms)`` of one causal attention backward on
    these inputs: flash_attention_backward_plain, and SDPA's backward
    alone (a yardstick, never called by the port: GQA without a repeat,
    a window as a boolean mask, f32 in f32)."""
    from repro_torch.kernels import flash_attention as fa

    plain_ms = time_cuda(torch, lambda: fa.flash_attention_backward_plain(
        q, k, v, dout, window=window), warmup=1, iters=3)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = sdpa(torch, qg, kg, vg, window)()
    library_ms = time_cuda(torch, lambda: torch.autograd.grad(
        o, (qg, kg, vg), dout, retain_graph=True), warmup=1, iters=5)
    return plain_ms, library_ms


def attention_bwd_shapes(torch) -> dict:
    """dq, dk, dv of the backward kernels at ATTN_BWD_SHAPES against the
    plain backward on f32 copies (ATTN_TOL), one backward launch each,
    and the ms there of the kernels and of attention_bwd_yardsticks."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEV).manual_seed(6)
    out = {}
    for name, B, Hq, Hkv, S, D, window, dtype_name in ATTN_BWD_SHAPES:
        dtype = getattr(torch, dtype_name)
        q, k, v = attention_inputs(torch, gen, B, Hq, Hkv, S, S, D, dtype)
        dout = torch.randn(q.shape, generator=gen, device=DEV).to(dtype)
        ops.reset_launches()
        o, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)
        # the f32 backward takes delta from the forward's output
        extra = {"out": o} if dtype == torch.float32 else {}
        got = fa.flash_attention_backward_cuda(q, k, v, lse, dout,
                                               window=window, **extra)
        launches = ops.launch_counts()
        check(launches.get("flash_attention_bwd", 0) == 1
              and launches.get(f"flash_attention_bwd:{fa.design(q, k, v)}",
                               0) == 1,
              f"flash_attention_bwd {name}: launches {launches}")
        want = fa.flash_attention_backward_plain(
            q.float(), k.float(), v.float(), dout.float(), window=window)
        errs = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dtype, f"flash_attention_bwd {name}: {g_name} "
                  f"{g.dtype}")
            errs[g_name] = attention_err(torch, g, w, dtype_name,
                                         f"backward {name} {g_name}")
        del got, want
        ms = time_cuda(torch, lambda: fa.flash_attention_backward_cuda(
            q, k, v, lse, dout, window=window, **extra), warmup=1, iters=5)
        plain_ms, library_ms = attention_bwd_yardsticks(torch, q, k, v,
                                                        dout, window)
        b_ms, by, design_ms, _ = attention_bwd_bound(
            B, Hq, Hkv, S, D, window, f32=dtype == torch.float32)
        out[name] = dict(shape=[B, Hq, Hkv, S, D], window=window,
                         dtype=dtype_name, impl=fa.design(q, k, v), ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         max_abs_err={n: e[0] for n, e in errs.items()},
                         rel_err={n: e[1] for n, e in errs.items()},
                         bound_ms=b_ms, bound_by=by,
                         design_bound_ms=design_ms)
        del q, k, v, dout, lse, o, extra
        torch.cuda.empty_cache()
    return out


def attention_bwd_f32_rows(torch) -> dict:
    """The SIMT backward at ATTN_BWD_F32_TIMED, from the f32 forward's
    logsumexp and output: dq, dk, dv against the plain backward
    (ATTN_TOL), two calls bitwise; its ms (CUDA events, 3 calls above S
    2,048) and its device ms with no host launch cost (`graph_ms`: the
    calls in a CUDA graph; the profiler records no kernels this late in
    a whole run, see fm_profile_phase), beside the bound at the
    gradient's 10 D and the design's 14 D, the plain backward's ms and
    SDPA's f32 backward alone (attention_bwd_yardsticks); each pass's
    device ms: scripts/attention_bwd_probe.py --f32-backward."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(9)
    out = {}
    for name, B, Hq, Hkv, S, D, window in ATTN_BWD_F32_TIMED:
        q, k, v = attention_inputs(torch, gen, B, Hq, Hkv, S, S, D,
                                   torch.float32)
        dout = torch.randn(q.shape, generator=gen, device=DEV)
        o, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)

        def call():
            return fa.flash_attention_backward_cuda(q, k, v, lse, dout,
                                                    window=window, out=o)

        got = call()
        want = fa.flash_attention_backward_plain(q, k, v, dout,
                                                 window=window)
        errs = {g_name: attention_err(torch, g, w, "float32",
                                      f"backward f32 {name} {g_name}")
                for g_name, g, w in zip(("dq", "dk", "dv"), got, want)}
        check(all(bool(torch.equal(a, b)) for a, b in zip(got, call())),
              f"flash_attention_bwd f32 {name}: two calls differ")
        del got, want
        big = S > 2048
        ms = time_cuda(torch, call, warmup=1, iters=3 if big else 10)
        graph_ms = time_graph(torch, call, iters=3 if big else 20, replays=2)
        plain_ms, library_ms = attention_bwd_yardsticks(torch, q, k, v,
                                                        dout, window)
        b_ms, by, design_ms, nbytes = attention_bwd_bound(
            B, Hq, Hkv, S, D, window, f32=True)
        out[name] = dict(shape=[B, Hq, Hkv, S, D], window=window,
                         impl="simt", ms=ms, graph_ms=graph_ms,
                         plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=b_ms, bound_by=by,
                         design_bound_ms=design_ms, bytes=nbytes,
                         bound_share=b_ms / ms, design_share=design_ms / ms,
                         vs_sdpa=ms / library_ms,
                         max_abs_err={n: e[0] for n, e in errs.items()},
                         rel_err={n: e[1] for n, e in errs.items()},
                         bitwise_twice=True)
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    return out


def attention_grad_check(torch, B, H, S, D) -> dict:
    """One full-width layer's attention in bf16 at the training shape:
    the output and dq, dk, dv through FlashAttention against the plain
    version and its autograd on f32 copies (ATTN_TOL's bf16 bound on
    ``|err| / (1 + |ref|)``); the backward kernels' ms (the backward
    alone, from a saved logsumexp) beside the plain backward's, SDPA's
    forward + backward and its backward alone (a yardstick, never called
    by the port), with the bound at the gradient's 10 D flops a pair and
    at the design's 16 D; the backward at ATTN_BWD_SHAPES and the f32
    backward at ATTN_BWD_F32_TIMED.  -> the kernel table's row of
    flash_attention_bwd and the phase's record."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(5)
    q, k, v = attention_inputs(torch, gen, B, H, H, S, S, D, torch.bfloat16)
    dout = torch.randn(q.shape, generator=gen, device=DEV).to(torch.bfloat16)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.FlashAttention.apply(qg, kg, vg, True, 0)
    got = torch.autograd.grad(out, (qg, kg, vg), dout)
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    plain = fa.flash_attention_plain(q32, k32, v32)
    errs = {"out": attention_err(torch, out.detach(), plain.detach(),
                                 "bfloat16", f"forward at {B}x{H}x{S}x{D}")}
    want = torch.autograd.grad(plain, (q32, k32, v32), dout.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.dtype == torch.bfloat16, f"lm_train {name} dtype {g.dtype}")
        errs[name] = attention_err(torch, g, w, "bfloat16",
                                   f"backward {name}")
    del want, plain, out, got, q32, k32, v32
    torch.cuda.empty_cache()
    _, lse = fa.forward_cuda(q, k, v, with_lse=True)
    twice = [fa.flash_attention_backward_cuda(q, k, v, lse, dout)
             for _ in range(2)]
    same = all(bool(torch.equal(a, b)) for a, b in zip(*twice))
    check(same, "flash_attention_bwd: two calls differ")
    del twice
    fwd_ms = time_cuda(torch, lambda: fa.flash_attention_cuda(q, k, v),
                       iters=5)
    bwd_ms = time_cuda(torch, lambda: fa.flash_attention_backward_cuda(
        q, k, v, lse, dout), iters=10)
    plain_ms, sdpa_bwd_ms = attention_bwd_yardsticks(torch, q, k, v, dout, 0)

    def fused():
        o = fa.FlashAttention.apply(qg, kg, vg, True, 0)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    both_ms = time_cuda(torch, fused, warmup=1, iters=5)
    lib = sdpa(torch, qg, kg, vg, 0)
    sdpa_fwd_ms = time_cuda(torch, lib, iters=5)
    sdpa_ms = time_cuda(torch, lambda: torch.autograd.grad(
        lib(), (qg, kg, vg), dout), warmup=1, iters=5)
    flops, nbytes, bound_ms, by = attention_bound(B, H, H, S, S, D, 0)
    b_ms, b_by, design_ms, bwd_bytes = attention_bwd_bound(B, H, H, S, D, 0)
    shapes = attention_bwd_shapes(torch)
    f32_rows = attention_bwd_f32_rows(torch)
    row = dict(route="cuda", source="src/repro_torch/kernels/csrc/"
               "flash_attention_bwd_tc.cu", replaces="src/repro/kernels/"
               "flash_attention.py:72",
               max_abs_err=max(errs[n][0] for n in ("dq", "dk", "dv")),
               ms=bwd_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=sdpa_bwd_ms, design_bound_ms=design_ms,
               shape=[B, H, S, D])
    record = dict(shape=[B, H, S, D],
                  max_abs_err={n: e[0] for n, e in errs.items()},
                  rel_err={n: e[1] for n, e in errs.items()},
                  tol=ATTN_TOL["bfloat16"], kernel_fwd_ms=fwd_ms,
                  kernel_bwd_ms=bwd_ms, plain_bwd_ms=plain_ms,
                  fwd_plus_bwd_ms=both_ms, sdpa_fwd_ms=sdpa_fwd_ms,
                  sdpa_fwd_bwd_ms=sdpa_ms, sdpa_bwd_ms=sdpa_bwd_ms,
                  fwd_bound_ms=bound_ms, fwd_bound_by=by,
                  bwd_bound_ms=b_ms, bwd_bound_by=b_by,
                  bwd_design_bound_ms=design_ms, bwd_bytes=bwd_bytes,
                  bwd_share_of_bound=b_ms / bwd_ms, bwd_vs_sdpa=bwd_ms
                  / sdpa_bwd_ms, bwd_bitwise_twice=same,
                  other_shapes=shapes, f32_timed=f32_rows)
    return row, record


def lm_train_phase(torch) -> dict:
    """Full-width Qwen1.5-0.5B trained through `launch.train.make_step`
    in two `TrainLoop`s (run B restored from a checkpoint and replayed,
    bitwise run A), one more step traced, run A's checkpoint resharded on
    a 2x2 mesh, a gradient tree compressed, one layer's attention at the
    training shape against the plain path, ``qwen-100m``'s example run,
    then moonshot at full width cut to two layers trained in a loop (its
    drops counted by the steps' own routings) and served; returns the
    launch counts of Qwen's two loops (the phase's main path)."""
    import shutil
    import tempfile

    from repro_torch import obs, prng
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMServer
    from repro_torch.launch.train import lm_loop
    from repro_torch.models import moe

    cfg = get_arch("qwen1.5-0.5b").config
    check(cfg.remat, "lm_train: Qwen's config has remat off")
    root = tempfile.mkdtemp(prefix="lm_train_")
    try:
        disk = shutil.disk_usage(root)
        # A's two checkpoints live while B holds two and writes a third
        state_bytes = cfg.param_count() * (2 + 4 + 4)
        need = 5 * state_bytes
        check(disk.free >= need,
              f"lm_train: the checkpoints need {need:,} bytes; the disk "
              f"under {root} has {disk.free:,} free of {disk.total:,}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        state_a, loop_a, runs = qwen_loops(torch, cfg, root)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = 2 * cfg.n_layers
        calls = runs["run_a"]["launches_per_call"] + \
            runs["run_b"]["launches_per_call"]
        check(all(n == want for n in calls),
              f"lm_train qwen: flash_attention launches a step {calls}, "
              f"predicted {want} (a forward and a recompute a layer)")
        check(counts.get("flash_attention:tc", 0)
              == counts.get("flash_attention", 0) == want * len(calls),
              f"lm_train qwen: a launch went past the tensor-core kernel "
              f"({counts})")
        bwd_calls = runs["run_a"]["bwd_launches_per_call"] + \
            runs["run_b"]["bwd_launches_per_call"]
        check(all(n == cfg.n_layers for n in bwd_calls)
              and counts.get("flash_attention_bwd:tc", 0)
              == counts.get("flash_attention_bwd", 0)
              == cfg.n_layers * len(calls),
              f"lm_train qwen: flash_attention_bwd launches a step "
              f"{bwd_calls}, predicted {cfg.n_layers} (one a layer), all "
              f"on the tensor-core kernel ({counts})")
        losses = runs["run_a"]["losses"]
        check(all(math.isfinite(x) for x in losses) and losses[-1]
              < losses[0], f"lm_train qwen: loss {losses} did not fall")
        # one more step, traced (a warm-up and the traced one), on run A's
        # last batch; its result is dropped
        batch = loop_a.batch_fn(QWEN_STEPS - 1)
        wall, busy, top, inside = trace_device(
            torch, [lambda: loop_a.step_fn(state_a, batch)] * 2,
            within=("FlashAttentionBackward",))
        bwd = inside["FlashAttentionBackward"]
        profile = dict(traced_wall_ms=wall * 1e3, device_busy_ms=busy * 1e3,
                       idle_share=1.0 - busy / wall,
                       attention_backward_device_ms=bwd * 1e3,
                       attention_backward_share=bwd / busy, top=top[:8])
        torch.cuda.empty_cache()
        ids = batch[0].reshape(-1)
        rows = torch.randn((ids.numel(), cfg.d_model), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(
                               4)).to(torch.bfloat16)
        atomics = index_add_repeats(torch, rows, ids, cfg.vocab)
        top_share = float(torch.bincount(ids).max()) / ids.numel()
        del rows
        elastic = elastic_check(torch, root, state_a["params"])
        torch.cuda.empty_cache()
        compression = compression_check(torch, cfg, state_a["params"], batch)
        del state_a, loop_a, batch, ids
        torch.cuda.empty_cache()
        q100m = qwen_100m(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    # one layer's attention at the training shape (4 x 16 x 4,096 x 64)
    _, B, H, _, S, D, _, _ = ATTN_BWD_TRAIN
    check((B, H, S, D) == (QWEN_B, cfg.n_heads, TRAIN_S, cfg.head_dim),
          f"ATTN_BWD_TRAIN {ATTN_BWD_TRAIN} is not {cfg.name}'s shape")
    bwd_row, attn = attention_grad_check(torch, B, H, S, D)
    torch.cuda.empty_cache()
    emit("lm_train", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
         params=cfg.param_count(), batch=QWEN_B, seq=TRAIN_S,
         remat=cfg.remat, steps=QWEN_STEPS, save_every=QWEN_SAVE_EVERY,
         fault_step=QWEN_FAULT_STEP, disk_free=disk.free,
         disk_total=disk.total, max_memory_allocated=peak,
         flash_attention_launches=counts.get("flash_attention", 0),
         flash_attention_bwd_launches=counts.get("flash_attention_bwd", 0),
         predicted_launches_per_step=want, **runs,
         zipf_top_token_share=top_share, embed_grad_repeats=atomics,
         step_profile=profile, elastic=elastic, compression=compression,
         qwen_100m=q100m,
         layer_attention_fwd_ms=attn["kernel_fwd_ms"],
         layer_attention_bwd_ms=attn["kernel_bwd_ms"],
         layer_attention_plain_bwd_ms=attn["plain_bwd_ms"],
         attention_grad=attn)

    # moonshot-v1-16b-a3b at full width, depth cut to 2 layers
    mcfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").config,
                               n_layers=MOON_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(8)
    q, k, v = attention_inputs(torch, gen, MOON_B, mcfg.n_heads,
                               mcfg.n_kv_heads, TRAIN_S, TRAIN_S,
                               mcfg.head_dim, torch.bfloat16)
    hd_err = attention_err(torch, fa.flash_attention_cuda(q, k, v),
                           fa.flash_attention_plain(q, k, v), "bfloat16",
                           f"head dim {mcfg.head_dim}")
    del q, k, v
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mloop = lm_loop(mcfg, steps=MOON_STEPS, batch=MOON_B, seq_len=TRAIN_S,
                    checkpoint_dir="", save_every=MOON_STEPS, device=DEV)
    mloop.manager = NoCheckpoints()
    mrec = {}
    instrument(torch, mloop, mrec)
    T = MOON_B * TRAIN_S
    C = moe.capacity(mcfg.capacity_factor, mcfg.top_k, T, mcfg.n_experts)
    # the steps count their own routings (a sync each, 4 a step: two
    # layers, forward and recompute)
    obs.reset()
    obs.enable()
    try:
        mstate = mloop.run()
        capacity = obs.gauge("moe.capacity")
        seen_c = (capacity.value, capacity.max)
    finally:
        obs.reset()
    mpeak = torch.cuda.max_memory_allocated()
    mlaunches = [c["launches"] for c in mrec["calls"]]
    check(len(mlaunches) == MOON_STEPS
          and all(n == 2 * MOON_LAYERS for n in mlaunches),
          f"lm_train moonshot: launches a step {mlaunches}")
    check(seen_c == (C, C), f"lm_train moonshot: capacities {seen_c}, "
          f"want {C}")
    routings = 2 * MOON_LAYERS * T * mcfg.top_k
    routed = [c["routed"] for c in mrec["calls"]]
    check(all(n == routings for n, _ in routed),
          f"lm_train moonshot: choices routed a step {routed}, want "
          f"{routings} (two layers, forward and recompute)")
    drops = [dict(choices=n, dropped=d, drop_share=d / n) for n, d in routed]
    mlosses = [float(r.metrics["loss"]) for r in mloop.history]
    check(all(math.isfinite(x) for x in mlosses),
          f"lm_train moonshot: losses {mlosses}")
    mparams = mstate["params"]
    mstep_ms = [r.step_time * 1e3 for r in mloop.history]
    del mstate, mloop
    torch.cuda.empty_cache()
    server = LMServer(mcfg, mparams, max_len=MOON_PROMPT + MOON_GEN,
                      device=DEV)
    prompts = prng.randint(prng.PRNGKey(10), (4, MOON_PROMPT), 0,
                           mcfg.vocab, device=DEV)
    with torch.no_grad():
        (logits, _), prefill_s = timed(torch, lambda: server.prefill(prompts))
        ops.reset_launches()
        gen1, generate_s = timed(torch, lambda: server.generate(prompts,
                                                                MOON_GEN))
        serve_launches = ops.launch_counts().get("flash_attention", 0)
        _, cache = server.seed_cache(prompts)
        first = torch.argmax(logits, dim=-1)[:, None].to(prompts.dtype)
        _, decode_s = timed(torch, lambda: server.decode(cache, first,
                                                         MOON_GEN))
        gen2 = server.generate(prompts, MOON_GEN)
    check(bool(torch.isfinite(logits.float()).all()),
          "lm_train moonshot: prefill logits")
    check(tuple(gen1.shape) == (4, MOON_GEN) and bool(
        ((gen1 >= 0) & (gen1 < mcfg.vocab)).all()),
          "lm_train moonshot: generated ids")
    check(torch.equal(gen1, gen2), "lm_train moonshot: a second generate "
          "differs")
    check(serve_launches == MOON_LAYERS,
          f"lm_train moonshot: {serve_launches} launches in a generate")
    emit("lm_train_moe", arch=mcfg.name, n_layers=mcfg.n_layers,
         published_layers=get_arch("moonshot-v1-16b-a3b").config.n_layers,
         d_model=mcfg.d_model, experts=mcfg.n_experts, top_k=mcfg.top_k,
         vocab=mcfg.vocab, params=mcfg.param_count(),
         active_params=mcfg.active_param_count(), batch=MOON_B,
         seq=TRAIN_S, capacity=C, drops_per_step=drops,
         losses=mlosses,
         step_ms=mstep_ms,
         max_memory_allocated=mpeak,
         flash_attention_launches_per_step=mlaunches,
         head_dim_check=dict(head_dim=mcfg.head_dim, max_abs_err=hd_err[0],
                             rel_err=hd_err[1]),
         serve_prompts=4, serve_prompt=MOON_PROMPT, serve_gen=MOON_GEN,
         prefill_ms=prefill_s * 1e3,
         decode_ms_per_token=decode_s / MOON_GEN * 1e3,
         generate_s=generate_s, tokens=gen1[0].tolist())
    return {k: counts.get(k, 0) for k in (
        "flash_attention", "flash_attention:tc", "flash_attention_bwd",
        "flash_attention_bwd:tc")}, bwd_row


# ---------------------------------------------------------------- FM ----

#: FM tolerances, cuda vs cpu (the CPU tests hold the port to JAX by the
#: same bounds): a logit or score within FM_REL * (mag + sum of the
#: linear terms' magnitudes); the loss within 1e-6; a gradient within
#: 1e-5 |cpu| + 1e-6 max |cpu| (index_add_ sums repeated rows in another
#: order on the card); parameters and moments after the AdamW steps within
#: 1e-4 |cpu| + 1e-5, as the CPU tests hold 60 steps against JAX
FM_REL, FM_PARITY_B, FM_PARITY_STEPS = 4e-6, 256, 3


def fm_params(torch, cfg, gen, device):
    """``init_fm``'s table with ``w ~ N(0, 0.01)`` and ``b ~ N(0, 0.1)``
    drawn on ``gen`` too, so the linear term is held (init_fm zeros them)."""
    from repro_torch.models.recsys.fm import init_fm

    p = init_fm(cfg, generator=gen, device=device)
    p["w"] = (torch.randn(cfg.total_rows, generator=gen, device=gen.device)
              * 0.01).to(device)
    p["b"] = (torch.randn((), generator=gen, device=gen.device)
              * 0.1).to(device)
    return p


def fm_logit_scale(torch, params, cfg, idx):
    """``mag + sum |w| + |b|`` of each request (float64, on the host), the
    scale of a logit's rounding (``tests/test_torch_fm.py``)."""
    dev = params["v"].device
    rows = (idx.long().to(dev) + cfg.field_offsets(dev)[None]).reshape(-1)
    v = params["v"].index_select(0, rows).cpu().double().view(
        idx.shape[0], cfg.n_sparse, cfg.embed_dim)
    w = params["w"].index_select(0, rows).cpu().double().view(idx.shape[0],
                                                              -1)
    s = v.sum(1)
    mag = 0.5 * (s * s + (v * v).sum(1)).sum(-1)
    return mag + w.abs().sum(-1) + abs(float(params["b"]))


def fm_within(torch, got, want, scale, tag: str) -> float:
    err = (got.double().cpu() - want.double().cpu()).abs()
    check(bool(torch.isfinite(got).all()), f"{tag}: not finite")
    ratio = float((err / scale).max())
    check(ratio <= 1.0, f"{tag}: {ratio:.3g} of its tolerance")
    return float(err.max())


def fm_parity_phase(torch) -> dict:
    """SMOKE and a full-field config (39 x K 10, vocab 64) run on cuda and
    cpu from the same weights: the pair term and the serving logits (the
    fused route) bitwise, retrieval scores, loss and gradients within the
    FM tolerances, and three clipped AdamW steps within theirs; both FM
    kernels launched on cuda only; a batch with an id past the table and
    a candidate past it give NaN in the same places on both devices (the
    loss and the gradients too)."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import fm
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   clip_by_global_norm)

    phase_t0, out = time.perf_counter(), {}
    for cfg in (get_arch("fm").smoke_config,
                fm.FMConfig(name="fm-wide", n_sparse=39, embed_dim=10,
                            vocab_per_field=64)):
        host = fm_params(torch, cfg, torch.Generator().manual_seed(0), "cpu")
        idx = prng.randint(prng.PRNGKey(1), (FM_PARITY_B, cfg.n_sparse), 0,
                           cfg.vocab_per_field)
        labels = (prng.uniform(prng.PRNGKey(2), (FM_PARITY_B,)) < 0.5
                  ).to(torch.float32)
        cand = prng.randint(prng.PRNGKey(3), (1000,), 0, cfg.total_rows)
        # one id past the table (request 3) and one candidate row past it
        bad_idx, bad_cand = idx.clone(), cand.clone()
        bad_idx[3, 0] = cfg.total_rows
        bad_cand[5] = cfg.total_rows
        opt_cfg = AdamWConfig(lr=0.05)
        res = {}
        for dev in (DEV, "cpu"):
            p = {k: t.to(dev) for k, t in host.items()}
            i, y = idx.to(dev), labels.to(dev)
            rows = (i.long() + cfg.field_offsets(dev)[None]).reshape(-1)
            ops.reset_launches()
            with torch.no_grad():
                pair = ops.fm_interaction(p["v"].index_select(0, rows).view(
                    FM_PARITY_B, cfg.n_sparse, cfg.embed_dim))
                logits = fm.fm_logits(p, cfg, i)
                scores = fm.fm_retrieval_scores(p, cfg, i[0, :4],
                                                cand.to(dev))
                bad_logits = fm.fm_logits(p, cfg, bad_idx.to(dev))
                bad_scores = fm.fm_retrieval_scores(p, cfg, i[0, :4],
                                                    bad_cand.to(dev))
            bad_loss, bad_grads = fm.fm_value_and_grad(p, cfg,
                                                       bad_idx.to(dev), y)
            loss, grads = fm.fm_value_and_grad(p, cfg, i, y)
            opt = adamw_init(p, opt_cfg)
            for _ in range(FM_PARITY_STEPS):
                _, g = fm.fm_value_and_grad(p, cfg, i, y)
                g, _ = clip_by_global_norm(g, 1.0)
                p, opt = adamw_update(p, g, opt, opt_cfg)
            res[dev] = dict(
                pair=pair.cpu(), logits=logits.cpu(), scores=scores.cpu(),
                loss=float(loss), grads={k: t.cpu() for k, t in grads.items()},
                params={k: t.cpu() for k, t in p.items()},
                mu={k: t.cpu() for k, t in opt["mu"].items()},
                launches=ops.launch_counts().get("fm_interaction", 0),
                fused_launches=ops.launch_counts().get(
                    "fm_gather_interaction", 0),
                bad=dict(logits=bad_logits.cpu(), scores=bad_scores.cpu(),
                         loss=float(bad_loss),
                         **{f"grad_{k}": t.cpu()
                            for k, t in bad_grads.items()}))
        c, h = res[DEV], res["cpu"]
        check(c["launches"] > 0 and h["launches"] == 0,
              f"fm_parity {cfg.name}: fm_interaction launched "
              f"{c['launches']} (cuda) / {h['launches']} (cpu) times")
        # the serving route: 2 fm_logits and 2 retrieval constants
        check(c["fused_launches"] == 4 and h["fused_launches"] == 0,
              f"fm_parity {cfg.name}: fm_gather_interaction launched "
              f"{c['fused_launches']} (cuda) / {h['fused_launches']} (cpu) "
              f"times")
        fm_same_bits(torch, c["pair"], h["pair"],
                     f"fm_parity {cfg.name} pair")
        fm_same_bits(torch, c["logits"], h["logits"],
                     f"fm_parity {cfg.name} serving logits")
        fm_same_bits(torch, c["bad"]["logits"], h["bad"]["logits"],
                     f"fm_parity {cfg.name} serving logits, a bad id")
        scale = fm_logit_scale(torch, host, cfg, idx)
        logit_err = fm_within(torch, c["logits"], h["logits"], FM_REL * scale,
                              f"fm_parity {cfg.name} logits")
        # a score is the user's logit terms plus w_c and <su, v_c>
        user_cfg = dataclasses.replace(cfg, n_sparse=4)
        urows = idx[0, :4].long() + cfg.field_offsets()[:4]
        su = host["v"][urows].double().sum(0)
        sscale = (fm_logit_scale(torch, host, user_cfg, idx[:1, :4])[0]
                  + host["w"][cand.long()].double().abs()
                  + (host["v"][cand.long()].double() * su).abs().sum(-1))
        score_err = fm_within(torch, c["scores"], h["scores"],
                              FM_REL * sscale, f"fm_parity {cfg.name} scores")
        check(abs(c["loss"] - h["loss"]) <= 1e-6,
              f"fm_parity {cfg.name} loss {c['loss']} vs {h['loss']}")
        # the out-of-range batch: NaN in the same places on both devices,
        # the rest within the tolerances above
        cb, hb = c["bad"], h["bad"]
        check(math.isnan(cb["loss"]) and math.isnan(hb["loss"]),
              f"fm_parity {cfg.name}: loss with an id past the table "
              f"{cb['loss']} (cuda), {hb['loss']} (cpu)")
        check(torch.isnan(hb["logits"]).nonzero().flatten().tolist() == [3]
              and torch.isnan(hb["scores"]).nonzero().flatten().tolist()
              == [5], f"fm_parity {cfg.name}: NaN rows on the cpu")
        for key in ("logits", "scores", "grad_v", "grad_w", "grad_b"):
            check(torch.equal(torch.isnan(cb[key]), torch.isnan(hb[key])),
                  f"fm_parity {cfg.name}: NaN masks of {key} differ")
        ok = ~torch.isnan(hb["logits"])
        fm_within(torch, cb["logits"][ok], hb["logits"][ok],
                  FM_REL * scale[ok], f"fm_parity {cfg.name} bad logits")
        ok = ~torch.isnan(hb["scores"])
        fm_within(torch, cb["scores"][ok], hb["scores"][ok],
                  FM_REL * sscale[ok], f"fm_parity {cfg.name} bad scores")
        grad_err = {}
        for k in ("v", "w", "b"):
            want = h["grads"][k]
            grad_err[k] = fm_within(
                torch, c["grads"][k], want,
                1e-5 * want.double().abs() + 1e-6 * float(want.abs().max())
                + 1e-30, f"fm_parity {cfg.name} grad {k}")
        step_err = {}
        for part in ("params", "mu"):
            for k, want in h[part].items():
                step_err[f"{part}.{k}"] = fm_within(
                    torch, c[part][k], want, 1e-4 * want.double().abs()
                    + 1e-5, f"fm_parity {cfg.name} {part} {k} after "
                    f"{FM_PARITY_STEPS} steps")
        out[cfg.name] = dict(
            n_sparse=cfg.n_sparse, embed_dim=cfg.embed_dim,
            vocab=cfg.vocab_per_field, logits_max_abs_err=logit_err,
            scores_max_abs_err=score_err, loss=[c["loss"], h["loss"]],
            grad_max_abs_err=grad_err, step_max_abs_err=step_err,
            launches=c["launches"], fused_launches=c["fused_launches"])
    emit("fm_parity", batch=FM_PARITY_B, steps=FM_PARITY_STEPS,
         rel_tol=FM_REL, phase_s=time.perf_counter() - phase_t0, **out)
    return out


def serving_turn(torch, fn, idx99, idx_bulk) -> dict:
    """fm_full's serving batches on ``fn`` (2 + 50 at serve_p99, 1 + 5 at
    serve_bulk, host clock to a sync): medians, max, preds/s, and the peak
    memory allocated above what was allocated before."""
    import statistics

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(2):
            fn(idx99)
        p99 = [timed(torch, lambda: fn(idx99))[1] * 1e3 for _ in range(50)]
        fn(idx_bulk)
        bulk = [timed(torch, lambda: fn(idx_bulk))[1] * 1e3
                for _ in range(5)]
    peak = torch.cuda.max_memory_allocated()
    med99, med_bulk = statistics.median(p99), statistics.median(bulk)
    return dict(p99_median_ms=med99, p99_max_ms=max(p99),
                p99_preds_per_s=idx99.shape[0] / med99 * 1e3,
                bulk_median_ms=med_bulk,
                bulk_preds_per_s=idx_bulk.shape[0] / med_bulk * 1e3,
                max_memory_allocated=peak, above_base=peak - base)


def fm_full_phase(torch) -> dict:
    """The full-width FM (39 fields x 1,000,000 rows x K 10: a 39M x 10 f32
    table, 1.56 GB, drawn on the card from a seeded generator) served and
    trained: serve_p99 (512 requests, 50 timed batches), serve_bulk
    (262,144), retrieval_cand (4 user fields against the 1,000,000 rows of
    field 4, with the decomposition checked on the top 5) and train_batch
    (3 clipped AdamW steps at batch 65,536 on the click stream), with the
    launch counts set to 0 just before and read just after (every
    serving call one fm_gather_interaction launch, every training step
    one fm_interaction launch); then the serve_p99 logits held bitwise
    against the cpu plain version of the serving route and within
    FM_REL of the training route's chain, and the serving batches run
    again in turns on the unfused chain (`fm_unfused_chain`) and on the
    serving route, each turn's host times and peak memory beside."""
    import math
    import statistics

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_click_batches
    from repro_torch.kernels import fm_interaction as fmk
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import fm
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   clip_by_global_norm)

    phase_t0 = time.perf_counter()
    arch = get_arch("fm")
    cfg = arch.config
    dims = {k: s.dims for k, s in arch.shapes.items()}
    F, V, K = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    B99, Bbulk = dims["serve_p99"]["batch"], dims["serve_bulk"]["batch"]
    Btrain = dims["train_batch"]["batch"]
    C = dims["retrieval_cand"]["n_candidates"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = fm_params(torch, cfg, torch.Generator(device="cuda")
                       .manual_seed(0), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    idx99 = prng.randint(prng.PRNGKey(1), (B99, F), 0, V, device=DEV)
    idx_bulk = prng.randint(prng.PRNGKey(2), (Bbulk, F), 0, V, device=DEV)
    user = prng.randint(prng.PRNGKey(3), (4,), 0, V, device=DEV)
    cand = torch.arange(C, device=DEV) + 4 * V          # field 4's rows
    t0 = time.perf_counter()
    batches = [(torch.from_numpy(i).to(DEV), torch.from_numpy(y).to(DEV))
               for i, y in synthetic_click_batches(F, V, Btrain, 3)]
    data_s = time.perf_counter() - t0

    def serve(idx):
        return fm.fm_logits(params, cfg, idx)

    # the serve_p99 batch's rows (a table of B99 x F rows on the host,
    # read by ids 0.. in order) and the training route's logits, before
    # the counted window
    rows99 = (idx99.long() + cfg.field_offsets(DEV)[None]).reshape(-1)
    sub99 = {"v": params["v"].index_select(0, rows99).cpu(),
             "w": params["w"].index_select(0, rows99).cpu(),
             "b": params["b"].cpu()}
    chain99 = fm_unfused_chain(torch, params, V, idx99).cpu()

    # one launch per call: 2 + 50 + 1 + 5 serving batches, 1 + 10
    # retrieval calls and the decomposition check's batch on the fused
    # kernel, 3 steps on the unfused one
    ops.reset_launches()
    with torch.no_grad():
        for _ in range(2):
            serve(idx99)
        p99 = [timed(torch, lambda: serve(idx99)) for _ in range(50)]
        serve(idx_bulk)
        bulk = [timed(torch, lambda: serve(idx_bulk)) for _ in range(5)]
        fm.fm_retrieval_scores(params, cfg, user, cand)
        ret = [timed(torch, lambda: fm.fm_retrieval_scores(
            params, cfg, user, cand)) for _ in range(10)]
        scores = ret[-1][0]
        # score differences of the top 5 equal logit differences with the
        # candidate's field appended (fields 0-4 share the table's layout)
        top = torch.topk(scores, 5)
        full = fm.fm_logits(params, dataclasses.replace(cfg, n_sparse=5),
                            torch.cat([user.long().expand(5, 4),
                                       top.indices[:, None]], 1))
    serve_peak = torch.cuda.max_memory_allocated()
    # the out-of-range repair of the gathers (wrap, clamp, NaN fill) against
    # the bare index_selects it wraps: device time at serve_bulk, and host
    # time a call (each ending in a sync, the two taken in turns) at
    # serve_p99
    def bare(rows):
        return (params["v"].index_select(0, rows),
                params["w"].index_select(0, rows))

    rows_bulk = (idx_bulk.long() + cfg.field_offsets(DEV)[None]).reshape(-1)
    gather = dict(
        take_ms=time_cuda(torch, lambda: fm._gather(params, rows_bulk)),
        index_select_ms=time_cuda(torch, lambda: bare(rows_bulk)))
    gather["repair_ms"] = gather["take_ms"] - gather["index_select_ms"]
    del rows_bulk
    host = {"take": [], "index_select": []}
    for _ in range(200):
        for name, fn in (("take", lambda: fm._gather(params, rows99)),
                         ("index_select", lambda: bare(rows99))):
            host[name].append(timed(torch, fn)[1] * 1e6)
    gather.update({f"p99_{k}_us": statistics.median(v)
                   for k, v in host.items()})
    logits99 = p99[-1][0]
    v99 = sub99["v"].view(B99, F, K)
    want99 = fmk.fm_gather_interaction_plain(
        torch.arange(B99 * F).view(B99, F), 0, sub99["v"], sub99["w"],
        sub99["b"])
    scale99 = fm_logit_scale(torch, params, cfg, idx99)

    opt_cfg = AdamWConfig()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(params, opt_cfg)
    train = []
    for i, y in batches:
        def step():
            loss, grads = fm.fm_value_and_grad(params, cfg, i, y)
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            return loss, gnorm, adamw_update(params, grads, opt, opt_cfg)
        (loss, gnorm, (params, opt)), step_s = timed(torch, step)
        train.append(dict(ms=step_s * 1e3, loss=float(loss),
                          grad_norm=float(gnorm)))
    launches = ops.launch_counts()
    train_peak = torch.cuda.max_memory_allocated()
    del opt
    # the serving batches again, in turns: the unfused chain, the
    # serving route, the chain; host times and peak memory of each
    turns = {"unfused": [], "fused": []}
    for name in ("unfused", "fused", "unfused"):
        fn = (serve if name == "fused" else
              (lambda idx: fm_unfused_chain(torch, params, V, idx)))
        turns[name].append(serving_turn(torch, fn, idx99, idx_bulk))

    want = {"fm_gather_interaction": 2 + 50 + 1 + 5 + 1 + 10 + 1,
            "fm_interaction": len(batches)}
    for key, n in want.items():
        check(launches.get(key, 0) == n,
              f"fm_full: {key} launched {launches.get(key, 0)} times, not "
              f"once for each of the {n} calls")
    check(tuple(logits99.shape) == (B99,), "fm_full: serve_p99 shape")
    fm_same_bits(torch, logits99, want99, "fm_full serve_p99 logits vs cpu")
    p99_err = fm_within(torch, logits99, chain99, FM_REL * scale99,
                        "fm_full serve_p99 logits vs the training route")
    fm_same_bits(torch, ops.fm_interaction(v99.to(DEV)),
                 fmk.fm_interaction_plain(v99), "fm_full serve_p99 pair")
    check(bool(torch.isfinite(bulk[-1][0]).all())
          and bulk[-1][0].shape == (Bbulk,), "fm_full: serve_bulk")
    check(bool(torch.isfinite(scores).all()) and scores.shape == (C,),
          "fm_full: retrieval scores")
    check(bool(torch.allclose(torch.diff(top.values), torch.diff(full),
                              rtol=1e-4, atol=1e-5)),
          f"fm_full: retrieval decomposition {top.values.tolist()} vs "
          f"{full.tolist()}")
    for s in train:
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]),
              f"fm_full: training step {s}")
    check(all(bool(torch.isfinite(t).all()) for t in params.values()),
          "fm_full: parameters after training")
    p99_ms, bulk_ms = [s * 1e3 for _, s in p99], [s * 1e3 for _, s in bulk]
    ret_ms = [s * 1e3 for _, s in ret]
    med99, med_bulk = statistics.median(p99_ms), statistics.median(bulk_ms)
    emit("fm_full", arch=arch.arch_id, n_sparse=F, embed_dim=K,
         vocab_per_field=V, table_rows=cfg.total_rows,
         table_bytes=params["v"].numel() * 4, init_s=init_s,
         click_stream_s=data_s,
         serve_p99=dict(batch=B99, batches=len(p99_ms), median_ms=med99,
                        max_ms=max(p99_ms), min_ms=min(p99_ms),
                        preds_per_s=B99 / med99 * 1e3,
                        logits_max_abs_err_vs_training_route=p99_err),
         serve_bulk=dict(batch=Bbulk, ms=bulk_ms, median_ms=med_bulk,
                         preds_per_s=Bbulk / med_bulk * 1e3,
                         gather=gather),
         retrieval_cand=dict(user_fields=4, candidates=C,
                             median_ms=statistics.median(ret_ms),
                             max_ms=max(ret_ms),
                             top5_rows=top.indices.tolist(),
                             top5_scores=top.values.tolist()),
         train_batch=dict(batch=Btrain, steps=train),
         serve_max_memory_allocated=serve_peak, serve_turns=turns,
         train_max_memory_allocated=train_peak, launches=launches,
         phase_s=time.perf_counter() - phase_t0)
    return launches


def trace_device(torch, calls, within=()):
    """Run each of ``calls`` under ``torch.profiler`` after one profiled
    warm-up call (``calls[0]``, which absorbs the tracer's start-up):
    ``(traced wall s, device-busy s, kernels by device time, {name: device
    s of the kernels launched under the host op named name})`` for each
    name of ``within`` (an autograd node's name, say)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=len(calls) - 1,
                                   repeat=1)) as prof:
        calls[0]()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for fn in calls[1:]:
            fn()
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
    # an autograd node shows as "autograd::engine::evaluate_function:
    # name" around "name": the outer one, the larger, holds both
    inside = {name: max([getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0))
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CPU
                         and e.key.endswith(name)], default=0) / 1e6
              for name in within}
    return wall, busy, [{"name": e.key[:90], "calls": e.count,
                         "device_ms": dev_us(e) / 1e3}
                        for e in kernels[:12]], inside


def profile_phase(torch, graph, batches: int = 4):
    """Optional (``--phases profile``): the full-size sampler for a few
    batches, first plain and then under ``torch.profiler`` (after one
    profiled warm-up batch that absorbs the tracer's start-up): wall
    time with and without tracing, device-busy share and the kernels
    that take the device time."""
    from repro_torch import prng
    from repro_torch.core.engine import IMMConfig
    from repro_torch.core.sampler import IC, _bind_sparse

    sample = _bind_sparse(IC, graph.to("cuda"), IMMConfig())
    keys = prng.split(prng.PRNGKey(7), batches + 1)
    sample(keys[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in keys[1:]:
        sample(k)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    wall, busy, top, _ = trace_device(
        torch, [lambda k=k: sample(k) for k in keys])
    emit("profile", batches=batches, plain_wall_s=plain_wall,
         traced_wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
         top=top)


def fm_profile_phase(torch, steps: int = 3):
    """The full-width FM's serve_bulk batch and train_batch step (random
    ids and labels) under
    ``torch.profiler``, ``steps`` of each after a profiled warm-up: wall
    time, device-busy share and the kernels that take the device time.
    Then the same calls back to back without the profiler, between CUDA
    events and on the host clock (``events``): the device's span of a
    call beside its wall, where the profiler records none of its kernels
    (it has recorded none of a serve_bulk call that launches the fused
    kernel alone, after the earlier phases' profiles in one process).
    The span counts the device's gaps too, so it is its busy time only
    while the host keeps the queue ahead."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import fm
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   clip_by_global_norm)

    arch = get_arch("fm")
    cfg, dims = arch.config, {k: s.dims for k, s in arch.shapes.items()}
    F, V = cfg.n_sparse, cfg.vocab_per_field
    state = {"params": fm_params(torch, cfg, torch.Generator(device="cuda")
                                 .manual_seed(0), DEV)}
    opt_cfg = AdamWConfig()
    state["opt"] = adamw_init(state["params"], opt_cfg)
    idx_bulk = prng.randint(prng.PRNGKey(2), (dims["serve_bulk"]["batch"],
                                              F), 0, V, device=DEV)
    Bt = dims["train_batch"]["batch"]
    idx = prng.randint(prng.PRNGKey(4), (Bt, F), 0, V, device=DEV)
    labels = (prng.uniform(prng.PRNGKey(5), (Bt,), device=DEV) < 0.5
              ).to(torch.float32)

    def serve():
        with torch.no_grad():
            fm.fm_logits(state["params"], cfg, idx_bulk)

    def train():
        _, grads = fm.fm_value_and_grad(state["params"], cfg, idx, labels)
        grads, _ = clip_by_global_norm(grads, 1.0)
        state["params"], state["opt"] = adamw_update(
            state["params"], grads, state["opt"], opt_cfg)

    out = {}
    for name, fn in (("serve_bulk", serve), ("train_batch", train)):
        fn()
        torch.cuda.synchronize()
        wall, busy, top, _ = trace_device(torch, [fn] * (steps + 1))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        host_t0 = time.perf_counter()
        t0.record()
        for _ in range(steps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - host_t0) * 1e3
        dev_ms = t0.elapsed_time(t1)
        out[name] = dict(calls=steps, traced_wall_ms=wall / steps * 1e3,
                         device_busy_ms=busy / steps * 1e3,
                         idle_share=1.0 - busy / wall, top=top,
                         events=dict(wall_ms=host_ms / steps,
                                     span_ms=dev_ms / steps,
                                     span_share=dev_ms / host_ms))
    emit("fm_profile", **out)


# ------------------------------------------------------------------ GNNs ----

GNN_ARCHS = ("graphsage-reddit", "egnn", "graphcast", "equiformer-v2")
#: cuda against cpu, every output and gradient leaf: |err| <= GNN_TOL *
#: (1 + |cpu|), the f32 tolerance of the CPU tests against JAX
GNN_TOL = 1e-4
#: graphsage-reddit's minibatch_lg graph (configs/_gnn_common.py) and the
#: R-MAT scale that covers its ids
REDDIT_N, REDDIT_M, REDDIT_SCALE = 232_965, 114_615_892, 18
RMAT_ABC = (0.57, 0.19, 0.19)
#: steps a full-width cell takes
SAGE_STEPS, GRAPHCAST_STEPS, EQUIFORMER_STEPS, EGNN_STEPS = 6, 3, 2, 3


def gnn_err(torch, got, want, tag: str) -> float:
    """max |got - want| / (1 + |want|), both finite and of one shape."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)} "
          f"against {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()) and bool(
        torch.isfinite(want).all()), f"{tag}: not finite")
    if got.numel() == 0:
        return 0.0
    return float(((got - want).abs() / (1 + want.abs())).max())


def gnn_tree_err(torch, got, want, tag: str) -> dict:
    """`gnn_err` over every leaf of two parameter-shaped trees, each held
    to GNN_TOL."""
    from repro_torch.models.common import tree_leaves

    g, w = tree_leaves(got), tree_leaves(want)
    check(len(g) == len(w), f"{tag}: {len(g)} leaves against {len(w)}")
    errs = [gnn_err(torch, a, b, tag) for a, b in zip(g, w)]
    worst = max(errs)
    check(worst <= GNN_TOL, f"{tag}: a leaf differs by {worst:.3g}")
    return {"leaves": len(errs), "worst_err": worst}


def gnn_parity_phase(torch) -> dict:
    """The four GNNs' smoke steps, the sampler, Equiformer's chunked
    path, the meshed GraphCast processor and aggregation, and the
    embedding bags on the card against the host (see the docstring)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.graphs import rmat_graph, sample_blocks
    from repro_torch.graphs.partition import partition_edges_by_dst
    from repro_torch.kernels import ops
    from repro_torch.mesh import Mesh
    from repro_torch.models.common import tree_map, value_and_grad
    from repro_torch.models.gnn import equiformer, graphcast, mpnn
    from repro_torch.sparse import (embedding_bag, row_shards,
                                    sharded_embedding_lookup)

    ops.reset_launches()
    out = {}
    for arch in GNN_ARCHS:
        a = get_arch(arch)
        cpu_params = a.init_fn(torch.Generator().manual_seed(0),
                               a.smoke_config, device="cpu")
        res = {dev: a.smoke_step(tree_map(lambda t: t.to(dev), cpu_params),
                                 a.smoke_config, prng.PRNGKey(1))
               for dev in (DEV, "cpu")}
        errs = {k: gnn_err(torch, res[DEV][k], res["cpu"][k],
                           f"gnn_parity {arch} {k}")
                for k in res["cpu"] if k != "grads"}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= GNN_TOL, f"gnn_parity {arch}: {worst} differs"
              f" by {errs[worst]:.3g}")
        out[arch] = dict(loss_cuda=float(res[DEV]["loss"]),
                         loss_cpu=float(res["cpu"]["loss"]),
                         worst_output=worst, worst_output_err=errs[worst],
                         grads=gnn_tree_err(torch, res[DEV]["grads"],
                                            res["cpu"]["grads"],
                                            f"gnn_parity {arch} grads"))

    # two hops of the sampler: the same ids on the card and the host
    g = rmat_graph(4096, 65_536, seed=0)
    seeds = prng.randint(prng.PRNGKey(2), (1024,), 0, g.n)
    hops = {dev: sample_blocks(prng.PRNGKey(3), g.dst_offsets.to(dev),
                               g.in_src.to(dev), seeds.to(dev), (15, 10))
            for dev in (DEV, "cpu")}
    for (fc, nc), (fh, nh) in zip(hops[DEV], hops["cpu"]):
        check(torch.equal(fc.cpu(), fh) and torch.equal(nc.cpu(), nh),
              "gnn_parity: neighbor_sampler's ids differ on the card")
    out["sampler"] = dict(n=g.n, m=g.m, seeds=1024, fanouts=[15, 10],
                          ids=int(hops["cpu"][1][1].numel()),
                          sentinels=int((hops["cpu"][1][1] == g.n).sum()))

    # Equiformer: chunked edges equal flat ones on the card
    ea = get_arch("equiformer-v2")
    cfg = ea.smoke_config
    p = ea.init_fn(torch.Generator(device=DEV).manual_seed(0), cfg,
                   device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(4)
    nf = torch.randn((16, cfg.d_feat), generator=gen, device=DEV)
    pos = torch.randn((16, 3), generator=gen, device=DEV)
    es = torch.randint(0, 16, (48,), generator=gen, device=DEV)
    ed = torch.randint(0, 16, (48,), generator=gen, device=DEV)
    flat = equiformer.forward_edges(p, cfg, nf, pos, es, ed, 16)
    chunked = equiformer.forward_edges(p, cfg, nf, pos, es.view(6, 8),
                                       ed.view(6, 8), 16)
    errs = [gnn_err(torch, c, f, "gnn_parity equiformer chunked")
            for c, f in zip(chunked, flat)]
    check(max(errs) <= GNN_TOL, f"gnn_parity: chunked Equiformer differs "
          f"by {max(errs):.3g}")
    out["equiformer_chunked_err"] = max(errs)

    # GraphCast's dst-partitioned processor on a 2x2 mesh of the card
    ga = get_arch("graphcast")
    cfg = dataclasses.replace(ga.smoke_config, node_axes=("data",),
                              remat=True, remat_group=2)
    p = ga.init_fn(torch.Generator(device=DEV).manual_seed(0), cfg,
                   device=DEV)
    n, e = 24, 80
    nf = torch.randn((n, cfg.n_vars), generator=gen, device=DEV)
    ef = torch.randn((e, cfg.d_edge_in), generator=gen, device=DEV)
    es = torch.randint(0, n, (e,), generator=gen, device=DEV)
    ed = torch.randint(0, n, (e,), generator=gen, device=DEV)
    mesh = Mesh([[DEV] * 2] * 2, ("data", "model"))
    ef_p, es_p, ed_p = graphcast.partition_edges(es, ed, ef, n, 2, 2)
    want = graphcast.forward_edges(p, cfg, nf, ef, es, ed, n)
    got = graphcast.forward_edges_dst_partitioned(p, cfg, nf, ef_p, es_p,
                                                  ed_p, n, mesh=mesh)
    fwd_err = gnn_err(torch, got, want, "gnn_parity graphcast 2x2")
    check(fwd_err <= GNN_TOL, f"gnn_parity: the 2x2 GraphCast differs by "
          f"{fwd_err:.3g}")
    l1, g1 = value_and_grad(graphcast.loss_edges, p, cfg, nf, ef, es, ed,
                            nf, n)
    l2, g2 = value_and_grad(graphcast.loss_edges_dst_partitioned, p, cfg,
                            nf, ef_p, es_p, ed_p, nf, n, mesh=mesh)
    loss_err = gnn_err(torch, l2, l1, "gnn_parity graphcast 2x2 loss")
    check(loss_err <= GNN_TOL, f"gnn_parity: the 2x2 loss differs by "
          f"{loss_err:.3g}")
    out["graphcast_2x2"] = dict(forward_err=fwd_err, loss_err=loss_err,
                                grads=gnn_tree_err(
                                    torch, g2, g1,
                                    "gnn_parity graphcast 2x2 grads"))

    # sharded_aggregate on the 2x2 mesh, every op
    h = torch.randn((n, 32), generator=gen, device=DEV)
    ss, ds, nb = partition_edges_by_dst(es.cpu().numpy(), ed.cpu().numpy(),
                                        n, 4)
    agg = {}
    for op in ("sum", "mean", "max"):
        got = mpnn.sharded_aggregate(
            mesh, h, torch.tanh, torch.from_numpy(ss), torch.from_numpy(ds),
            nb, axis_name=("data", "model"), op=op)
        want = mpnn.aggregate(torch.tanh(h[es]), ed, n, op)
        agg[op] = gnn_err(torch, got[:n], want, f"sharded_aggregate {op}")
        check(agg[op] <= GNN_TOL, f"gnn_parity: sharded_aggregate {op} "
              f"differs by {agg[op]:.3g}")
    out["sharded_aggregate_err"] = agg

    # embedding bags, cuda against cpu; the row-sharded lookup bitwise
    table = torch.randn((1000, 16), generator=gen, device=DEV)
    idx = torch.randint(0, 1001, (64, 8), generator=gen, device=DEV)
    flat_idx = idx.reshape(-1)
    offsets = torch.sort(torch.randint(0, flat_idx.numel(), (40,),
                                       generator=gen, device=DEV)).values
    bags = {}
    for mode in ("sum", "mean", "max"):
        for form, args in (("fixed", (idx,)), ("offsets", (flat_idx,
                                                            offsets))):
            got = embedding_bag(table, *args, mode=mode)
            want = embedding_bag(table.cpu(), *(x.cpu() for x in args),
                                 mode=mode)
            err = gnn_err(torch, got, want, f"embedding_bag {mode} {form}")
            check(err <= GNN_TOL, f"gnn_parity: embedding_bag {mode} {form}"
                  f" differs by {err:.3g}")
            bags[f"{mode}_{form}"] = err
    tiles = row_shards(mesh, table, ("data", "model"))
    looked = sharded_embedding_lookup(tiles, idx, mesh=mesh,
                                      axis_name=("data", "model"),
                                      shard_rows=250)
    rows = table[idx.clamp(max=999)] * (idx < 1000)[..., None]
    for c in ((0, 0), (1, 1)):
        check(torch.equal(looked[c], rows),
              "gnn_parity: the row-sharded lookup is not the gather")
    out["embedding_bag_err"] = bags
    out["gnn_launches"] = gnn_launches(ops)
    emit("gnn_parity", **out)
    return out


def gnn_launches(ops) -> dict:
    """The kernel launches counted since the phase reset them: none, as
    no TPU kernel lies on the GNNs' path (PERF.md section 6)."""
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    check(not counts, f"a GNN phase launched kernels: {counts}")
    return counts


def reddit_graph(torch, seed: int = 0) -> dict:
    """graphsage-reddit's minibatch_lg graph, built on the card: R-MAT at
    scale 18 with the generator's a, b, c, ids taken modulo 232,965, self
    loops and duplicates dropped (``torch.unique`` on ``dst * n + src``,
    so the edges come out grouped by dst), drawn in rounds until at least
    114,615,892 distinct edges exist, then that many kept at random;
    returns the in-CSC (``dst_offsets``, ``in_src``, int32) and what the
    build drew and took."""
    n, target = REDDIT_N, REDDIT_M
    a, b, c = RMAT_ABC
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def draw(count: int):
        src = torch.zeros(count, dtype=torch.int64, device=DEV)
        dst = torch.zeros_like(src)
        for _ in range(REDDIT_SCALE):
            u = torch.rand(count, generator=gen, device=DEV)
            # quadrants 0..3 with p = a, b, c, d: 2 and 3 set the row bit,
            # 1 and 3 the column bit
            src.mul_(2).add_(u >= a + b)
            dst.mul_(2).add_(((u >= a) & (u < a + b)) | (u >= a + b + c))
            del u
        src.remainder_(n)
        dst.remainder_(n)
        keep = src != dst
        return (dst * n + src)[keep]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = int(1.65 * target)
    keys = torch.unique(draw(draws))
    while keys.numel() < target:
        more = 1 << 24
        draws += more
        keys = torch.unique(torch.cat([keys, draw(more)]))
    distinct = int(keys.numel())
    if distinct > target:
        pick = torch.randperm(distinct, generator=gen, device=DEV)[:target]
        keys = keys[torch.sort(pick).values]
    dst = keys // n
    in_src = (keys - dst * n).to(torch.int32)
    counts = torch.bincount(dst, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=DEV)
    offsets[1:] = torch.cumsum(counts, 0)
    del keys, dst
    torch.cuda.synchronize()
    return {"dst_offsets": offsets, "in_src": in_src,
            "build_s": time.perf_counter() - t0, "draws": draws,
            "distinct": distinct, "edges": int(in_src.numel()),
            "isolated": int((counts == 0).sum()),
            "max_in_degree": int(counts.max())}


def gnn_bound(arch_id: str, cfg, n_nodes: int, n_edges: int) -> dict:
    """A training step's flops by the reference's analytic count
    (`repro_torch.launch.steps._gnn_model_flops`: the dominant products'
    multiply-adds x 2 of the forward, x 3 for the backward; no recompute)
    and its time at the f32 peak outside the tensor cores (no TF32: the
    smoke turns it off)."""
    from repro_torch.launch.steps import _gnn_model_flops

    flops = _gnn_model_flops(arch_id, cfg, n_nodes, n_edges)
    return {"model_flops": flops,
            "f32_bound_ms": flops / ALU_OPS_PER_S * 1e3}


def gnn_stepper(arch_id: str, loss_fn, cfg, **extra):
    """The cells' `make_gnn_train_step` (loss, clip 1, AdamW at its
    defaults, the state updated in place) and its AdamW config."""
    from repro_torch.launch.steps import make_gnn_train_step
    from repro_torch.optim import AdamWConfig

    opt_cfg = AdamWConfig()
    return make_gnn_train_step(arch_id, cfg, loss_fn, opt_cfg,
                               extra), opt_cfg


def gnn_train(torch, arch_id: str, loss_fn, params, cfg, batch: tuple,
              steps: int, tag: str, **extra) -> dict:
    """``steps`` `gnn_stepper` steps on fixed inputs: step ms (host clock
    to a sync), losses, gradient norms, peak memory, the trained
    params."""
    from repro_torch.optim import adamw_init

    step, opt_cfg = gnn_stepper(arch_id, loss_fn, cfg, **extra)
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, norms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    check(all(math.isfinite(x) for x in losses + norms),
          f"gnn_full {tag}: a loss or gradient norm is not finite")
    return {"params": state["params"], "step_ms": ms, "loss": losses,
            "grad_norm": norms,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def sage_full(torch) -> dict:
    """graphsage-reddit's minibatch_lg cell on the card: the Reddit-scale
    graph, the planted-partition features with a zero sentinel row, both
    hops sampled every step, SAGE_STEPS steps; step 1's loss, and every
    gradient leaf recomputed on the card after the loop from step 1's
    parameters and rows, held to the same step on the host (the timed
    window holds the sampling, the gathers and the step alone)."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.configs._gnn_common import minibatch_subgraph_dims
    from repro_torch.data import synthetic_node_features
    from repro_torch.graphs.sampler import neighbor_sampler
    from repro_torch.models.common import tree_map, value_and_grad
    from repro_torch.models.gnn.graphsage import init_sage, loss_blocks
    from repro_torch.optim import adamw_init

    arch = get_arch("graphsage-reddit")
    dims = arch.shape("minibatch_lg").dims
    check((dims["n_nodes"], dims["n_edges"]) == (REDDIT_N, REDDIT_M),
          "gnn_full: minibatch_lg's graph size")
    cfg = arch.config
    check((cfg.d_feat, cfg.n_classes) == (dims["d_feat"], dims["n_classes"]),
          "gnn_full: graphsage-reddit's widths are minibatch_lg's")
    B, (f1, f2) = dims["batch_nodes"], dims["fanout"]
    graph = reddit_graph(torch)
    t0 = time.perf_counter()
    feats, labels = synthetic_node_features(REDDIT_N, cfg.d_feat,
                                            cfg.n_classes, seed=0)
    table = torch.cat([torch.from_numpy(feats),
                       torch.zeros((1, cfg.d_feat))]).to(DEV)
    labels = torch.from_numpy(labels).to(DEV)
    del feats
    torch.cuda.synchronize()
    feats_s = time.perf_counter() - t0
    offs, in_src = graph.pop("dst_offsets"), graph.pop("in_src")
    step_fn, opt_cfg = gnn_stepper("graphsage-reddit", loss_blocks, cfg)
    params = init_sage(torch.Generator(device=DEV).manual_seed(0), cfg,
                       device=DEV)
    # step 1's parameters, kept for the check before the step updates
    # them in place
    host = tree_map(lambda t: t.cpu(), params)
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    key = prng.PRNGKey(0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, sample_ms, losses, sentinels, first = [], [], [], [], None
    for step in range(SAGE_STEPS):
        key, ks, k1, k2 = prng.split(key, 4)
        t0 = time.perf_counter()
        seeds = prng.randint(ks, (B,), 0, REDDIT_N, device=DEV)
        ev[0].record()
        n1 = neighbor_sampler(k1, offs, in_src, seeds, f1)
        n2 = neighbor_sampler(k2, offs, in_src, n1.reshape(-1), f2)
        ev[1].record()
        batch = (table[seeds.long()], table[n1.long()], table[n2.long()],
                 labels[seeds.long()])
        state, metrics = step_fn(state, batch)
        loss = metrics["loss"]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        sample_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(loss))
        sentinels.append(int((n2 == REDDIT_N).sum()))
        if step == 0:
            first = (batch, loss)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          "gnn_full graphsage: a loss is not finite")
    # step 1's gradients from its parameters, on the card and on the host,
    # from the same gathered rows
    batch, loss = first
    grads = value_and_grad(loss_blocks, tree_map(lambda t: t.to(DEV), host),
                           cfg, *batch)[1]
    lh, gh = value_and_grad(loss_blocks, host, cfg,
                            *(x.cpu() for x in batch))
    loss_err = gnn_err(torch, loss, lh, "gnn_full graphsage loss")
    check(loss_err <= GNN_TOL, f"gnn_full graphsage: step 1's loss differs"
          f" from the host's by {loss_err:.3g}")
    return dict(graph, feats_s=feats_s, batch_nodes=B, fanout=[f1, f2],
                **gnn_bound("graphsage-reddit", cfg,
                            *minibatch_subgraph_dims(B, (f1, f2))),
                steps=SAGE_STEPS, step_ms=step_ms, sample_ms=sample_ms,
                loss=losses, sentinel_ids=sentinels,
                max_memory_allocated=peak, step1_loss_err=loss_err,
                step1_grads=gnn_tree_err(torch, grads, gh,
                                         "gnn_full graphsage step 1"))


def egnn_molecule(torch, gen, shape, d_feat: int):
    """molecule's batch: ``batch`` graphs of ``n_nodes`` nodes and
    ``n_edges`` random edges each, as one disjoint union."""
    d = shape.dims
    G, n, e = d["batch"], d["n_nodes"], d["n_edges"]
    base = (torch.arange(G, device=DEV) * n).repeat_interleave(e)
    es = torch.randint(0, n, (G * e,), generator=gen, device=DEV) + base
    ed = torch.randint(0, n, (G * e,), generator=gen, device=DEV) + base
    nf = torch.randn((G * n, d_feat), generator=gen, device=DEV)
    pos = torch.randn((G * n, 3), generator=gen, device=DEV)
    return nf, pos, es, ed


def gnn_full_phase(torch, runs: dict) -> dict:
    """The GNNs at their published widths on the card (see the
    docstring): graphsage-reddit at minibatch_lg, graphcast and
    equiformer-v2 at full_graph_sm, egnn at molecule, and the port's
    example (`run_example`, kept in ``runs``)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import egnn, equiformer, graphcast

    ops.reset_launches()
    out = {"graphsage": sage_full(torch)}
    emit("gnn_full", cell="graphsage-reddit minibatch_lg",
         **out["graphsage"])
    gen = torch.Generator(device=DEV).manual_seed(2)

    ga = get_arch("graphcast")
    dims = ga.shape("full_graph_sm").dims
    n, e, F = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
    # the cell's config as the reference's _gnn_cell_config sets it
    cfg = dataclasses.replace(ga.config, n_vars=F)
    check(cfg.remat and cfg.dtype == "float32" and cfg.n_layers == 16,
          "gnn_full: graphcast's full_graph_sm config")
    batch = (torch.randn((n, F), generator=gen, device=DEV),
             torch.randn((e, cfg.d_edge_in), generator=gen, device=DEV),
             torch.randint(0, n, (e,), generator=gen, device=DEV),
             torch.randint(0, n, (e,), generator=gen, device=DEV),
             torch.randn((n, F), generator=gen, device=DEV))
    params = ga.init_fn(gen, cfg, device=DEV)
    res = gnn_train(torch, "graphcast", graphcast.loss_edges, params, cfg,
                    batch, GRAPHCAST_STEPS, "graphcast", n_nodes=n)
    res.pop("params")
    out["graphcast"] = res
    emit("gnn_full", cell="graphcast full_graph_sm", n_nodes=n, n_edges=e,
         n_vars=F, **gnn_bound("graphcast", cfg, n, e), **res)

    qa = get_arch("equiformer-v2")
    cfg = dataclasses.replace(qa.config, d_feat=F)
    check(cfg.remat and (cfg.l_max, cfg.m_max, cfg.d_hidden) == (6, 2, 128),
          "gnn_full: equiformer-v2's full_graph_sm config")
    batch = (torch.randn((n, F), generator=gen, device=DEV),
             torch.randn((n, 3), generator=gen, device=DEV),
             torch.randint(0, n, (e,), generator=gen, device=DEV),
             torch.randint(0, n, (e,), generator=gen, device=DEV),
             torch.randn((n, cfg.n_out), generator=gen, device=DEV))
    params = qa.init_fn(gen, cfg, device=DEV)
    res = gnn_train(torch, "equiformer-v2", equiformer.loss_edges, params,
                    cfg, batch, EQUIFORMER_STEPS, "equiformer", n_nodes=n)
    res.pop("params")
    out["equiformer"] = res
    emit("gnn_full", cell="equiformer-v2 full_graph_sm", n_nodes=n,
         n_edges=e, d_feat=F, **gnn_bound("equiformer-v2", cfg, n, e),
         **res)

    ea = get_arch("egnn")
    shape = ea.shape("molecule")
    d_feat = 227        # _gnn_cell_config's fallback: molecule fixes none
    cfg = dataclasses.replace(ea.config, d_feat=d_feat)
    nf, pos, es, ed = egnn_molecule(torch, gen, shape, d_feat)
    N = nf.shape[0]
    target = pos + 0.1 * torch.randn(pos.shape, generator=gen, device=DEV)
    params = ea.init_fn(gen, cfg, device=DEV)
    res = gnn_train(torch, "egnn", egnn.loss_edges, params, cfg,
                    (nf, pos, es, ed, target), EGNN_STEPS, "egnn",
                    n_nodes=N)
    params = res.pop("params")
    # E(n) equivariance of the trained model on the card
    th = 0.6
    R = torch.tensor([[math.cos(th), -math.sin(th), 0.0],
                      [math.sin(th), math.cos(th), 0.0],
                      [0.0, 0.0, 1.0]], device=DEV)
    t = torch.tensor([1.0, -2.0, 0.5], device=DEV)
    with torch.no_grad():
        h1, x1, e1 = egnn.forward_edges(params, cfg, nf, pos, es, ed, N)
        h2, x2, e2 = egnn.forward_edges(params, cfg, nf, pos @ R.T + t, es,
                                        ed, N)
    equi = {"x_err": gnn_err(torch, x2, x1 @ R.T + t, "egnn x'"),
            "h_err": gnn_err(torch, h2, h1, "egnn h"),
            "energy_err": gnn_err(torch, e2, e1, "egnn energy")}
    check(max(equi.values()) <= GNN_TOL, f"gnn_full egnn: not E(n) "
          f"equivariant on the card: {equi}")
    out["egnn"] = dict(res, equivariance=equi)
    emit("gnn_full", cell="egnn molecule", n_nodes=N, n_edges=es.numel(),
         d_feat=d_feat, **gnn_bound("egnn", cfg, N, es.numel()),
         **out["egnn"])

    # the example asserts its own rise in accuracy; the examples phase
    # takes this run as its own
    ex = run_example(torch, "gnn_node_classification", runs)
    out["example"] = ex
    emit("gnn_full", cell="examples_torch/gnn_node_classification.py",
         **dict(ex, result=brief(ex["result"])),
         gnn_launches=gnn_launches(ops))
    return out


#: the cells phase: each cell's cuts on one card, ``{field: run value}``,
#: in the order they are made: a field of the shape's dims (the global
#: batch), then ``n_layers`` of the arch's config, then ``graph``, a factor
#: that divides a graph's nodes and edges alike; a cell not named runs at
#: its published size.  A GNN cell keeps the config of its published shape
#: (`cut_cell`): GraphCast at ogb_products keeps its bf16 latents and its
#: one remat group of four layers, Equiformer its bf16 irreps and its
#: edge-chunked scan (over 100,000 edges, kept by 640 seeds at
#: minibatch_lg).  Equiformer's ``graph`` 256 is one chip's share of the
#: 16x16 production mesh; at one layer GraphSAGE holds the whole graph.
CELL_CUTS = {
    ("grok-1-314b", "train_4k"): {"global_batch": 1, "n_layers": 1},
    ("grok-1-314b", "prefill_32k"): {"global_batch": 1, "n_layers": 1},
    ("grok-1-314b", "decode_32k"): {"n_layers": 1},
    ("moonshot-v1-16b-a3b", "train_4k"): {"global_batch": 8, "n_layers": 2},
    ("moonshot-v1-16b-a3b", "prefill_32k"): {"global_batch": 1,
                                             "n_layers": 2},
    ("moonshot-v1-16b-a3b", "decode_32k"): {"global_batch": 4,
                                            "n_layers": 12},
    ("qwen1.5-0.5b", "train_4k"): {"global_batch": 2},
    ("qwen1.5-0.5b", "prefill_32k"): {"global_batch": 1},
    ("qwen1.5-0.5b", "decode_32k"): {"global_batch": 8},
    ("h2o-danube-3-4b", "train_4k"): {"global_batch": 1},
    ("h2o-danube-3-4b", "prefill_32k"): {"global_batch": 1},
    ("minicpm-2b", "train_4k"): {"global_batch": 1},
    ("minicpm-2b", "prefill_32k"): {"global_batch": 1},
    ("minicpm-2b", "decode_32k"): {"global_batch": 2},
    ("equiformer-v2", "minibatch_lg"): {"batch_nodes": 640, "n_layers": 2},
    ("equiformer-v2", "ogb_products"): {"n_layers": 1, "graph": 256},
    ("graphcast", "ogb_products"): {"n_layers": 4, "graph": 128},
    ("egnn", "ogb_products"): {"n_layers": 1, "graph": 4},
    ("graphsage-reddit", "ogb_products"): {"n_layers": 1},
    ("imm", "imm_sample_google_ic"): {"batch": 256},
}
#: the cells run again on a 2x2 mesh of the card, held to their 1x1 run
CELLS_2X2 = (("fm", "serve_bulk"), ("imm", "imm_select_youtube_ic"),
             ("graphcast", "full_graph_sm"))
#: the kernels the cells' steps launch (the LM train and dense prefill
#: attention, the sharded selection's counters, the sparse sampler's coins)
CELL_KERNELS = ("coverage_matvec", "flash_attention", "flash_attention_bwd",
                "ic_sparse_hits")


def cut_cell(arch_id: str, shape_name: str, mesh):
    """``(cell, reduced, config)``: the cell built on ``mesh`` with its
    `CELL_CUTS`, ``{field: [published, run]}`` of each cut,
    and a GNN's config fields that its size chooses.  A GNN cell's config
    is chosen by its published shape (``config_shape``), so no cut
    changes it; the phase fails if the cut graph leaves the published
    cell's layout (the edge-chunked scan)."""
    from repro_torch.configs import IMM_DRYRUN_CELLS, get_arch
    from repro_torch.launch import steps

    cuts = CELL_CUTS.get((arch_id, shape_name), {})
    reduced = {}
    if arch_id == "imm":
        spec = dict(IMM_DRYRUN_CELLS[shape_name])
        for k, v in cuts.items():
            reduced[k] = [spec[k], v]
            spec[k] = v
        return steps.build_imm_cell(shape_name, spec, mesh), reduced, {}
    arch = get_arch(arch_id)
    shape = arch.shape(shape_name)
    dims, cfg = dict(shape.dims), arch.config
    for k, v in cuts.items():
        if k == "n_layers":
            reduced[k] = [cfg.n_layers, v]
            cfg = dataclasses.replace(cfg, n_layers=v)
        elif k == "graph":
            for f in ("n_nodes", "n_edges"):
                reduced[f] = [dims[f], -(-dims[f] // v)]
                dims[f] = reduced[f][1]
        else:
            reduced[k] = [dims[k], v]
            dims[k] = v
    cut_arch = dataclasses.replace(arch, config=cfg)
    cut_shape = dataclasses.replace(shape, dims=dims)
    if arch.family != "gnn":
        return steps.build_arch_cell(cut_arch, cut_shape, mesh), reduced, {}
    cell = steps.build_arch_cell(cut_arch, cut_shape, mesh,
                                 config_shape=shape)
    whole = steps.build_arch_cell(arch, shape, mesh)
    check(cell.note == whole.note, f"cells {arch_id}/{shape_name}: the cut "
          f"cell is laid out as {cell.note!r}, the published as "
          f"{whole.note!r}")
    run_cfg = steps._gnn_cell_config(cut_arch, shape, mesh)
    config = {k: getattr(run_cfg, k) for k in ("dtype", "remat_group",
                                               "channel_axis")
              if hasattr(run_cfg, k)}
    return cell, reduced, config


def finite(torch, t) -> bool:
    return bool(torch.isfinite(t.float()).all())


def cell_checks(torch, cell, outs) -> dict:
    """The repo's own checks of a cell's outputs (every call's): finite
    losses, a second train loss unlike the first; finite logits of the
    cell's shapes, tokens in the vocab; distinct seeds (of the rounds that
    gained) with non-increasing gains; sampled rows that hold their roots
    and sum to the counter."""
    tag = f"cells {cell.arch_id}/{cell.shape_name}"
    spec = cell.output_specs
    if cell.kind == "train":
        losses = [float(m["loss"]) for _, m in outs]
        norms = [float(m["grad_norm"]) for _, m in outs]
        check(all(math.isfinite(x) for x in losses + norms),
              f"{tag}: a loss or gradient norm is not finite: {losses}")
        check(losses[1] != losses[0], f"{tag}: the second step's loss "
              f"equals the first's ({losses[0]})")
        return {"loss": losses, "grad_norm": norms}
    if cell.kind == "prefill":
        logits, cache = outs[-1]
        check(tuple(logits.shape) == tuple(spec[0].shape)
              and finite(torch, logits), f"{tag}: logits")
        check(tuple(cache["k"].shape) == tuple(spec[1]["k"].shape),
              f"{tag}: cache shape")
        check(torch.equal(outs[0][0], logits), f"{tag}: two prefills of "
              "one batch differ")
        return {"logits_abs_max": float(logits.float().abs().max())}
    if cell.kind == "decode":
        toks = [t for t, _ in outs]
        vocab = int(cell.input_specs[0]["embed"].shape[0])
        check(all(tuple(t.shape) == tuple(spec[0].shape) for t in toks)
              and all(int(t.min()) >= 0 and int(t.max()) < vocab
                      for t in toks), f"{tag}: decoded tokens")
        return {"tokens": [t[:4, 0].tolist() for t in toks]}
    if cell.kind == "serve":
        out = outs[-1]
        check(tuple(out.shape) == tuple(spec.shape) and finite(torch, out),
              f"{tag}: logits")
        check(torch.equal(outs[0], out), f"{tag}: two calls differ")
        return {"logits_abs_max": float(out.abs().max())}
    if cell.kind == "select":
        seeds, frac, gains = outs[-1]
        g = gains.tolist()
        picked = [v for v, gain in zip(seeds.tolist(), g) if gain > 0]
        check(len(set(picked)) == len(picked)
              and all(a >= b for a, b in zip(g, g[1:]))
              and 0.0 < float(frac) <= 1.0, f"{tag}: seeds {seeds} gains {g}")
        check(torch.equal(outs[0][0], seeds), f"{tag}: two calls differ")
        return {"seeds": seeds[:8].tolist(), "gains": g[:8],
                "covered_frac": float(frac)}
    visited, counter, roots = outs[-1]
    rows = torch.arange(roots.shape[0], device=roots.device)
    check(tuple(visited.shape) == tuple(spec[0].shape)
          and bool((visited[rows, roots.long()] == 1).all())
          and torch.equal(visited.sum(0, dtype=torch.int32), counter),
          f"{tag}: sampled rows")
    return {"mean_row_size": float(counter.sum()) / roots.shape[0]}


def cell_line(rec: dict) -> dict:
    return {k: rec.get(k) for k in ("step_ms", "max_memory_allocated",
                                "executed_flops", "model_flops",
                                "collectives")}


def cells_2x2(torch, arch_id, shape_name, cell, inputs, outs) -> dict:
    """The cell on a 2x2 mesh of the card held to its 1x1 run: FM
    serving bitwise, the IMM selection's seeds and gains bitwise; for
    GraphCast a graph balanced over two dst blocks, laid out for each
    mesh, both runs within GNN_TOL * (1 + |1x1|).  The 2x2 run's census
    beside."""
    from repro_torch.launch import dryrun
    from repro_torch.mesh import Mesh

    mesh2 = Mesh([[DEV] * 2] * 2, ("data", "model"))
    cell2, _, _ = cut_cell(arch_id, shape_name, mesh2)
    tag = f"cells 2x2 {arch_id}/{shape_name}"
    if arch_id == "graphcast":
        return graphcast_2x2(torch, cell, cell2, mesh2)
    outs2, rec = dryrun.execute_cell(cell2, inputs, mesh2, steps=1,
                                     device=DEV)
    if arch_id == "fm":
        check(torch.equal(outs2[-1], outs[-1]), f"{tag}: not bitwise 1x1")
    else:
        check(torch.equal(outs2[-1][0], outs[-1][0])
              and torch.equal(outs2[-1][2], outs[-1][2]),
              f"{tag}: seeds or gains differ from 1x1")
    check(all(v["cross_bytes"] == 0 for v in rec["collectives"].values()),
          f"{tag}: bytes crossed devices on one card")
    return {"mesh": "2x2", "equal": "bitwise", **cell_line(rec)}


def graphcast_2x2(torch, cell, cell2, mesh2) -> dict:
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.gnn.graphcast import partition_edges
    from repro_torch.models.common import tree_map

    gen = torch.Generator(device=DEV).manual_seed(2)
    (state, batch) = cell.make_inputs(gen, DEV)
    nf, ef, _, _, tg = batch
    n, e = nf.shape[0], ef.shape[0]
    src, dst = steps.graphcast_edges(gen, n, e, 2)
    runs = []
    for c, (n_dp, n_tp), mesh in ((cell, (1, 1), None),
                                  (cell2, (2, 2), mesh2)):
        pef, pes, ped = partition_edges(src, dst, ef, n, n_dp, n_tp)
        st = tree_map(lambda t: t.clone(), state)
        outs, rec = dryrun.execute_cell(
            c, (st, (nf, pef, pes.to(torch.int32), ped.to(torch.int32),
                     tg)), mesh, steps=1, device=DEV)
        runs.append((outs, rec, st))
    (o1, _, s1), (o2, rec, s2) = runs
    errs = {"loss": max(gnn_err(torch, b[1]["loss"], a[1]["loss"], "loss")
                        for a, b in zip(o1, o2)),
            "grad_norm": max(gnn_err(torch, b[1]["grad_norm"],
                                     a[1]["grad_norm"], "norm")
                             for a, b in zip(o1, o2)),
            "params": gnn_tree_err(torch, s2["params"], s1["params"],
                                   "cells graphcast 2x2")["worst_err"]}
    check(max(errs.values()) <= GNN_TOL, f"cells 2x2 graphcast: {errs}")
    return {"mesh": "2x2", "max_err": errs, **cell_line(rec)}


def cells_phase(torch, assigned: list) -> dict:
    """Every cell of the launchers: (a) all 39 (``assigned``, the arch x
    shape cells of the configs as imported, before lm_train registers
    qwen-100m, and the IMM cells) dry-run on the 16x16 and 2x16x16 meshes
    of the meta device, nothing allocated on the card; (b) one step of
    each (two for train) on a 1x1 mesh of the card, cut as `CELL_CUTS`
    says; (c) `CELLS_2X2` on a 2x2 mesh of the card.  Returns the
    kernels' launches."""
    from repro_torch.configs import IMM_DRYRUN_CELLS
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.mesh import Mesh

    t0 = time.perf_counter()
    todo = list(assigned) + [("imm", n) for n in IMM_DRYRUN_CELLS]
    check(len(todo) == 39, f"cells: {len(todo)} cells, not 39")
    held = torch.cuda.memory_allocated()
    dry = {}
    for arch_id, shape_name in todo:
        recs = [dryrun.run_cell(arch_id, shape_name, mp)
                for mp in (False, True)]
        check(all(r["ok"] for r in recs), f"cells: {arch_id}/{shape_name} "
              "did not dry-run")
        dry[f"{arch_id}/{shape_name}"] = {
            "bytes_per_device": [r["bytes_per_device"] for r in recs],
            "fits_hbm": [r["fits_hbm"] for r in recs],
            "model_flops": recs[0]["model_flops"]}
    check(torch.cuda.memory_allocated() == held,
          "cells: the dry run allocated on the card")
    emit("cells", part="dry_run", meshes=["16x16", "2x16x16"],
         seconds=time.perf_counter() - t0, cells=dry)

    mesh = Mesh([[DEV]], ("data", "model"))
    ops.reset_launches()
    for i, (arch_id, shape_name) in enumerate(todo):
        t1 = time.perf_counter()
        cell, reduced, config = cut_cell(arch_id, shape_name, mesh)
        inputs = cell.make_inputs(
            torch.Generator(device=DEV).manual_seed(i), DEV)
        outs, rec = dryrun.execute_cell(cell, inputs, mesh, steps=1,
                                        device=DEV)
        line = dict(cell=f"{arch_id}/{shape_name}", kind=cell.kind,
                    note=cell.note, reduced=reduced, **cell_line(rec),
                    **({"config": config} if config else {}),
                    published_model_flops=dry[f"{arch_id}/{shape_name}"][
                        "model_flops"], **cell_checks(torch, cell, outs))
        if (arch_id, shape_name) in CELLS_2X2:
            line["on_2x2"] = cells_2x2(torch, arch_id, shape_name, cell,
                                       inputs, outs)
        del cell, inputs, outs
        torch.cuda.empty_cache()
        emit("cells", **line, seconds=time.perf_counter() - t1)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    for k in CELL_KERNELS:
        check(launches.get(k, 0) > 0, f"cells: {k} launched no time")
    total = time.perf_counter() - t0
    emit("cells", part="summary", cells=len(todo), seconds=total,
         launches=launches,
         nvidia_smi=nvidia_smi())
    return launches


# ------------------------------------------------------------- examples ----

#: the port's examples (examples_torch/, one for each of examples/*.py) in
#: the examples phase's order
EXAMPLES = ("quickstart", "influence_campaign", "streaming_campaign",
            "multi_tenant_campaign", "recsys_ctr", "gnn_node_classification",
            "train_lm")
#: the kernels each example must launch on the card (GraphSAGE's path
#: holds none)
EXAMPLE_KERNELS = {
    "quickstart": ("arena_commit", "coverage_matvec"),
    "influence_campaign": ("ic_sparse_hits", "uniform_draw", "arena_commit",
                           "coverage_matvec"),
    "streaming_campaign": ("arena_commit",),
    "multi_tenant_campaign": ("arena_commit",),
    "recsys_ctr": ("fm_interaction", "fm_gather_interaction"),
    "gnn_node_classification": (),
    "train_lm": ("flash_attention:simt", "flash_attention_bwd:simt"),
}
#: the IM examples run again on the host, their answers held to the card's
EXAMPLE_TWINS = ("quickstart", "influence_campaign")
#: seconds into the run after which the examples phase runs no host twin
TWIN_DEADLINE_S = 900


def call_example(name: str, dev: str, root: str) -> dict:
    """``examples_torch.<name>.main`` at its defaults on ``dev``, what it
    prints sent to stderr; train_lm with ``--tiny`` (its default run is
    lm_train's qwen_100m), its checkpoints under ``root``."""
    import contextlib
    import importlib

    mod = importlib.import_module(f"examples_torch.{name}")
    with contextlib.redirect_stdout(sys.stderr):
        if name in ("recsys_ctr", "gnn_node_classification"):
            return mod.main(device=dev)
        argv = ["--device", dev]
        if name == "train_lm":
            argv += ["--tiny", "--checkpoint-dir",
                     os.path.join(root, "train_lm")]
        return mod.main(argv)


def brief(x):
    """``x`` with each list longer than 20 cut to every 10th item."""
    if isinstance(x, dict):
        return {str(k): brief(v) for k, v in x.items()}
    if isinstance(x, list):
        if len(x) > 20:
            return {"len": len(x), "every_10th": brief(x[::10])}
        return [brief(v) for v in x]
    return x


def run_example(torch, name: str, runs: dict) -> dict:
    """One example on the card (`call_example`) with obs on: its wall
    seconds, the launches it counted, its kernel dispatches and its
    returned dict, kept in ``runs[name]`` and returned.  Fails if it
    dispatched a kernel's reference impl or launched no kernel of
    ``EXAMPLE_KERNELS[name]``."""
    import tempfile

    from repro_torch import obs
    from repro_torch.kernels import ops

    obs.reset()
    obs.enable()
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        res = call_example(name, DEV, root)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = obs.snapshot()
    obs.reset()
    launches = {k: n - before.get(k, 0)
                for k, n in ops.launch_counts().items()
                if n > before.get(k, 0)}
    reference = dispatch_counts(snap, "reference")
    check(not reference, f"examples {name}: reference impls dispatched on "
          f"the card: {reference}")
    for kernel in EXAMPLE_KERNELS[name]:
        check(launches.get(kernel, 0) > 0,
              f"examples {name}: {kernel} launched no time")
    runs[name] = dict(s=wall, launches=launches,
                      dispatch=dispatch_counts(snap), result=res)
    return runs[name]


def example_checks(name: str, res: dict) -> None:
    """What an example prints as a claim, held: the baseline's influence
    (identical math), a restored snapshot's selection, the stream equal
    to a fresh engine, a drained tier whose flood stops at its cap."""
    if name == "quickstart":
        check(res["baseline_influence"] == res["influence"],
              f"examples quickstart: baseline {res['baseline_influence']} "
              f"vs {res['influence']}")
    elif name == "influence_campaign":
        check(res["models"]["IC"]["restore"]["identical"],
              "examples influence_campaign: the restored select differs")
    elif name == "streaming_campaign":
        check(res["identical_to_fresh"],
              "examples streaming_campaign: not seed-for-seed a fresh "
              "engine's")
    elif name == "multi_tenant_campaign":
        check(res["drained"] and res["admitted"] == res["max_pending"],
              f"examples multi_tenant_campaign: drained {res['drained']}, "
              f"{res['admitted']} admitted of cap {res['max_pending']}")


def timeless(x):
    """An example's returned dict without its host timings."""
    if isinstance(x, dict):
        return {k: timeless(v) for k, v in x.items()
                if not (isinstance(k, str)
                        and (k == "s" or k.endswith("_s")))}
    return x


def dense_twin_ties(torch, graph, model: str, *, seed: int, batch: int,
                    theta: int) -> dict:
    """The first ``theta // batch`` batches of an engine's dense sampler
    run on the card and on the host from the same keys, every row on
    which they differ traced to its first differing BFS step and
    classified (`repro_torch.core.ties`); the summed report."""
    from repro_torch.core import sampler, ties

    logq = {dev: sampler.logq_from_probs(g, sampler._edge_probs(
        sampler.get_model(model), g))
        for dev, g in ((DEV, graph.to(DEV)), ("cpu", graph.to("cpu")))}
    total = {"rows": 0, "cells": 0, "ties": 0, "faults": []}
    for key in batch_keys(seed, theta // batch):
        def run(dev, key=key):
            return lambda t: sampler._dense_loop(
                key, logq[dev], batch=batch,
                max_steps=t)[0].cpu().numpy()

        roots = sampler._dense_loop(key, logq["cpu"], batch=batch,
                                    max_steps=1)[2].numpy()
        rep = ties.classify_runs(
            run(DEV), run("cpu"),
            lambda t, key=key: sampler.dense_coins(key, t, batch=batch,
                                                   n_nodes=graph.n),
            logq["cpu"].numpy(), roots, max_steps=graph.n)
        for k in total:
            total[k] += rep[k]
    return total


def example_twin(torch, name: str, card: dict) -> dict:
    """``name`` again on the host, its answers held to the card's
    (``card``, its returned dict):
    equal on the sparse and walk samplers (influence_campaign); on the
    dense one (quickstart) equal, or every row on which the card's and
    the host's samplers differ a classified near-tie."""
    import tempfile

    from repro_torch.graphs import rmat_graph

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        host = timeless(call_example(name, "cpu", root))
    card = timeless(card)
    out = {"host_s": time.perf_counter() - t0, "equal": card == host}
    if name == "quickstart" and card != host:
        rep = dense_twin_ties(torch, rmat_graph(n=2_000, m=16_000, seed=0),
                              "IC", seed=0, batch=BATCH,
                              theta=card["theta"])
        check(rep["rows"] > 0 and rep["faults"] == [],
              f"examples quickstart: card {card} vs host {host}: {rep}")
        out["near_ties"] = {k: rep[k] for k in ("rows", "cells", "ties")}
    else:
        check(card == host, f"examples {name}: card {card} vs host {host}")
    return out


def example_mesh(torch, card: dict) -> dict:
    """influence_campaign with ``--mesh 2x2`` on the card (clipped, as the
    reference clips to its devices, to a 1x1 mesh of the one card: the
    tiled store's path): every answer equal to the unmeshed run's
    ``card``."""
    import contextlib
    import importlib

    mod = importlib.import_module("examples_torch.influence_campaign")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = mod.main(["--device", DEV, "--mesh", "2x2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shards = res.pop("shards")
    want = {k: v for k, v in timeless(card).items() if k != "shards"}
    check(shards >= 1 and timeless(res) == want,
          f"examples influence_campaign --mesh 2x2: {res} vs {card}")
    return {"s": wall, "shards": shards}


def examples_phase(torch, t_run: float, runs: dict) -> dict:
    """Every port example at its defaults on the card (one that ``runs``
    holds already, gnn_full's, taken as it is), then the IM twins on the
    host while the run is under TWIN_DEADLINE_S; returns the launches
    summed over the examples."""
    total = {}
    for name in EXAMPLES:
        reused = name in runs
        rec = runs[name] if reused else run_example(torch, name, runs)
        example_checks(name, rec["result"])
        emit("examples", example=name, reused=reused,
             **dict(rec, result=brief(rec["result"])))
        for kernel, n in rec["launches"].items():
            total[kernel] = total.get(kernel, 0) + n
    twins = {}
    for name in EXAMPLE_TWINS:
        if time.perf_counter() - t_run > TWIN_DEADLINE_S:
            twins[name] = "skipped: past TWIN_DEADLINE_S"
            continue
        twins[name] = example_twin(torch, name, runs[name]["result"])
    meshed = example_mesh(torch, runs["influence_campaign"]["result"])
    emit("examples", twins=twins, mesh=meshed,
         s={name: runs[name]["s"] for name in EXAMPLES},
         launches=total)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-theta", type=int, default=THETA,
                    help="theta cap of the full solves (cut this, never "
                         "n)")
    ap.add_argument("--phases",
                    default="kernels,parity,imm_full,packed_full,"
                            "compressed_full,mesh_full,indices_full,lt_full,"
                            "stream_full,mesh_stream_full,tier_full,"
                            "mesh_tier_full,pallas_full,lm_parity,"
                            "lm_full,lm_train,fm_parity,fm_full,fm_profile,"
                            "gnn_parity,gnn_full,cells,examples",
                    help="comma list of kernels, parity, imm_full, "
                         "packed_full, compressed_full, mesh_full, "
                         "indices_full, lt_full, stream_full, "
                         "mesh_stream_full, tier_full, mesh_tier_full, "
                         "pallas_full, lm_parity, "
                         "lm_full, lm_train, fm_parity, fm_full, "
                         "fm_profile, gnn_parity, gnn_full, cells, "
                         "examples and the optional profile")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if "mesh_stream_full" in phases:
        # the meshed stream is held to the single-device stream's answers
        phases.add("stream_full")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    faulthandler.enable()
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        return run_phases(torch, phases, args.max_theta)
    finally:
        faulthandler.cancel_dump_traceback_later()


def run_phases(torch, phases: set, max_theta: int) -> int:
    """Every phase in ``phases``, then the kernel table and the ok line;
    0, or an exception at the first failure."""
    t_run = time.perf_counter()

    def ended(phase: str) -> None:
        print(f"chip_smoke: {phase} ended at "
              f"{time.perf_counter() - t_run:.1f} s", file=sys.stderr,
              flush=True)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        load_peaks()
        from repro_torch.configs import all_cells
        from repro_torch.core.sampler import make_logq
        from repro_torch.graphs.datasets import scaled_snap, synthetic_snap
        from repro_torch.kernels import build
        import examples_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assigned = all_cells()

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
    lj = scaled_snap("com-LJ", LJ_SCALE, seed=0)
    emit("graph", name="com-LJ", scale=LJ_SCALE, n=lj.n, m=lj.m)
    check(lj.n == LJ_N, "com-LJ replica size")
    ended("graphs")

    rows = (kernel_phase(torch, graph, make_logq(lj.to(DEV)))
            if "kernels" in phases else {})
    ended("kernels")
    if "parity" in phases:
        parity_phase(torch, lj)
        ended("parity")
    launches, ref = {}, None
    keep = {} if "mesh_full" in phases else None
    for store in ("bitmap", "packed", "compressed"):
        if PHASE[store] in phases:
            launches[PHASE[store]], summary = full_phase(
                torch, graph, max_theta, store, ref,
                keep if store == "bitmap" else None)
            if store == "bitmap":
                ref = summary
            ended(PHASE[store])
    if "mesh_full" in phases:
        launches["mesh_full"] = mesh_full(
            torch, graph, max_theta,
            dict(ref, **keep) if ref is not None else None)
        keep = None
        ended("mesh_full")
    if "indices_full" in phases:
        launches["indices_full"] = indices_full(torch, graph, max_theta)
        ended("indices_full")
    if "lt_full" in phases:
        launches["lt_full"] = lt_full(torch, graph, max_theta)
        ended("lt_full")
    stream_ref = {}
    if "stream_full" in phases:
        launches["stream_full"] = stream_full(torch, graph, max_theta,
                                              stream_ref)
        ended("stream_full")
    if "mesh_stream_full" in phases:
        launches["mesh_stream_full"] = mesh_stream_full(
            torch, graph, max_theta, stream_ref)
        ended("mesh_stream_full")
    if "tier_full" in phases:
        launches["tier_full"] = tier_full(torch)
        ended("tier_full")
    if "mesh_tier_full" in phases:
        launches["mesh_tier_full"] = tier_full(torch, MESH_TIER_SHAPE)
        ended("mesh_tier_full")
    if "pallas_full" in phases:
        launches["pallas_full"] = pallas_full(torch, lj, LJ_THETA)
        ended("pallas_full")
    if "lm_parity" in phases:
        lm_parity_phase(torch)
        ended("lm_parity")
    if "lm_full" in phases:
        launches["lm_full"] = lm_full_phase(torch)
        ended("lm_full")
    if "lm_train" in phases:
        launches["lm_train"], rows["flash_attention_bwd"] = \
            lm_train_phase(torch)
        ended("lm_train")
    if "fm_parity" in phases:
        fm_parity_phase(torch)
        ended("fm_parity")
    if "fm_full" in phases:
        launches["fm_full"] = fm_full_phase(torch)
        ended("fm_full")
    if "profile" in phases:
        profile_phase(torch, graph)
        ended("profile")
    if "fm_profile" in phases:
        fm_profile_phase(torch)
        ended("fm_profile")
    if "gnn_parity" in phases:
        gnn_parity_phase(torch)
        ended("gnn_parity")
    example_runs = {}
    if "gnn_full" in phases:
        gnn_full_phase(torch, example_runs)
        ended("gnn_full")
    if "cells" in phases:
        launches["cells"] = cells_phase(torch, assigned)
        ended("cells")
    if "examples" in phases:
        launches["examples"] = examples_phase(torch, t_run, example_runs)
        ended("examples")
    two_card_phase(torch)
    ended("two_cards")
    # each kernel's launches on the full run that is its path
    table = []
    for name, row in rows.items():
        if name not in KERNEL_PATH:
            raise KeyError(f"{name}: no full run is named as its path")
        phase = KERNEL_PATH[name]
        count = launches.get(phase, {}).get(name, 0)
        check(count > 0 or phase not in phases,
              f"{name}: launched no time on {phase}")
        table.append({"name": name,
                      **{k: v for k, v in row.items()
                         if k not in ("shape", "terms")},
                      "launches": count,
                      "launches_by_phase": {
                          ph: c[name] for ph, c in launches.items()
                          if c.get(name, 0)}})
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
