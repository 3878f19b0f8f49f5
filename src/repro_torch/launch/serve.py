"""Serving entry points (``repro.launch.serve``).

``LMServer``: batched greedy generation with a KV cache on one device —
prefill (one ``flash_attention`` launch per layer on the card), a replay
of the prompt through `decode_step` that seeds the decode cache, then one
`decode_step` per generated token::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
        --arch qwen1.5-0.5b --device cpu

The CLI serves the arch's smoke configuration, as the reference's does
(any of the five LMs: the dense ones and the MoE ``--arch
moonshot-v1-16b-a3b`` or ``grok-1-314b``), and runs on ``cuda`` unless
``--device cpu`` is given.

``IMServer``: influence queries against one shared `InfluenceEngine`
or `repro_torch.stream.StreamEngine`.  ``submit`` queues a sigma(S)
query, ``flush`` answers every pending one with one store pass, and
``select`` hits the engine's memoized selection.  Over a stream,
``apply_delta`` forwards graph edits and up to ``refresh_budget`` stale
rows are repaired after each flush, or continuously by a worker thread
(``async_refresh``); one lock serializes every engine call, so a flush
answers against exactly one store state (one epoch).  The worker runs
the engine on the device and CUDA stream the server was built on::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload im \
        --graph com-Amazon --queries 64 --deltas 4 --model LT

``--workload tier`` drives the IMServe tier (`repro_torch.serve`): N
tenants on R-MAT graphs, a Zipf-skewed Poisson trace of queries and
deltas replayed with the refresh worker running::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload tier \
        --tenants 5 --tier-n 256 --max-theta 512 --duration 0.25

``--mesh`` (an int or ``auto``: 1D theta sharding; ``RxC``: theta x
vertex) runs the IM engine, the stream and every tier tenant on a
`repro_torch.mesh.Mesh` of the devices there are
(`repro_torch.configs.imm_snap.make_im_mesh`: the CUDA cards, or the
host with ``--device cpu``); every printed number must equal the
mesh-less run's.
"""
from __future__ import annotations

import argparse
import contextlib
import threading
import time

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.transformer import (
    LMConfig, decode_step, init_kv_cache, init_lm, prefill,
)


class LMServer:
    """Minimal batched server: submit token prompts, get continuations.

    ``params`` default to `init_lm` on a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless told otherwise; without a GPU
    that raises unless ``device="cpu"``)."""

    def __init__(self, cfg: LMConfig, params=None, *, max_len: int = 256,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_lm(gen, cfg, device=self.device)
        self.params = params
        self.max_len = max_len

    def prefill(self, prompts: torch.Tensor):
        """``(last-position logits (B, V), prefill's cache)``."""
        return prefill(self.params, self.cfg, prompts)

    def seed_cache(self, prompts: torch.Tensor):
        """Replay the prompt through `decode_step` into a fresh decode
        cache (ring-buffer handling for sliding windows stays in one
        place); returns ``(the last step's next token (B, 1), cache)``."""
        B, S = prompts.shape
        cache_len = self.cfg.window if self.cfg.window > 0 else self.max_len
        cache = init_kv_cache(self.cfg, B, cache_len, device=self.device)
        tok = None
        for i in range(S):
            tok, cache = decode_step(self.params, self.cfg, cache,
                                     prompts[:, i:i + 1])
        return tok, cache

    def decode(self, cache: dict, tok: torch.Tensor, n_tokens: int):
        """``n_tokens`` greedy tokens from ``tok (B, 1)`` on, ``(B, n)``."""
        out = []
        for _ in range(n_tokens):
            out.append(tok)
            tok, cache = decode_step(self.params, self.cfg, cache, tok)
        return torch.cat(out, dim=1)

    def generate(self, prompts, n_tokens: int = 16) -> torch.Tensor:
        """prompts: (B, S) int32 -> (B, n_tokens) greedy continuation.
        Prefill's logits give the first token; its cache is discarded and
        the decode cache is seeded by replaying the prompt, as in the
        reference."""
        prompts = torch.as_tensor(prompts, device=self.device)
        logits, _ = self.prefill(prompts)
        _, cache = self.seed_cache(prompts)
        tok = torch.argmax(logits, dim=-1)[:, None].to(prompts.dtype)
        return self.decode(cache, tok, n_tokens)


class IMServer:
    """Batches concurrent influence queries against a shared engine.

    ``submit`` enqueues a sigma(S) query and returns a ticket; ``flush``
    answers every pending ticket with one store pass; ``select`` serves
    top-k queries from the engine's memo.  With a `StreamEngine` and a
    ``refresh_budget``, ``apply_delta`` forwards graph edits and each
    ``flush`` first answers every pending ticket against one store
    state (``served_epoch``), then repairs up to ``refresh_budget``
    rows.  ``async_refresh=True`` moves the repair onto a worker thread
    that drains the backlog in budget-row slices between flushes; the
    one lock keeps every flush on one store state, and the worker runs
    on the device and CUDA stream the server was built on.  ``close``
    (or the context manager) stops the worker.
    """

    def __init__(self, engine, *, max_batch: int = 256,
                 refresh_budget: int | None = None,
                 async_refresh: bool = False):
        self.engine = engine
        self.max_batch = max_batch
        self.refresh_budget = refresh_budget
        if refresh_budget is not None and not hasattr(engine, "refresh"):
            raise ValueError(
                "refresh_budget needs a StreamEngine (got a static "
                "engine with nothing to refresh)")
        if refresh_budget is not None and refresh_budget < 1:
            raise ValueError(
                f"refresh_budget must be >= 1 row (got {refresh_budget})")
        if async_refresh and refresh_budget is None:
            raise ValueError(
                "async_refresh needs a refresh_budget (the worker "
                "repairs in budget-row slices)")
        self._pending = []          # list[(ticket, seed_set)]
        self._next_ticket = 0
        self.queries_served = 0
        self.served_epoch = getattr(engine, "epoch", None)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        self.refreshes_run = 0      # worker repair slices completed
        dev = torch.device(getattr(getattr(engine, "store", None), "device",
                                   "cpu"))
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        if async_refresh:
            self.start_refresh_worker()

    # ------------------------------------------------- async refresh ----

    def _on_engine_stream(self):
        """The server's device and CUDA stream, for a call from another
        thread (a new thread starts on the default device and stream)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def start_refresh_worker(self) -> None:
        """Start the background repair worker (a no-op while it runs; a
        stopped server restarts it)."""
        if self.refresh_budget is None:
            raise ValueError(
                "the refresh worker needs a refresh_budget (it repairs "
                "in budget-row slices)")
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._refresh_loop, name="im-refresh", daemon=True)
        self._worker.start()

    def stop_refresh_worker(self) -> None:
        """Stop the worker and join it; safe in any state, twice, and
        from the worker itself (no self-join)."""
        self._stop.set()
        worker, self._worker = self._worker, None
        if worker is not None and worker is not threading.current_thread():
            worker.join()

    close = stop_refresh_worker

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_refresh_worker()

    @property
    def async_refreshing(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def _refresh_loop(self):
        with self._on_engine_stream():
            while not self._stop.is_set():
                did = False
                with self._lock:
                    if getattr(self.engine, "stale", 0) > 0:
                        self.engine.refresh(self.refresh_budget)
                        self.refreshes_run += 1
                        did = True
                if did:
                    # Python locks are not fair: yield between slices so
                    # a blocked flush() or submit() gets the lock
                    time.sleep(1e-4)
                else:
                    self._stop.wait(0.002)

    # ------------------------------------------------------- queries ----

    @property
    def pending(self) -> int:
        return len(self._pending)

    def submit(self, seed_set) -> int:
        """Enqueue one sigma(S) query; returns its ticket id."""
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending.append((ticket, np.asarray(seed_set, np.int32)))
        return ticket

    def apply_delta(self, delta) -> int:
        """Forward a `GraphDelta` to the stream engine; returns the rows
        that went stale (the next flush answers from the new epoch)."""
        if not hasattr(self.engine, "apply_delta"):
            raise ValueError("apply_delta needs a StreamEngine")
        with self._lock:
            return self.engine.apply_delta(delta)

    def flush(self) -> dict:
        """Answer every pending query against one store state; returns
        ``{ticket: influence}``.  Without a worker, up to
        ``refresh_budget`` rows of repair follow the answers."""
        results = {}
        with obs.span("flush", tier="serve"), self._lock:
            while self._pending:
                chunk = self._pending[:self.max_batch]
                self._pending = self._pending[self.max_batch:]
                vals = self.engine.influences([s for _, s in chunk])
                results.update(
                    {t: float(v) for (t, _), v in zip(chunk, vals)})
            self.queries_served += len(results)
            self.served_epoch = getattr(self.engine, "epoch", None)
            if self.refresh_budget is not None and not self.async_refreshing:
                self.engine.refresh(self.refresh_budget)
        return results

    def influence(self, seed_set) -> float:
        """One query: submit + flush."""
        ticket = self.submit(seed_set)
        return self.flush()[ticket]

    def select(self, k: int):
        """Top-k seed selection (memoized by the engine)."""
        with self._lock:
            return self.engine.select(k)

    def metrics(self) -> dict:
        """The obs registry's snapshot (empty unless obs is enabled)."""
        return obs.snapshot()

    def drain(self, timeout: float | None = 30.0) -> bool:
        """Block until the backlog is repaired (True) or ``timeout``
        seconds pass (False; None waits forever).  With a live worker
        this waits on it; otherwise it refreshes inline in budget-row
        slices, checking the deadline between slices."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            with self._lock:
                if getattr(self.engine, "stale", 0) == 0:
                    return True
                continue_inline = not self.async_refreshing
                if continue_inline:
                    self.engine.refresh(self.refresh_budget)
            if deadline is not None and time.monotonic() > deadline:
                with self._lock:
                    return getattr(self.engine, "stale", 0) == 0
            if not continue_inline:
                time.sleep(0.002)


def _main_lm(args) -> torch.Tensor:
    cfg = get_arch(args.arch).smoke_config
    server = LMServer(cfg, device=args.device)
    prompts = prng.randint(prng.PRNGKey(1), (args.batch, args.prompt_len),
                           0, cfg.vocab, device=server.device)
    t0 = time.time()
    out = server.generate(prompts, args.gen)
    synchronize(server.device)
    dt = time.time() - t0
    print(f"[serve] {args.arch} on {server.device}: generated "
          f"{tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(out[0].tolist())
    return out


def _main_im(args, log=print) -> dict:
    """Sample a store once, answer selections and a burst of sigma(S)
    queries from it; with ``--deltas``, serve through random graph
    deltas on a `StreamEngine` and drain the backlog.  Returns the
    numbers it printed."""
    from repro_torch.configs.imm_snap import (
        IMM_EXPERIMENTS, make_im_mesh, mesh_engine_kwargs,
    )
    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.graphs.datasets import scaled_snap

    exp = IMM_EXPERIMENTS[args.graph]
    scale = exp.bench_scale if args.scale is None else args.scale
    g = scaled_snap(args.graph, scale, seed=0)
    mesh = make_im_mesh(args.mesh, device=args.device)
    mesh_kw = mesh_engine_kwargs(mesh)
    cfg = IMMConfig(k=args.k, model=args.model, backend=args.backend,
                    sampler=args.sampler, max_theta=args.max_theta,
                    store=args.store)
    if args.deltas:
        from repro_torch.stream import StreamEngine
        engine = StreamEngine(g, cfg, device=args.device, **mesh_kw)
    else:
        engine = InfluenceEngine(g, cfg, device=args.device, **mesh_kw)
    dev = engine.store.device
    t0 = time.time()
    engine.extend(args.max_theta)
    synchronize(dev)
    t_sample = time.time() - t0
    server = IMServer(
        engine,
        refresh_budget=args.refresh_budget if args.deltas else None,
        async_refresh=bool(args.deltas and args.async_refresh))
    if mesh is not None:
        log(f"[serve-im] sharded store: theta axis over "
            f"{engine.store.D} shard(s) x vertex axis over "
            f"{getattr(engine.store, 'Dv', 1)} shard(s), "
            f"cap_local={engine.store.cap_local}, "
            f"n_local={getattr(engine.store, 'n_local', g.n)}")

    # a mixed workload: top-k selections of several sizes and a burst of
    # random candidate-set influence queries, all from one store
    t0 = time.time()
    sels = {kk: server.select(kk) for kk in (5, args.k // 2 or 1, args.k)}
    rng = np.random.default_rng(0)
    tickets = [server.submit(rng.choice(g.n, size=rng.integers(1, 9),
                                        replace=False))
               for _ in range(args.queries)]
    answers = server.flush()
    dt = time.time() - t0
    n_q = len(sels) + len(tickets)
    log(f"[serve-im] {args.graph} n={g.n:,} theta={engine.theta} on "
        f"{dev}: sampled in {t_sample:.2f}s, answered {n_q} queries in "
        f"{dt:.2f}s ({n_q / max(dt, 1e-9):.1f} q/s)")
    for kk, s in sorted(sels.items()):
        log(f"  select(k={kk}): influence={s.influence:.1f} "
            f"seeds={[int(v) for v in s.seeds[:5]]}...")
    vals = [answers[t] for t in tickets[:4]]
    log(f"  sample influence answers: {[round(v, 1) for v in vals]}")
    out = {"selects": {kk: [int(v) for v in s.seeds]
                       for kk, s in sels.items()},
           "answers": [answers[t] for t in tickets], "deltas": []}

    if args.deltas:
        from repro_torch.stream import random_delta
        drng = np.random.default_rng(7)
        probe = engine.select(args.k).seeds
        for i in range(args.deltas):
            d = random_delta(engine.graph, drng, inserts=4, deletes=4,
                             reweights=4)
            stale = server.apply_delta(d)
            tickets = [server.submit(probe) for _ in range(8)]
            ans = server.flush()
            sig = ans[tickets[0]]
            log(f"  delta {i}: {len(d)} edge ops, {stale} rows stale, "
                f"epoch {server.served_epoch}, sigma(probe)={sig:.1f}, "
                f"backlog {engine.stale}")
            out["deltas"].append((stale, server.served_epoch, sig))
        if server.async_refreshing:
            if not server.drain(timeout=120.0):
                log(f"  WARNING: async drain timed out with "
                    f"{engine.stale} rows still stale; finishing inline")
                while engine.stale:
                    engine.refresh(args.refresh_budget)
            server.stop_refresh_worker()
            log(f"  async worker ran {server.refreshes_run} repair "
                f"slice(s)")
        else:
            while engine.stale:
                engine.refresh(args.refresh_budget)
        final = engine.select(args.k)
        log(f"  drained: epoch {engine.epoch} consistent, "
            f"select(k={args.k}) influence={final.influence:.1f}")
        out["final"] = ([int(v) for v in final.seeds], final.influence)
    return out


def _main_tier(args) -> dict:
    """The IMServe tier over ``--tenants`` campaigns (static and
    streaming alternating; tenant 2 relaxed-SLO with ``--replicas``
    replicas when there are any), a Zipf-skewed Poisson trace of queries
    and deltas replayed in arrival order with the refresh worker
    running, then a drain.  Returns the numbers it printed."""
    from repro_torch.configs.imm_snap import make_im_mesh, mesh_engine_kwargs
    from repro_torch.core.engine import IMMConfig
    from repro_torch.graphs import rmat_graph
    from repro_torch.serve import (
        IMServe, TenantSpec, make_trace, replay, trace_summary, zipf_rates,
    )

    mesh_kw = mesh_engine_kwargs(make_im_mesh(args.mesh, device=args.device))
    cfg = IMMConfig(k=args.k, batch=min(args.max_theta, 256),
                    max_theta=max(args.max_theta, 1 << 20), seed=0,
                    store=args.store)
    tier = IMServe(quantum=args.quantum, refresh_budget=args.refresh_budget,
                   mesh_kwargs=mesh_kw, device=args.device)
    graphs, stream_map = {}, {}
    for i in range(args.tenants):
        name = f"tenant{i}"
        streaming = i % 2 == 1
        relaxed = args.replicas > 0 and i == 2 % max(args.tenants, 1)
        g = rmat_graph(args.tier_n, args.tier_n * 8, seed=10 + i,
                       weighted_ic="wc")
        tier.register(TenantSpec(
            name, graph=g, cfg=cfg, theta=args.max_theta,
            streaming=streaming,
            slo="relaxed" if relaxed else "strict",
            replicas=args.replicas if relaxed else 0,
            max_pending=args.max_pending))
        graphs[name], stream_map[name] = g, streaming
    print(f"[serve-tier] {args.tenants} tenants x n={args.tier_n} "
          f"(theta={args.max_theta}, mesh={args.mesh or 1}) registered")

    events = make_trace(
        graphs, duration=args.duration,
        qps=zipf_rates(sorted(graphs), args.qps, args.skew,
                       np.random.default_rng(1)),
        streaming=stream_map, delta_period=args.duration / 4,
        seed=2)
    print(f"[serve-tier] trace: {len(events)} events "
          f"{trace_summary(events)}")
    tier.start_refresh_worker()
    t0 = time.time()
    answered, rejected = replay(tier, events, pump_every=args.quantum * 2)
    wall = time.time() - t0
    drained = tier.drain(timeout=60.0)
    tier.close()
    lat = sorted(tier.result(t).latency_s for t in answered)
    stats = tier.stats()
    print(f"[serve-tier] {len(answered)} answered / {rejected} rejected "
          f"in {wall:.2f}s ({len(answered) / max(wall, 1e-9):.1f} q/s), "
          f"p50={lat[len(lat) // 2] * 1e3:.1f}ms "
          f"p99={lat[int(len(lat) * 0.99)] * 1e3:.1f}ms")
    print(f"[serve-tier] cache {stats['cache']}, "
          f"refresh {stats.get('refresh')}, drained={drained}")
    for name, ts in sorted(stats["tenants"].items()):
        print(f"  {name}: served={ts['served']} rejected={ts['rejected']} "
              f"cache_hits={ts['cache_hits']} epoch={ts['epoch']} "
              f"refreshes={ts['refreshes']}")
    return {"answered": answered, "rejected": rejected, "drained": drained,
            "stats": stats}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm", choices=("lm", "im", "tier"))
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--graph", default="com-Amazon")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--model", default="IC",
                    choices=("IC", "WC", "GT", "LT"))
    ap.add_argument("--backend", default=None,
                    choices=("dense", "sparse", "pallas", "walk"),
                    help="traversal backend (default: auto by model/n)")
    ap.add_argument("--sampler", default=None,
                    help="full sampler-name override, e.g. 'LT/walk'")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--max-theta", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--deltas", type=int, default=0,
                    help="IM workload: apply N random graph deltas and "
                         "serve through them (StreamEngine)")
    ap.add_argument("--refresh-budget", type=int, default=1024,
                    help="stale rows repaired between flushes in "
                         "--deltas mode")
    ap.add_argument("--async-refresh", action="store_true",
                    help="--deltas mode: repair on a background worker "
                         "thread instead of inside flush")
    ap.add_argument("--store", default="auto",
                    choices=("auto", "bitmap", "indices", "packed",
                             "compressed"),
                    help="IM arena at-rest representation")
    ap.add_argument("--mesh", default=None,
                    help="IM store mesh: int or 'auto' (1D theta "
                         "sharding), 'RxC' e.g. '2x2' (2D theta x "
                         "vertex), or omit for single-device")
    ap.add_argument("--tenants", type=int, default=4,
                    help="tier workload: campaigns to register")
    ap.add_argument("--tier-n", type=int, default=512,
                    help="tier workload: vertices per tenant graph")
    ap.add_argument("--duration", type=float, default=1.0,
                    help="tier workload: trace length (virtual seconds)")
    ap.add_argument("--qps", type=float, default=256.0,
                    help="tier workload: total query arrival rate")
    ap.add_argument("--skew", type=float, default=1.0,
                    help="tier workload: Zipf exponent of per-tenant "
                         "traffic shares")
    ap.add_argument("--quantum", type=int, default=8,
                    help="tier workload: DRR quantum per round")
    ap.add_argument("--replicas", type=int, default=1,
                    help="tier workload: read replicas for the "
                         "relaxed-SLO tenant (0 disables)")
    ap.add_argument("--max-pending", type=int, default=1024,
                    help="tier workload: per-tenant admission queue cap")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default) or 'cpu' (the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--metrics-out", default=None,
                    help="enable repro_torch.obs and write the metrics "
                         "registry's JSON snapshot here at exit")
    ap.add_argument("--trace-out", default=None,
                    help="enable repro_torch.obs and write the Chrome "
                         "trace-event JSON here at exit")
    args = ap.parse_args(argv)
    if args.metrics_out or args.trace_out:
        obs.enable()
    run = {"tier": _main_tier, "im": _main_im, "lm": _main_lm}
    out = run[args.workload](args)
    if args.metrics_out:
        print(f"[obs] metrics -> {obs.write_metrics(args.metrics_out)}")
    if args.trace_out:
        print(f"[obs] trace -> {obs.write_trace(args.trace_out)}")
    return out


if __name__ == "__main__":
    main()
