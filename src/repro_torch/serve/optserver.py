"""Optimization-as-a-service: async co-optimization server with
continuous request batching and a persistent sweep cache (DESIGN.md
§14) — the port's copy of the JAX package's ``serve/optserver.py``.

Every MCMComm solver is a batched engine behind
:mod:`repro_torch.core.sweep` (the torch backend on the card); this
module gives those engines a serving path. Architecture (queue →
coalescer → engine worker → cache store)::

    submit() ──► bounded queue ──► worker thread
                                     │  drain ≤ max_batch requests
                                     │  validate (BadRequest firewall)
                                     │  coalesce by CallKey (§14)
                                     ├─► eval_sweep / solve_grid /
                                     │   pipeline_sweep   (ONE call per
                                     │   group; shape-grouped batched
                                     │   calls inside)
                                     ├─► futures ◄─ per-request results
                                     └─► CacheStore.append (new
                                         fingerprints only)

Contracts:

* **solo == served** — a request's result is bit-identical to the same
  point solved through a direct solo sweep call: coalescing only routes
  points into the §9 batched calls, which are exact solo == batched;
  every budget is a deterministic count, never wall-clock.
* **Bad-request isolation** — malformed requests are rejected with
  :class:`~repro_torch.serve.coalesce.BadRequest` on their own future; the
  worker and the cohort batch keep going.
* **Retry with restore** — a transient engine failure re-runs the
  coalesced call (``max_retries``); persistent failures fall back to
  per-request solo calls so one poisoned request cannot take down its
  cohort, and only the guilty request errors.
* **Crash-safe persistence** — newly computed cache entries append to a
  versioned on-disk store (:mod:`repro_torch.serve.cache_store`) every
  ``flush_every`` batches; a killed server resumes from the store with
  no recomputation of completed points (the chaos test in
  ``tests/test_torch_optserver.py``).

Observability: :meth:`OptServer.stats` reports requests/s, p50/p99
latency, cache hit-rate, coalesce factor, retry/reject/straggler
counts — the straggler EWMA rides
:class:`repro_torch.runtime.fault_tolerance.StragglerMonitor` over batch
wall-times.

The torch backend runs on ``device`` (``None``: the card, raising
without one), forwarded to every sweep call; the worker thread launches
the kernels, so the port's kernel build is safe across threads
(:mod:`repro_torch.kernels._build`).

CLI demo (closed-loop mixed traffic against an in-process server)::

    PYTHONPATH=src python -m repro_torch.serve.optserver --requests 64 \\
        --store build/sweep-cache.bin [--devices M] [--device cpu]
"""
from __future__ import annotations

import argparse
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any

from ..core import sweep
from ..runtime.fault_tolerance import StragglerMonitor
from .cache_store import CacheStore
from .coalesce import BadRequest, CallKey, OptRequest

__all__ = ["OptServer", "ServerOverloaded", "OptRequest", "BadRequest"]


class ServerOverloaded(RuntimeError):
    """Bounded-queue backpressure: the request queue is full."""


class _Pending:
    __slots__ = ("req", "future", "t_submit")

    def __init__(self, req: OptRequest, future: Future, t_submit: float):
        self.req = req
        self.future = future
        self.t_submit = t_submit


class OptServer:
    """Long-running optimization server over the batched sweep engines.

    ``submit`` returns a :class:`concurrent.futures.Future` per request;
    results stream back as the worker completes coalesced batches.
    ``store_path`` enables the persistent cache: loaded into the
    process-wide sweep cache on startup, appended to as requests
    complete, full-saved (atomic rename) on :meth:`close`.
    """

    def __init__(self, store_path: str | None = None,
                 max_queue: int = 256, max_batch: int = 64,
                 max_retries: int = 2, flush_every: int = 1,
                 cache: bool = True,
                 devices: str | None = None,
                 straggler: StragglerMonitor | None = None,
                 autostart: bool = True, log=None, device=None):
        self.max_batch = max(1, int(max_batch))
        self.max_retries = max(0, int(max_retries))
        self.flush_every = max(1, int(flush_every))
        self.cache = cache
        # §15 execution knob forwarded to every coalesced sweep call;
        # result-neutral and fingerprint-invisible, so a sharded server
        # shares its store with single-device clients. None defers to
        # each request's options/config.
        self.devices = devices
        # Where the torch backend runs (None: the card), forwarded to
        # every sweep call; the numpy backend ignores it.
        self.device = device
        self.monitor = straggler or StragglerMonitor()
        self.log = log or (lambda msg: None)
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._inflight = 0
        self._batches_since_flush = 0
        self._t_start = time.perf_counter()
        self._latencies: list[float] = []
        self._counts = {"submitted": 0, "completed": 0, "failed": 0,
                        "rejected": 0, "retries": 0, "batches": 0,
                        "coalesced": 0, "solo_fallbacks": 0}
        self._cache_base = sweep.cache_stats()

        self._store: CacheStore | None = None
        self._persisted: set = set()
        self.store_info: dict[str, Any] = {"loaded": 0}
        if store_path is not None:
            self._store = CacheStore(store_path)
            entries = self._store.load()
            loaded = sweep.import_cache(entries) if self.cache else 0
            self._persisted = set(entries)
            self.store_info = {"loaded": loaded,
                               "cold_start": self._store.last_load.cold_start,
                               "reason": self._store.last_load.reason,
                               "torn_tail": self._store.last_load.torn_tail}
            if self._store.last_load.cold_start:
                self.log(f"[optserve] cold start: "
                         f"{self._store.last_load.reason}")
            else:
                self.log(f"[optserve] restored {loaded} cache entries")

        # Dispatch table — tests monkeypatch entries to inject transient
        # failures (retry-with-restore) without faking sweep internals.
        self._calls = {"eval": sweep.eval_sweep,
                       "solve": sweep.solve_grid,
                       "pipeline": sweep.pipeline_sweep}
        if autostart:
            self.start()

    # -------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker,
                                        name="optserve-worker", daemon=True)
        self._thread.start()

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every submitted request has resolved (or timeout);
        returns True when drained."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                idle = self._inflight == 0
            if idle and self._queue.empty():
                return True
            time.sleep(0.002)
        return False

    def close(self, timeout: float = 60.0) -> None:
        """Graceful shutdown: drain, stop the worker, full-save the
        store (atomic rename)."""
        self.drain(timeout)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._store is not None and self.cache:
            self._store.save(sweep.export_cache())

    def kill(self) -> None:
        """Crash simulation (chaos tests): stop the worker immediately,
        *without* the final save — only incrementally appended entries
        survive, exactly like a SIGKILL between batches."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    # ----------------------------------------------------------- submit
    def submit(self, req: OptRequest | None = None, *, block: bool = True,
               timeout: float | None = None, **kw) -> Future:
        """Enqueue one request; returns its future. ``kw`` builds an
        :class:`OptRequest` when ``req`` is not given. A full queue
        raises :class:`ServerOverloaded` (immediately when
        ``block=False``, after ``timeout`` otherwise) — bounded-queue
        backpressure, the client's signal to slow down."""
        if req is None:
            req = OptRequest(**kw)
        fut: Future = Future()
        item = _Pending(req, fut, time.perf_counter())
        try:
            self._queue.put(item, block=block, timeout=timeout)
        except queue.Full:
            raise ServerOverloaded(
                f"request queue full ({self._queue.maxsize}); retry later"
            ) from None
        with self._lock:
            self._counts["submitted"] += 1
            self._inflight += 1
        return fut

    def submit_nowait(self, req: OptRequest | None = None, **kw) -> Future:
        return self.submit(req, block=False, **kw)

    async def submit_async(self, req: OptRequest | None = None,
                           **kw) -> Any:
        """Asyncio adapter: await the served result. The blocking
        backpressure ``put`` runs off-loop."""
        import asyncio

        fut = await asyncio.to_thread(self.submit, req, **kw)
        return await asyncio.wrap_future(fut)

    # ----------------------------------------------------------- worker
    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as e:   # pragma: no cover — last-ditch guard
                for p in batch:
                    if not p.future.done():
                        self._resolve(p, failed=True, latency=False)
                        p.future.set_exception(e)

    def _run_batch(self, batch: list[_Pending]) -> None:
        valid: list[_Pending] = []
        for p in batch:
            try:
                p.req.validate()
            except BadRequest as e:
                # counters first: a client that sees the future resolve
                # must already see it reflected in stats()
                self._resolve(p, rejected=True)
                p.future.set_exception(e)
            else:
                valid.append(p)
        if not valid:
            return
        by_key: dict[CallKey, list[_Pending]] = {}
        for p in valid:
            by_key.setdefault(p.req.call_key(), []).append(p)
        for key, items in by_key.items():
            t0 = time.perf_counter()
            self._serve_group(key, items)
            dt = time.perf_counter() - t0
            with self._lock:
                self._counts["batches"] += 1
                self._counts["coalesced"] += len(items)
                n = self._counts["batches"]
            if self.monitor.observe(n - 1, dt):
                self.log(f"[optserve] straggler batch {n - 1}: "
                         f"{dt:.3f}s vs ewma {self.monitor.ewma:.3f}s")
        self._batches_since_flush += 1
        if self._batches_since_flush >= self.flush_every:
            self._flush()
            self._batches_since_flush = 0

    def _dispatch(self, key: CallKey, reqs: list[OptRequest]) -> list:
        pts = [r.point for r in reqs]
        if key.kind == "eval":
            return self._calls["eval"](pts, backend=key.backend,
                                       cache=self.cache,
                                       devices=self.devices,
                                       device=self.device)
        if key.kind == "solve":
            return self._calls["solve"](pts, key.objective, key.cfg,
                                        backend=key.backend,
                                        cache=self.cache,
                                        method=key.method,
                                        devices=self.devices,
                                        device=self.device)
        return self._calls["pipeline"](pts, key.cfg, backend=key.backend,
                                       cache=self.cache,
                                       devices=self.devices,
                                       device=self.device)

    def _serve_group(self, key: CallKey, items: list[_Pending]) -> None:
        """One coalesced call, with retry-with-restore and solo-fallback
        isolation."""
        last_err: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                results = self._dispatch(key, [p.req for p in items])
            except Exception as e:
                last_err = e
                if attempt < self.max_retries:
                    with self._lock:
                        self._counts["retries"] += 1
                    self.log(f"[optserve] {key.kind} batch error "
                             f"{e!r}; retrying "
                             f"({attempt + 1}/{self.max_retries})")
                    continue
                break
            for p, res in zip(items, results):
                self._resolve(p)
                p.future.set_result(res)
            return
        # Retries exhausted: isolate the failure — serve each request
        # solo so only the guilty one errors.
        self.log(f"[optserve] {key.kind} batch failed after "
                 f"{self.max_retries} retries ({last_err!r}); "
                 f"falling back to solo serves")
        with self._lock:
            self._counts["solo_fallbacks"] += 1
        for p in items:
            try:
                res = self._dispatch(key, [p.req])[0]
            except Exception as e:
                self._resolve(p, failed=True)
                p.future.set_exception(e)
            else:
                self._resolve(p)
                p.future.set_result(res)

    def _resolve(self, p: _Pending, failed: bool = False,
                 rejected: bool = False, latency: bool = True) -> None:
        dt = time.perf_counter() - p.t_submit
        with self._lock:
            self._inflight -= 1
            if rejected:
                self._counts["rejected"] += 1
            elif failed:
                self._counts["failed"] += 1
            else:
                self._counts["completed"] += 1
                if latency:
                    self._latencies.append(dt)

    # ------------------------------------------------------ persistence
    def _flush(self) -> None:
        """Append cache entries added since the last flush to the store.
        Append-only + crc-framed records: a crash mid-flush tears at
        most the tail record, which the next load drops."""
        if self._store is None or not self.cache:
            return
        snap = sweep.export_cache()
        new = {k: v for k, v in snap.items() if k not in self._persisted}
        if new:
            self._store.append(new)
            self._persisted.update(new)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict[str, Any]:
        """Service metrics: throughput, latency percentiles, cache
        hit-rate (since server start), coalesce factor, fault counters,
        straggler EWMA state."""
        with self._lock:
            counts = dict(self._counts)
            lat = sorted(self._latencies)
            inflight = self._inflight
        elapsed = time.perf_counter() - self._t_start
        cs = sweep.cache_stats()
        hits = cs["hits"] - self._cache_base["hits"]
        misses = cs["misses"] - self._cache_base["misses"]
        lookups = hits + misses

        def pct(q: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(q * len(lat)))]

        return {
            **counts,
            "inflight": inflight,
            "elapsed_s": elapsed,
            "requests_per_s": counts["completed"] / elapsed
            if elapsed > 0 else 0.0,
            "p50_ms": pct(0.50) * 1e3,
            "p99_ms": pct(0.99) * 1e3,
            "coalesce_factor": (counts["coalesced"] / counts["batches"]
                                if counts["batches"] else 0.0),
            "cache_hits": hits,
            "cache_misses": misses,
            "cache_hit_rate": hits / lookups if lookups else 0.0,
            "stragglers": len(self.monitor.flagged),
            "batch_ewma_s": self.monitor.ewma,
            "store": dict(self.store_info,
                          persisted=len(self._persisted)),
        }


# ----------------------------------------------------------------- CLI
def _demo_requests(n: int):
    """Mixed closed-loop demo traffic: evaluations across workloads ×
    grids × congestion modes, plus pipelining instances."""
    import numpy as np

    from ..core import EvalOptions, make_hw
    from ..core.workload import uniform_partition
    from ..graphs import WORKLOADS

    rng = np.random.default_rng(0)
    hws = [make_hw(t, g, "hbm") for t in "AB" for g in (2, 4)]
    tasks = [WORKLOADS[w](batch=1) for w in ("alexnet", "vit")]
    reqs = []
    for i in range(n):
        task = tasks[i % len(tasks)]
        hw = hws[i % len(hws)]
        opts = EvalOptions(redistribution=bool(i % 2), async_exec=True)
        if i % 5 == 4:
            segs = [(f"op{j}", float(rng.uniform(0.1, 1)),
                     float(rng.uniform(0.5, 2)),
                     float(rng.uniform(0.1, 1))) for j in range(4)]
            reqs.append(OptRequest(
                "pipeline", sweep.PipelinePoint(segs, 4 + i % 3)))
        else:
            part = uniform_partition(task, hw.X, hw.Y)
            reqs.append(OptRequest(
                "eval", sweep.EvalPoint(task, hw, opts, part)))
    return reqs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="MCMComm optimization server demo: serve mixed "
                    "closed-loop traffic in-process and print stats.")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--store", default=None,
                    help="persistent sweep-cache store path")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--devices", default=None,
                    choices=("single", "sharded", "auto"),
                    help="§15 sweep sharding mode (default: per-request)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the torch backend on the host)")
    args = ap.parse_args(argv)

    srv = OptServer(store_path=args.store, max_batch=args.max_batch,
                    devices=args.devices, log=print, device=args.device)
    futs = [srv.submit(r) for r in _demo_requests(args.requests)]
    for f in futs:
        f.result(timeout=300)
    st = srv.stats()
    srv.close()
    print(f"[optserve] served {st['completed']}/{st['submitted']} "
          f"requests in {st['elapsed_s']:.2f}s "
          f"({st['requests_per_s']:.1f} req/s, coalesce "
          f"{st['coalesce_factor']:.1f}x, p50 {st['p50_ms']:.1f}ms "
          f"p99 {st['p99_ms']:.1f}ms, cache hit-rate "
          f"{st['cache_hit_rate'] * 100:.0f}%)")
    if args.store:
        print(f"[optserve] store: {st['store']}")


if __name__ == "__main__":
    main()
