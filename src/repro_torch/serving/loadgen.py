"""Open-loop load generation: offered QPS, not achieved QPS.

PyTorch counterpart of ``repro.serving.loadgen`` (numpy only).

A closed-loop driver (issue, wait, issue) slows itself down exactly when
the server slows down, so its latency numbers silently exclude the
overload region — the classic *coordinated omission* trap. This harness is
**open-loop**: query arrivals are a Poisson process at a configured
*offered* rate, drawn up front (:func:`poisson_arrivals`), and each
arrival is submitted at its scheduled time whether or not earlier queries
have finished. Under overload the bounded admission queue sheds load
(``FrontendOverloadError`` rejects are counted, not retried) and the
latency of *accepted* requests stays bounded — which is the whole point of
reject-on-full backpressure, now measured instead of asserted.

Two further methodology choices:

* **Latency is measured from the scheduled arrival time**, not from the
  moment the driver got around to submitting — a late submit is the
  driver's queueing delay and the client would have experienced it.
* **Replica fleets are driven round-robin from one loop**, each replica's
  scheduler ticked at its own ``tick_interval`` cadence. A replica's
  capacity is therefore its admission budget (``max_batch`` rows per
  tick), the same knob that bounds it in production; aggregate goodput
  scaling with replica count is measured against that per-replica budget.

Everything is injectable (``clock``, ``sleep``, the arrival seed), so the
deterministic replication suite drives the identical code path on a fake
clock with zero real waiting; the smoke run on the card runs it on wall
time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np

from .scheduler import FrontendOverloadError

__all__ = ["poisson_arrivals", "OpenLoopReport", "run_open_loop"]


def poisson_arrivals(offered_qps: float, duration_s: float,
                     seed: int = 0) -> np.ndarray:
    """Arrival times (seconds, ascending, < ``duration_s``) of a Poisson
    process at rate ``offered_qps`` — i.i.d. exponential inter-arrivals
    from a fixed-seed generator, so a sweep re-runs the same schedule.
    """
    if offered_qps <= 0:
        raise ValueError(f"offered_qps must be > 0, got {offered_qps}")
    rng = np.random.default_rng(seed)
    # draw in one vectorised batch with safety margin, extend if unlucky
    n_expect = max(16, int(offered_qps * duration_s * 1.5) + 16)
    gaps = rng.exponential(1.0 / offered_qps, n_expect)
    t = np.cumsum(gaps)
    while t.size and t[-1] < duration_s:  # pragma: no cover - rare tail
        more = rng.exponential(1.0 / offered_qps, n_expect)
        t = np.concatenate([t, t[-1] + np.cumsum(more)])
    return t[t < duration_s]


@dataclasses.dataclass
class OpenLoopReport:
    """One open-loop run at one offered rate (all latencies in ms)."""

    offered_qps: float
    duration_s: float          # configured arrival window
    elapsed_s: float           # wall time until the last response resolved
    submitted: int             # arrivals accepted by admission
    rejected: int              # arrivals shed by reject-on-full
    completed: int             # responses resolved
    failures: int              # responses resolved with a dispatch error
    timeouts: int              # responses never resolved within the guard
    achieved_qps: float        # completed / elapsed
    p50_ms: float
    p95_ms: float
    p99_ms: float

    @property
    def reject_rate(self) -> float:
        total = self.submitted + self.rejected
        return self.rejected / total if total else 0.0

    def row(self) -> dict:
        """Flat dict for benchmark JSON snapshots."""
        out = dataclasses.asdict(self)
        out["reject_rate"] = round(self.reject_rate, 4)
        return out


def _percentiles_ms(latency_s: List[float]) -> Tuple[float, float, float]:
    if not latency_s:
        nan = float("nan")
        return nan, nan, nan
    lat = np.asarray(latency_s, np.float64) * 1e3
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 95)),
            float(np.percentile(lat, 99)))


def run_open_loop(
    servers,
    queries: np.ndarray,
    *,
    offered_qps: float,
    duration_s: float,
    n_neighbors: int = 10,
    seed: int = 0,
    clock=time.monotonic,
    sleep=time.sleep,
    max_sleep_s: float = 0.002,
    drain_timeout_s: float = 30.0,
    on_submit=None,
) -> OpenLoopReport:
    """Drive one server — or a replica fleet, round-robin — open-loop.

    Args:
      servers:      a ``ZenServer`` with an attached frontend, or a
                    sequence of them (each arrival goes to ``servers[i %
                    R]``). ``launch.replicate.QueryReplica`` fleets pass
                    ``[r.server for r in replicas]``.
      queries:      (M, m) pool of query vectors; arrival ``i`` submits row
                    ``i % M`` (one row per arrival, so offered QPS is in
                    queries/second).
      offered_qps:  Poisson arrival rate.
      duration_s:   arrival window; the loop then drains outstanding
                    handles (bounded by ``drain_timeout_s``).
      clock/sleep:  injectable time sources. The deterministic tests pass a
                    fake clock and ``sleep=clock.advance`` so the identical
                    loop runs with zero real waiting.
      max_sleep_s:  idle-wait quantum between events (wall-clock runs).
      on_submit:    optional hook ``(arrival_index, server_index)`` — the
                    simulation suite uses it to interleave churn/publish/
                    poll at exact points.

    Returns an :class:`OpenLoopReport`. Per-server capacity is the
    admission budget: each scheduler is ticked at most once per its
    ``tick_interval``, dispatching at most ``max_batch`` rows — so a fleet
    of R replicas has R× the admission budget of one, and the report
    measures how much of that budget turns into goodput at this offered
    rate.
    """
    fleet = list(servers) if isinstance(servers, (list, tuple)) else [servers]
    if not fleet:
        raise ValueError("need at least one server")
    for s in fleet:
        if s.frontend is None:
            raise ValueError(
                "open-loop driving needs the micro-batched frontend "
                "(ZenServer(frontend=True)): backpressure and admission "
                "budgets live there")
    q = np.asarray(queries, np.float32)
    arrivals = poisson_arrivals(offered_qps, duration_s, seed)
    t0 = clock()
    next_tick = [0.0] * len(fleet)
    pending: List[Tuple[object, float]] = []  # (handle, scheduled arrival)
    latency_s: List[float] = []
    submitted = rejected = completed = failures = 0
    i = 0
    while True:
        now = clock() - t0
        # 1) submit every arrival that is due
        while i < len(arrivals) and arrivals[i] <= now:
            target = i % len(fleet)
            if on_submit is not None:
                on_submit(i, target)
            try:
                handle = fleet[target].frontend.submit(
                    q[i % q.shape[0]], n_neighbors)
            except FrontendOverloadError:
                rejected += 1
            else:
                submitted += 1
                pending.append((handle, arrivals[i]))
            i += 1
        # 2) tick each scheduler at its own cadence (admission budget)
        for j, s in enumerate(fleet):
            if now >= next_tick[j]:
                s.frontend.tick()
                next_tick[j] = now + s.frontend.tick_interval
        # 3) reap resolved handles (latency from scheduled arrival)
        if pending:
            now = clock() - t0
            still = []
            for handle, t_arr in pending:
                if handle.done():
                    try:
                        handle.result(0)
                    except Exception:  # noqa: BLE001 - counted, not raised
                        failures += 1
                    else:
                        completed += 1
                        latency_s.append(now - t_arr)
                else:
                    still.append((handle, t_arr))
            pending = still
        # 4) done? (all arrivals submitted, nothing outstanding)
        if i >= len(arrivals) and not pending:
            break
        # drain guard: a dead ticker must not hang the harness forever
        if now > duration_s + drain_timeout_s:
            break
        # 5) idle until the next event
        targets = [next_tick[j] for j in range(len(fleet))]
        if i < len(arrivals):
            targets.append(float(arrivals[i]))
        dt = min(targets) - (clock() - t0)
        if dt > 0:
            sleep(min(dt, max_sleep_s))
    timeouts = len(pending)
    elapsed = max(clock() - t0, 1e-9)
    p50, p95, p99 = _percentiles_ms(latency_s)
    return OpenLoopReport(
        offered_qps=float(offered_qps), duration_s=float(duration_s),
        elapsed_s=float(elapsed), submitted=submitted, rejected=rejected,
        completed=completed, failures=failures, timeouts=timeouts,
        achieved_qps=completed / elapsed, p50_ms=p50, p95_ms=p95,
        p99_ms=p99)
