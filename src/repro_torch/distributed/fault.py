"""Fault-tolerance & straggler-mitigation runtime hooks.

PyTorch counterpart of ``repro.distributed.fault`` (pure Python). The
hooks themselves are per process; the multi-process trainer
(``launch.train --multihost``) agrees their inputs across processes every
step (``distributed.process.all_gather_object``): each process's
``StepMonitor`` is fed the slowest process's step time and the
preemption flags are OR'd, so every process saves, escalates or stops at
the same step. The serving tier's signals stay in-process hooks:

* **StepMonitor** — per-step wall-time EMA; flags a straggler when a step
  exceeds ``threshold x`` the EMA. On a real pod the per-host step times are
  all-gathered (a tiny host-side all-gather after the step); the slowest
  host is reported and, past a patience budget, the policy asks the runner to
  (a) rebalance input shards away from the slow host, then (b) checkpoint and
  re-launch without it (elastic restart).
* **HeartbeatRegistry** — liveness bookkeeping with a deadline; a missed
  heartbeat marks the host failed and triggers the elastic-restart path.
* **ReplicaTracker** — the replicated serving tier's leader-side view of
  its replicas: liveness and the generation each one serves.
* **PreemptionGuard** — the SIGTERM hook: save synchronously at the next
  step (or tick) boundary when the platform announces preemption.

The serving path (``launch.serve.ZenServer.enable_fault_tolerance``) and
the replicated tier (``launch.replicate``) wire these in; the tests drive
them with a fake clock.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ema: float
    ratio: float


class StepMonitor:
    def __init__(self, *, ema_decay: float = 0.9, threshold: float = 2.0,
                 warmup_steps: int = 5, patience: int = 3):
        self.ema_decay = ema_decay
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.patience = patience
        self.ema: Optional[float] = None
        self.n = 0
        self.consecutive = 0
        self.events: list[StragglerEvent] = []

    def record(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        """Feed one step's wall time; returns an event when flagged."""
        self.n += 1
        if self.ema is None:
            self.ema = step_time
            return None
        flagged = None
        if step_time > self.threshold * self.ema:
            # never fold a straggler into the EMA (keep the baseline honest)
            # — warmup included, where absorbing one would inflate the EMA
            # enough to hide every later straggler behind the raised bar
            if self.n > self.warmup_steps:
                self.consecutive += 1
                flagged = StragglerEvent(step, step_time, self.ema,
                                         step_time / self.ema)
                self.events.append(flagged)
        else:
            self.consecutive = 0
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * step_time
        return flagged

    @property
    def should_escalate(self) -> bool:
        """Patience exhausted -> checkpoint + elastic restart."""
        return self.consecutive >= self.patience


class HeartbeatRegistry:
    """Liveness bookkeeping over an *expected* membership.

    ``register(host)`` declares that a host is supposed to beat; a host that
    registers (or is registered by the deployment) and then never beats is
    reported dead one deadline after registration — silence from birth is
    indistinguishable from an early crash and must not be invisible.
    ``beat`` on an unknown host implicitly registers it.
    """

    def __init__(self, deadline_s: float = 60.0, now: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self._now = now
        self._last: Dict[str, float] = {}        # host -> last beat time
        self._registered: Dict[str, float] = {}  # host -> registration time

    def register(self, host: str) -> None:
        """Declare expected membership (idempotent; keeps the first time)."""
        self._registered.setdefault(host, self._now())

    def beat(self, host: str) -> None:
        self._registered.setdefault(host, self._now())
        self._last[host] = self._now()

    def expected(self) -> list[str]:
        return sorted(self._registered)

    def _deadline_ref(self, host: str) -> float:
        """Last beat, or registration time for a host that never beat."""
        return self._last.get(host, self._registered[host])

    def dead_hosts(self) -> list[str]:
        t = self._now()
        return [h for h in self.expected()
                if t - self._deadline_ref(h) > self.deadline_s]

    def alive(self) -> list[str]:
        t = self._now()
        return sorted(h for h in self.expected()
                      if t - self._deadline_ref(h) <= self.deadline_s)


class ReplicaTracker:
    """Leader-side bookkeeping of a query-plane replica fleet.

    The replicated serving tier (``launch.replicate``) is pull-based —
    replicas poll the publish directory and swap on their own schedule — so
    the leader cannot *assume* coherence; it can only observe it. Each
    replica's supervisor calls :meth:`report` with the generation it is
    currently serving; the tracker folds that into a
    :class:`HeartbeatRegistry` (silence past the deadline = dead replica)
    and answers the two operator questions: who is alive, and who is still
    serving an older generation than the latest publish (*lagging* — legal,
    the replica keeps serving its old snapshot, but worth surfacing when a
    publish is not being picked up).
    """

    def __init__(self, deadline_s: float = 60.0,
                 now: Callable[[], float] = time.monotonic):
        self.heartbeats = HeartbeatRegistry(deadline_s=deadline_s, now=now)
        self._generation: Dict[str, int] = {}

    def report(self, replica: str, generation: int) -> None:
        """One replica status beat: the generation it currently serves."""
        self.heartbeats.beat(replica)
        self._generation[str(replica)] = int(generation)

    def generation_of(self, replica: str) -> Optional[int]:
        return self._generation.get(str(replica))

    def lagging(self, published_generation: int) -> list[str]:
        """Alive replicas serving a generation older than the published one
        (a replica that never reported counts as lagging from generation
        -1 — silence must not read as coherence)."""
        return [r for r in self.heartbeats.alive()
                if self._generation.get(r, -1) < published_generation]

    def coherent(self, published_generation: int) -> bool:
        """True when every *alive* replica serves the published generation."""
        return not self.lagging(published_generation)

    def status(self, published_generation: int) -> dict:
        """Operator snapshot: liveness + lag against the given publish."""
        return {
            "published_generation": int(published_generation),
            "replicas": dict(sorted(self._generation.items())),
            "alive": self.heartbeats.alive(),
            "dead": self.heartbeats.dead_hosts(),
            "lagging": self.lagging(published_generation),
        }


class PreemptionGuard:
    """SIGTERM-aware save trigger: ``if guard.should_save(): ckpt.save(...)``."""

    def __init__(self, install_signal: bool = True):
        self._flag = False
        if install_signal:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self._flag = True

    def request(self) -> None:  # manual trigger (tests / platform hook)
        self._flag = True

    def should_save(self) -> bool:
        return self._flag

    def clear(self) -> None:
        self._flag = False
