"""Session-oriented serving front door: one streaming API over live and
simulated backends.

Production LLM servers are driven through an open-loop, streaming request
interface (vLLM's ``add_request``/``step`` engine loop, Mooncake's
conductor), not a ``run(all_requests) -> summary`` batch call.  This
module is that interface for both of this repo's serving paths:

* ``ServingBackend`` — the protocol the event-driven live
  ``Orchestrator`` (serving/orchestrator.py) and the analytical
  ``ClusterSim`` (serving/cluster.py) both implement: ``start``,
  ``submit(req) -> StreamHandle``, ``step`` / ``step_until``, ``abort``,
  ``drain``, plus ``metrics`` / ``fleet`` / ``summary`` views.  Both
  backends share the ``serving/clock.py`` virtual clock, so the protocol's
  time arguments are virtual seconds on either path.
* ``StreamHandle`` — a per-request event stream: phase transitions and
  per-token events (token id + virtual commit timestamp) drain as they
  are committed, ending in a terminal ``completed`` / ``aborted`` /
  ``rejected`` event.  ``cancel()`` aborts the request: its decode slot
  and paged blocks are freed immediately and every surviving stream is
  bit-unchanged (greedy decode rows are independent).
* ``Server`` — the front class: wraps either backend, adds admission
  backpressure (``admission_limit`` bounds in-flight requests; overflow
  is REJECTED, recorded explicitly in ``Metrics``), and provides the two
  canonical drive modes — ``run`` (open-loop: workload arrival stamps ARE
  the virtual submission times, so a streaming run is event-for-event
  identical to the legacy batch path) and ``run_closed_loop`` (each
  completion triggers the next submission — saturation experiments, see
  ``workload.ClosedLoopClients``).

Every benchmark, example, scenario test and the ``launch/serve.py`` CLI
drives serving through this surface; backend choice is a constructor
argument, nothing more.  The shared semantics are pinned by
tests/test_backend_contract.py against both backends.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Set)

from .autoscale import (AutoscaleConfig, FleetSignals, SLOAutoscaler)
from .clock import VirtualClock
from .fairshare import FairShareScheduler, SchedulerConfig
from .request import Metrics, Outcome, Phase, Request

__all__ = ["ServingBackend", "Server", "StreamEvent", "StreamHandle"]


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One committed occurrence on a request's stream.

    ``kind`` is ``"phase"`` / ``"token"`` / a terminal ``Outcome`` value
    (``"completed"`` | ``"aborted"`` | ``"rejected"``).  ``t`` is the
    virtual-clock commit time."""
    kind: str
    t: float
    rid: int
    phase: Optional[Phase] = None     # kind == "phase"
    token: Optional[int] = None       # kind == "token"
    index: Optional[int] = None       # position in the output stream


def _sort_t(t: float) -> float:
    # nan times (requests driven outside any clocked backend) sort first
    return float("-inf") if math.isnan(t) else t


class StreamHandle:
    """A client's view of one submitted request.

    Events are *committed state*, not a side channel: token events replay
    ``Request.generated``/``t_tokens`` and phase events replay
    ``Request.phase_log``, so the stream is bit-identical to what the
    batch summary would report — draining it early changes nothing.
    """

    def __init__(self, req: Request, backend: "ServingBackend"):
        self.request = req
        self._backend = backend
        self._n_phase = 0
        self._n_tok = 0
        self._terminal_sent = False

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def outcome(self) -> Optional[Outcome]:
        return self.request.outcome

    @property
    def finished(self) -> bool:
        return self.request.outcome is not None

    @property
    def tokens(self) -> List[int]:
        """Token ids committed so far (the full stream once finished)."""
        return list(self.request.generated)

    def cancel(self) -> bool:
        """Abort this request (frees its decode slot + paged blocks now).
        Returns False if it already reached a terminal state."""
        if self.finished:
            return False
        return self._backend.abort(self.rid)

    def events(self) -> List[StreamEvent]:
        """Drain every event committed since the last call, in virtual-time
        order (phases sort before tokens at equal timestamps)."""
        r = self.request
        out: List[StreamEvent] = []
        for t, ph in r.phase_log[self._n_phase:]:
            out.append(StreamEvent("phase", t, r.rid, phase=ph))
        self._n_phase = len(r.phase_log)
        # a handler appends the token id and its timestamp in one event;
        # between drains the two streams agree, but clamp defensively
        n = min(len(r.generated), len(r.t_tokens))
        for i in range(self._n_tok, n):
            out.append(StreamEvent("token", r.t_tokens[i], r.rid,
                                   token=r.generated[i], index=i))
        self._n_tok = n
        out.sort(key=lambda e: (_sort_t(e.t), e.kind != "phase"))
        if r.outcome is not None and not self._terminal_sent:
            # clamp: an abort during a hand-off's transfer latency stamps
            # t_done before the already-committed first token's (future)
            # timestamp — the terminal event must still close the stream
            t_end = r.t_done if r.t_done is not None else float("nan")
            if r.t_tokens:
                t_end = (r.t_tokens[-1] if math.isnan(t_end)
                         else max(t_end, r.t_tokens[-1]))
            out.append(StreamEvent(r.outcome.value, t_end, r.rid))
            self._terminal_sent = True
        return out


class BackendBase:
    """Shared ``ServingBackend`` plumbing, inherited by both backends so
    the submission, admission and event-pump semantics cannot drift.

    Subclasses provide ``clock``/``metrics``, ``_handle(ev) ->
    [finished]``, ``_arm_control()``, ``in_flight()`` and the
    backend-specific half of ``abort``; compute completions must be the
    ``prefill_done``/``decode_done`` event kinds.  ``_init_backend()``
    must run before the first ``submit``.
    """

    clock: VirtualClock
    metrics: Metrics

    def _init_backend(self) -> None:
        # every submitted request, by rid — the abort path's lookup
        self._by_rid: Dict[int, Request] = {}
        # bounded central queue (set by api.Server): an arrival finding
        # this many requests in flight is REJECTED at its arrival event
        self.admission_limit: Optional[int] = None
        # multi-tenant fair-share scheduler (set via ``set_scheduler`` /
        # ``Server(scheduler=...)``): orders the central queue, enforces
        # per-tenant budgets, and selects preemption victims
        self.scheduler: Optional[FairShareScheduler] = None
        # SLO-driven autoscaler (set via ``set_autoscaler`` /
        # ``Server(autoscaler=...)``): ticked from the backend's control
        # loop, scales the prefill/decode tiers via the subclass hooks
        self.autoscaler: Optional[SLOAutoscaler] = None
        self._slo_window = (0, 0)        # (n_slo_ok, n_accountable) mark

    def set_scheduler(self, sched) -> None:
        """Install a fair-share scheduler (a ``SchedulerConfig`` or a
        prebuilt ``FairShareScheduler``); None removes it."""
        if isinstance(sched, SchedulerConfig):
            sched = FairShareScheduler(sched)
        self.scheduler = sched

    def set_autoscaler(self, policy) -> None:
        """Install an SLO-driven autoscaler (an ``AutoscaleConfig`` or a
        prebuilt ``SLOAutoscaler``); None removes it.  The policy is
        ticked at the backend's control cadence and acts through the
        backend's scale-up (billed warm-up) / scale-down (drain via
        extract-adopt) hooks."""
        if isinstance(policy, AutoscaleConfig):
            policy = SLOAutoscaler(policy)
        self.autoscaler = policy
        if policy is not None:
            self._record_fleet()

    # -- autoscaling: policy above, mechanism in the subclass --------------
    def _autoscale_signals(self) -> FleetSignals:
        """Subclass hook: the tier load snapshot the policy plans from."""
        raise NotImplementedError

    def _scale_up(self, role: str, profile=None) -> Optional[str]:
        """Subclass hook: order one ``role`` instance (optionally on a
        specific ``HardwareProfile``).  Bills warm-up on the virtual
        clock; returns the new instance's name (None = refused)."""
        raise NotImplementedError

    def _scale_down(self, role: str) -> bool:
        """Subclass hook: start draining one ``role`` instance (in-flight
        work migrates token-identically; the instance retires once
        empty).  Returns False when no instance is eligible."""
        raise NotImplementedError

    def _fleet_counts(self) -> Dict[str, int]:
        """Subclass hook: provisioned-instance composition for the fleet
        timeline, e.g. {"prefill": 3, "decode": 5, "warming": 1,
        "draining": 0}."""
        raise NotImplementedError

    def _record_fleet(self) -> None:
        self.metrics.record_fleet(self.clock.now, self._fleet_counts())

    def _recent_attainment(self) -> Optional[float]:
        """SLO attainment since the last autoscale decision round (None
        when no SLO is configured or nothing turned terminal)."""
        if self.metrics.slo is None:
            return None
        ok = self.metrics.n_slo_ok
        n = self.metrics.n_requests + self.metrics.n_rejected
        ok0, n0 = self._slo_window
        self._slo_window = (ok, n)
        return (ok - ok0) / (n - n0) if n > n0 else None

    def _autoscale_tick(self) -> None:
        """Run one policy round (subclasses call this from their control
        event).  Rate-limited by the policy's own interval/cooldowns."""
        pol = self.autoscaler
        if pol is None or not pol.due(self.clock.now):
            return
        sig = self._autoscale_signals()
        sig.slo_attainment = self._recent_attainment()
        changed = False
        for d in pol.plan(sig):
            for _ in range(d.delta):
                changed = (self._scale_up(d.role, d.profile)
                           is not None) or changed
            for _ in range(-d.delta):
                changed = self._scale_down(d.role) or changed
        if changed:
            self._record_fleet()

    def _sched_done(self, req: Request) -> None:
        """Report a terminal request to the scheduler so the tenant's
        in-flight budget frees (idempotent)."""
        if self.scheduler is not None:
            self.scheduler.release(req)

    def start(self) -> None:
        """Protocol hook: the control loop arms itself on first submit,
        so there is nothing to do — idempotent by construction."""

    def submit(self, req: Request, at: Optional[float] = None
               ) -> StreamHandle:
        """Admit a request as an arrival event at virtual time ``at``
        (default: now — live open-loop submission; workload-driven runs
        pass their Poisson stamps).  Returns the request's stream."""
        t = self.clock.now if at is None else max(float(at), self.clock.now)
        req.arrival = t
        req.clock = self.clock
        self._by_rid[req.rid] = req
        self.clock.push(t, "arrival", req)
        self._arm_control()
        return StreamHandle(req, self)

    def _admit(self, req: Request) -> bool:
        """The arrival-event gate: False when the request was aborted
        before arriving, when the bounded central queue is full, or when
        the tenant is over a fair-share budget (the latter two recorded
        as explicit REJECTED refusals)."""
        if req.outcome is not None:
            return False
        if (self.admission_limit is not None
                and self.in_flight() >= self.admission_limit):
            req.t_done = self.clock.now
            self.metrics.record_rejected(req)
            return False
        if self.scheduler is not None and \
                self.scheduler.admit(req, self.clock.now) is not None:
            req.t_done = self.clock.now
            self.metrics.record_rejected(req)
            return False
        return True

    def _finish_abort(self, req: Request) -> bool:
        req.t_done = self.clock.now
        self._sched_done(req)
        self.metrics.record_aborted(req)
        return True

    def step(self) -> List[Request]:
        """Advance through events until the next compute completion (a
        prefill wave or decode iteration) has been handled.  Returns the
        requests that finished.  Idle backends return []."""
        if not self.clock:
            if self.in_flight() == 0:
                return []
            raise RuntimeError("serving backend stalled: work in flight "
                               "but no scheduled events")
        finished: List[Request] = []
        while True:
            ev = self.clock.pop()
            if ev is None:
                break
            finished += self._handle(ev)
            if ev.kind in ("prefill_done", "decode_done"):
                break
        return finished

    def step_until(self, t: Optional[float] = None,
                   max_events: int = 5_000_000) -> List[Request]:
        """Handle every scheduled event with timestamp <= ``t`` (all of
        them when ``t`` is None); returns the requests that finished."""
        finished: List[Request] = []
        n_ev = 0
        while self.clock and (t is None or self.clock.peek_t() <= t):
            finished += self._handle(self.clock.pop())
            n_ev += 1
            if n_ev > max_events:
                raise RuntimeError(f"not done after {max_events} events")
        return finished

    def drain(self, max_events: int = 5_000_000) -> List[Request]:
        """Run the event loop until nothing is scheduled; raises if work
        is still in flight with no event to carry it (a lost request)."""
        finished = self.step_until(None, max_events=max_events)
        if self.in_flight() > 0:
            raise RuntimeError("serving backend stalled: work in flight "
                               "but no scheduled events")
        return finished


class ServingBackend(Protocol):
    """What a serving backend must provide to sit behind ``Server``.

    Implemented by ``serving.orchestrator.Orchestrator`` (live engines,
    exact tokens) and ``serving.cluster.ClusterSim`` (analytical costs,
    cluster scale).  All times are virtual seconds on the backend's
    ``clock``; ``submit`` may be called at any point, including while a
    run is in flight (open-loop submission) — the request is routed on
    the next dispatch."""

    metrics: Metrics
    clock: VirtualClock
    # bounded central queue: an arrival that finds this many requests
    # already in flight is REJECTED (None = unbounded)
    admission_limit: Optional[int]

    @property
    def fleet(self) -> Dict[str, str]:
        """Instance name -> current role (``prefill``/``decode``/…)."""
        ...

    def start(self) -> None:
        """Arm the control loop; idempotent."""
        ...

    def set_scheduler(self, sched) -> None:
        """Install a multi-tenant fair-share scheduler (a
        ``fairshare.FairShareScheduler`` or ``SchedulerConfig``) ahead of
        the central queue; ``None`` restores plain FIFO."""
        ...

    def set_autoscaler(self, policy) -> None:
        """Install an SLO-driven autoscaler (an
        ``autoscale.SLOAutoscaler`` or ``AutoscaleConfig``) that scales
        the prefill/decode tiers at control-tick cadence — scale-up
        bills warm-up on the virtual clock, scale-down drains
        token-identically; ``None`` pins the fleet static."""
        ...

    def submit(self, req: Request, at: Optional[float] = None
               ) -> StreamHandle:
        """Admit ``req`` as an arrival event at virtual time ``at``
        (default: now; never before now) and return its stream."""
        ...

    def step(self) -> List[Request]:
        """Advance through events until the next compute completion (a
        prefill wave or decode iteration) has been handled; returns
        requests that finished.  Idle backends return []."""
        ...

    def step_until(self, t: Optional[float] = None) -> List[Request]:
        """Handle every scheduled event with timestamp <= ``t`` (all
        scheduled events when ``t`` is None); returns finished requests."""
        ...

    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it lives (central queue, prefill
        queue, mid-prefill, decode slot).  Decode slots and paged blocks
        are freed immediately; surviving streams are unperturbed.
        Returns False for unknown or already-terminal rids."""
        ...

    def drain(self, max_events: int = 1_000_000) -> List[Request]:
        """Run the event loop until nothing is scheduled and nothing is
        in flight; returns requests finished during the drain."""
        ...

    def summary(self) -> dict:
        """The shared metrics schema plus backend-specific fields."""
        ...


class Server:
    """The front door: one streaming API over any ``ServingBackend``.

    ``admission_limit`` bounds the backend's central queue: when a
    request's arrival event fires with ``admission_limit`` requests
    already in flight, it is REJECTED — the handle turns terminal and
    ``Metrics`` records the refusal, so goodput/attainment denominators
    stay explicit.  The check runs at *arrival* time (not submit time):
    open-loop drivers pre-schedule future arrivals, and backpressure is a
    property of the queue when the request actually shows up.  ``None``
    disables it.

    ``scheduler`` installs a multi-tenant fair-share front door
    (``fairshare.FairShareScheduler`` or a ``SchedulerConfig`` to build
    one): weighted-fair queue ordering ahead of the central queue,
    per-tenant budget rejections, and optional swap/sacrifice decode
    preemption.  ``None`` (the default) keeps plain FIFO behaviour.

    ``autoscaler`` installs an SLO-driven fleet autoscaler
    (``autoscale.SLOAutoscaler`` or an ``AutoscaleConfig`` to build
    one): the prefill/decode tiers grow on queue-delay pressure (new
    instances pay billed warm-up before taking traffic) and shrink by
    token-identical drains when idle and attaining.  ``None`` (the
    default) keeps the fleet static.
    """

    def __init__(self, backend: ServingBackend,
                 admission_limit: Optional[int] = None,
                 scheduler: Optional[object] = None,
                 autoscaler: Optional[object] = None):
        self.backend = backend
        if admission_limit is not None:
            backend.admission_limit = admission_limit
        if scheduler is not None:
            backend.set_scheduler(scheduler)
        if autoscaler is not None:
            backend.set_autoscaler(autoscaler)
        self.handles: Dict[int, StreamHandle] = {}
        self._open: Set[int] = set()     # admitted, not yet terminal
        backend.start()

    @property
    def admission_limit(self) -> Optional[int]:
        return self.backend.admission_limit

    # -- views ------------------------------------------------------------
    @property
    def metrics(self) -> Metrics:
        return self.backend.metrics

    @property
    def fleet(self) -> Dict[str, str]:
        return self.backend.fleet

    @property
    def now(self) -> float:
        return self.backend.clock.now

    def summary(self) -> dict:
        return self.backend.summary()

    def in_flight(self) -> int:
        self._settle()
        return len(self._open)

    def _settle(self) -> None:
        self._open = {rid for rid in self._open
                      if self.handles[rid].outcome is None}

    # -- submission / cancellation ---------------------------------------
    def submit(self, req: Request, at: Optional[float] = None
               ) -> StreamHandle:
        """Schedule ``req``'s arrival (at virtual time ``at``, default
        now) and return its stream handle.  If the backend's bounded
        queue is full when the arrival fires, the handle turns terminal
        with outcome REJECTED."""
        h = self.backend.submit(req, at=at)
        self.handles[req.rid] = h
        self._open.add(req.rid)
        return h

    def abort(self, rid: int) -> bool:
        ok = self.backend.abort(rid)
        self._settle()
        return ok

    # -- stepping ----------------------------------------------------------
    def step(self) -> List[StreamHandle]:
        done = self.backend.step()
        self._settle()
        return [self.handles[r.rid] for r in done if r.rid in self.handles]

    def step_until(self, t: Optional[float] = None) -> List[StreamHandle]:
        done = self.backend.step_until(t)
        self._settle()
        return [self.handles[r.rid] for r in done if r.rid in self.handles]

    def drain(self) -> List[StreamHandle]:
        done = self.backend.drain()
        self._settle()
        return [self.handles[r.rid] for r in done if r.rid in self.handles]

    # -- canonical drive modes --------------------------------------------
    def run(self, reqs: Sequence[Request]) -> dict:
        """Open-loop batch drive: every request is submitted at its
        workload arrival stamp, then the backend drains.  Because the
        arrival events land exactly where the legacy batch path put them,
        token streams and virtual timestamps are bit-identical to it
        (pinned by tests/test_backend_contract.py)."""
        for r in sorted(reqs, key=lambda r: r.arrival):
            self.submit(r, at=r.arrival)
        self.drain()
        return self.summary()

    def run_closed_loop(self, clients: Any) -> dict:
        """Closed-loop drive: ``clients`` (e.g.
        ``workload.ClosedLoopClients``) keeps a fixed number of requests
        in flight — EVERY terminal outcome (completed, rejected, aborted)
        triggers ``on_complete`` and the next submission, so the pool
        never shrinks and a bounded queue can't starve it.  Follow-ups
        are submitted at their own arrival stamps, so client think time
        is honored.  This is the saturation-experiment shape open-loop
        Poisson arrivals cannot express."""
        for r in clients.initial(self.now):
            self.submit(r, at=r.arrival)
        pumped: Set[int] = set()

        def pump() -> None:
            for rid, h in list(self.handles.items()):
                if h.finished and rid not in pumped:
                    pumped.add(rid)
                    nxt = clients.on_complete(h.request, self.now)
                    if nxt is not None:
                        self.submit(nxt, at=nxt.arrival)

        pump()
        while True:
            self._settle()
            if not self._open:
                break
            self.backend.step()
            pump()
        return self.summary()
