"""Request lifecycle and per-request metrics (TTFT / TPOT / E2E / SLO).

Timestamps are *virtual-clock* seconds (``serving/clock.py``) on both
serving paths — the simulator and the live orchestrator stamp the same
fields and aggregate through the same ``Metrics``, so their summaries
share one schema (documented in docs/serving.md §Clock, chunked prefill,
and SLOs).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Phase(str, enum.Enum):
    QUEUED = "queued"
    ROUTED = "routed"           # assigned to a prefill instance
    PREFILL = "prefill"
    TRANSFER = "transfer"       # KV hand-off prefill -> decode
    DECODE = "decode"
    DONE = "done"


class Outcome(str, enum.Enum):
    """How a request left the system — the explicit terminal state the
    front door (serving/api.py) records so goodput and attainment
    denominators are never implicit.

    * ``COMPLETED`` — decoded to its token budget; counted in throughput.
    * ``ABORTED``   — cancelled by the client mid-flight; its decode slot
      and paged blocks were freed immediately.
    * ``REJECTED``  — refused at admission (bounded central queue); never
      entered the fleet.
    """
    COMPLETED = "completed"
    ABORTED = "aborted"
    REJECTED = "rejected"


# lifecycle order; requests only ever move forward (skips allowed — e.g. a
# standalone engine run goes QUEUED -> PREFILL without a routing step)
_PHASE_ORDER = {p: i for i, p in enumerate(Phase)}


# eq=False: requests are identities, not values — membership tests on
# queues (the abort path) must never compare prompt arrays elementwise
@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    arrival: float                    # seconds (virtual clock)
    prompt: np.ndarray                # token ids (int32)
    max_new_tokens: int
    prefix_id: Optional[int] = None   # shared-prefix group (workload metadata)
    prefix_len: int = 0               # tokens shared with the group
    tenant: str = "default"           # fair-share accounting/scheduling key

    # runtime state
    phase: Phase = Phase.QUEUED
    outcome: Optional[Outcome] = None  # terminal state (None while in flight)
    generated: List[int] = dataclasses.field(default_factory=list)
    prefill_instance: Optional[str] = None
    decode_instance: Optional[str] = None
    cached_tokens: int = 0            # prefix tokens served from the store
    # speculative decoding: proposals scored / accepted for THIS request
    # (the verifier's bonus token is not counted — acceptance rate is the
    # proposer's hit rate, not tokens-per-iteration)
    spec_proposed: int = 0
    spec_accepted: int = 0

    # timestamps
    t_prefill_start: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    # per-token emission times (first token included) — the TBT stream
    # SLO-aware scheduling reasons about (Mooncake-style)
    t_tokens: List[float] = dataclasses.field(default_factory=list)
    # phase transitions as (virtual time, phase) — the stream the front
    # door's StreamHandle replays to clients.  Timestamps come from the
    # backend's VirtualClock (``clock``, attached at admission); a request
    # run outside any clocked backend logs nan times.
    phase_log: List[Tuple[float, Phase]] = dataclasses.field(
        default_factory=list)
    clock: Optional[Any] = None       # the owning backend's VirtualClock

    def advance(self, phase: Phase) -> None:
        """Move the lifecycle forward; backwards transitions are bugs."""
        if _PHASE_ORDER[phase] < _PHASE_ORDER[self.phase]:
            raise ValueError(
                f"request {self.rid}: illegal phase transition "
                f"{self.phase.value} -> {phase.value}")
        self.phase = phase
        t = self.clock.now if self.clock is not None else float("nan")
        self.phase_log.append((t, phase))

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.t_done is None or self.t_first_token is None:
            return None
        n = max(len(self.generated) - 1, 1)
        return (self.t_done - self.t_first_token) / n

    @property
    def tbts(self) -> List[float]:
        """Inter-token gaps (time-between-tokens) from the per-token
        timestamp stream; empty when fewer than two stamps exist."""
        return [b - a for a, b in zip(self.t_tokens, self.t_tokens[1:])]

    @property
    def e2e(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.arrival


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service-level objective: TTFT and TPOT ceilings.

    A completed request *attains* the SLO iff both bounds hold; goodput
    counts only attaining requests' tokens (the paper's "under SLOs"
    framing of the Fig. 8–11 comparisons)."""
    ttft_s: float
    tpot_s: float

    def attained(self, r: Request) -> bool:
        ttft, tpot = r.ttft, r.tpot
        if ttft is None or tpot is None:
            return False
        return ttft <= self.ttft_s and tpot <= self.tpot_s


def _mean(xs: List[float]) -> float:
    return float(np.mean(xs)) if xs else float("nan")


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(xs, q)) if xs else float("nan")


@dataclasses.dataclass
class TenantStats:
    """Per-tenant slice of ``Metrics`` — same accounting rules (rejected
    counts as an SLO miss, aborted excluded), plus the preemption record
    the fair-share scheduler's swap/sacrifice policies write."""
    n_requests: int = 0
    n_rejected: int = 0
    n_aborted: int = 0
    n_slo_ok: int = 0
    tokens_out: int = 0
    goodput_tokens: int = 0
    ttfts: List[float] = dataclasses.field(default_factory=list)
    n_preempted_swap: int = 0
    n_preempted_sacrifice: int = 0
    pages_swapped: int = 0            # KV pages demoted to the host tier
    spec_proposed: int = 0            # speculative proposals scored
    spec_accepted: int = 0            # of those, committed

    def summary(self, slo: Optional["SLO"], dur: float) -> dict:
        # undefined stats are None, never NaN: these dicts nest inside the
        # backend summary, and NaN breaks dict equality (the streaming-
        # vs-batch pins) and JSON round-trips (the bench artifacts)
        n_accountable = self.n_requests + self.n_rejected
        return {
            "n_requests": self.n_requests,
            "n_rejected": self.n_rejected,
            "n_aborted": self.n_aborted,
            "tokens_out": self.tokens_out,
            "throughput_tok_s": self.tokens_out / dur,
            "mean_ttft_s": _mean(self.ttfts) if self.ttfts else None,
            "p99_ttft_s": _pct(self.ttfts, 99) if self.ttfts else None,
            "slo_attainment": (self.n_slo_ok / n_accountable
                               if slo is not None and n_accountable
                               else None),
            "goodput_tok_s": (self.goodput_tokens / dur
                              if slo is not None else None),
            "n_preempted_swap": self.n_preempted_swap,
            "n_preempted_sacrifice": self.n_preempted_sacrifice,
            "pages_swapped": self.pages_swapped,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else None),
        }


@dataclasses.dataclass
class Metrics:
    """Aggregates over terminal requests — one schema for both the
    simulator and the live orchestrator.

    ``record`` takes completed requests; rejected and aborted requests are
    recorded separately (``record_rejected`` / ``record_aborted``) so the
    goodput and attainment denominators are explicit: a rejected request
    counts as an SLO miss (the system refused it), an aborted one is the
    client's choice and is excluded from attainment entirely."""
    slo: Optional[SLO] = None
    ttfts: List[float] = dataclasses.field(default_factory=list)
    tpots: List[float] = dataclasses.field(default_factory=list)
    tbts: List[float] = dataclasses.field(default_factory=list)
    e2es: List[float] = dataclasses.field(default_factory=list)
    arrivals: List[float] = dataclasses.field(default_factory=list)
    tokens_out: int = 0
    n_requests: int = 0
    n_rejected: int = 0
    n_aborted: int = 0
    aborted_tokens: int = 0           # tokens emitted before cancellation
    n_slo_ok: int = 0
    goodput_tokens: int = 0
    t_start: float = 0.0
    t_end: float = 0.0
    # fair-share dimension: per-tenant slices plus global preemption totals
    per_tenant: Dict[str, TenantStats] = dataclasses.field(
        default_factory=dict)
    n_preempted_swap: int = 0
    n_preempted_sacrifice: int = 0
    pages_swapped: int = 0
    # speculative decoding: jitted decode/verify iterations the backend
    # ran (set by the backend from its engines/sim) and the global
    # proposal/acceptance totals (folded in per terminal request)
    decode_iters: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    # elasticity dimension: stepwise fleet-size timeline (autoscaler events
    # append (t, {"prefill": n, "decode": n, "warming": n, "draining": n}))
    # and per-instance utilization samples from control ticks.  Warming and
    # draining instances are *provisioned* — they cost instance-seconds
    # without serving, which is exactly how warm-up is billed.
    fleet_timeline: List[Tuple[float, Dict[str, int]]] = dataclasses.field(
        default_factory=list)
    util_timeline: List[Tuple[float, Dict[str, float]]] = dataclasses.field(
        default_factory=list)

    def tenant(self, name: str) -> TenantStats:
        ts = self.per_tenant.get(name)
        if ts is None:
            ts = self.per_tenant[name] = TenantStats()
        return ts

    def record(self, r: Request):
        r.outcome = Outcome.COMPLETED
        self.n_requests += 1
        self.tokens_out += len(r.generated)
        self.arrivals.append(r.arrival)
        ts = self.tenant(r.tenant)
        ts.n_requests += 1
        ts.tokens_out += len(r.generated)
        self._fold_spec(r, ts)
        if r.ttft is not None:
            self.ttfts.append(r.ttft)
            ts.ttfts.append(r.ttft)
        if r.tpot is not None:
            self.tpots.append(r.tpot)
        self.tbts.extend(r.tbts)
        if r.e2e is not None:
            self.e2es.append(r.e2e)
        if self.slo is not None and self.slo.attained(r):
            self.n_slo_ok += 1
            self.goodput_tokens += len(r.generated)
            ts.n_slo_ok += 1
            ts.goodput_tokens += len(r.generated)
        self.t_end = max(self.t_end, r.t_done or 0.0)

    def record_rejected(self, r: Request):
        """Admission refused the request (bounded central queue or a
        per-tenant budget)."""
        r.outcome = Outcome.REJECTED
        self.n_rejected += 1
        self.tenant(r.tenant).n_rejected += 1

    def record_aborted(self, r: Request):
        """The client cancelled the request mid-flight."""
        r.outcome = Outcome.ABORTED
        self.n_aborted += 1
        self.aborted_tokens += len(r.generated)
        ts = self.tenant(r.tenant)
        ts.n_aborted += 1
        self._fold_spec(r, ts)

    def _fold_spec(self, r: Request, ts: TenantStats):
        """Fold a terminal request's speculation counters into the global
        and per-tenant acceptance totals (tokens were committed either
        way, so aborted requests count too)."""
        self.spec_proposed += r.spec_proposed
        self.spec_accepted += r.spec_accepted
        ts.spec_proposed += r.spec_proposed
        ts.spec_accepted += r.spec_accepted

    def record_fleet(self, t: float, counts: Dict[str, int]):
        """Log a fleet-composition change (scale-up ordered, instance
        warmed, drain started, instance retired).  Consecutive identical
        snapshots are dropped — they cannot change the integral."""
        if self.fleet_timeline and self.fleet_timeline[-1][1] == counts:
            return
        self.fleet_timeline.append((t, dict(counts)))

    def record_util(self, t: float, utils: Dict[str, float]):
        """Sample per-instance utilization (control-tick cadence).  An
        empty dict is a legal sample: it marks a zero-fleet window."""
        self.util_timeline.append((t, dict(utils)))

    def instance_seconds(self, until: Optional[float] = None) -> float:
        """Stepwise integral of the provisioned-instance count over the
        fleet timeline — the cost axis of the autoscaling A/B (an
        instance bills from the moment it is *ordered*, through warm-up
        and drain, until retired).  0.0 when nothing was ever recorded."""
        if not self.fleet_timeline:
            return 0.0
        t_stop = max(until if until is not None else self.t_end,
                     self.fleet_timeline[-1][0])
        total = 0.0
        for i, (t, counts) in enumerate(self.fleet_timeline):
            t_next = (self.fleet_timeline[i + 1][0]
                      if i + 1 < len(self.fleet_timeline) else t_stop)
            total += sum(counts.values()) * max(t_next - t, 0.0)
        return total

    def record_preempted(self, r: Request, mode: str, pages: int = 0):
        """A decode-resident request lost its slot to the fair-share
        scheduler: ``mode`` is ``"swap"`` (pages demoted to the host tier,
        resumed bit-identically later) or ``"sacrifice"`` (pages dropped,
        KV recomputed by re-prefill)."""
        ts = self.tenant(r.tenant)
        if mode == "swap":
            self.n_preempted_swap += 1
            self.pages_swapped += pages
            ts.n_preempted_swap += 1
            ts.pages_swapped += pages
        else:
            self.n_preempted_sacrifice += 1
            ts.n_preempted_sacrifice += 1

    def summary(self) -> dict:
        dur = max(self.t_end - self.t_start, 1e-9)
        # attainment denominator: every request the system answered for —
        # completed + rejected (a refusal is a miss).  Aborts are excluded:
        # cancellation is the client's choice, not a service failure.
        n_accountable = self.n_requests + self.n_rejected
        s = {
            "n_requests": self.n_requests,
            "n_submitted": (self.n_requests + self.n_rejected
                            + self.n_aborted),
            "n_rejected": self.n_rejected,
            "n_aborted": self.n_aborted,
            "throughput_tok_s": self.tokens_out / dur,
            "total_time_s": dur,
            "mean_ttft_s": _mean(self.ttfts),
            "p50_ttft_s": _pct(self.ttfts, 50),
            "p99_ttft_s": _pct(self.ttfts, 99),
            "mean_tpot_s": _mean(self.tpots),
            "p50_tpot_s": _pct(self.tpots, 50),
            "p99_tpot_s": _pct(self.tpots, 99),
            "p99_tbt_s": _pct(self.tbts, 99),
            "mean_e2e_s": _mean(self.e2es),
            # observed offered load over the arrival span — what the
            # workload actually asked for, vs throughput = what it got
            "offered_rps": (
                (self.n_requests - 1)
                / max(max(self.arrivals) - min(self.arrivals), 1e-9)
                if len(self.arrivals) > 1 else float("nan")),
        }
        if self.slo is not None:
            s["slo_ttft_s"] = self.slo.ttft_s
            s["slo_tpot_s"] = self.slo.tpot_s
            s["slo_attainment"] = (self.n_slo_ok / n_accountable
                                   if n_accountable else float("nan"))
            s["goodput_tok_s"] = self.goodput_tokens / dur
        else:
            s["slo_attainment"] = float("nan")
            s["goodput_tok_s"] = float("nan")
        s["n_preempted_swap"] = self.n_preempted_swap
        s["n_preempted_sacrifice"] = self.n_preempted_sacrifice
        s["pages_swapped"] = self.pages_swapped
        # speculation visibility: tokens committed per jitted decode
        # iteration (1.0 = plain decode; > 1 = speculation paying off) and
        # the proposer's acceptance rate.  None (never NaN) when the
        # backend ran no decode iterations / proposed nothing.
        s["decode_iters"] = self.decode_iters
        s["tokens_per_decode_iter"] = (
            (self.tokens_out + self.aborted_tokens) / self.decode_iters
            if self.decode_iters else None)
        s["spec_proposed"] = self.spec_proposed
        s["spec_accepted"] = self.spec_accepted
        s["acceptance_rate"] = (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else None)
        # elasticity: provisioned-fleet cost and size envelope.  All None
        # (never NaN) when no fleet events were recorded — static fleets
        # that predate the autoscaler keep their old summaries unchanged.
        if self.fleet_timeline:
            sizes = [sum(c.values()) for _, c in self.fleet_timeline]
            secs = self.instance_seconds()
            span = max(self.fleet_timeline[-1][0], self.t_end) \
                - self.fleet_timeline[0][0]
            s["instance_seconds"] = secs
            s["fleet_peak"] = max(sizes)
            s["fleet_min"] = min(sizes)
            s["fleet_mean"] = secs / span if span > 0 else float(sizes[-1])
            s["n_scale_events"] = len(self.fleet_timeline) - 1
        utils = [u for _, us in self.util_timeline for u in us.values()]
        s["mean_instance_util"] = _mean(utils) if utils else None
        s["tenants"] = {t: ts.summary(self.slo, dur)
                        for t, ts in sorted(self.per_tenant.items())}
        return s
