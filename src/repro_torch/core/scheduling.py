"""Algorithm 2 — Load-aware Request Scheduling (§4.4.2) and the prefix-cache-
aware baseline router it replaces (Fig. 2a).

With the Global KV Cache Store, every prefill instance sees the same prefix
cache, so the router ranks instances purely by (load, queue length):
O(|P| log |P| + |Q|) per cycle (Eq. 38).

``PrefixAwareRouter`` reproduces the baseline pathology: it weighs cache hit
rate into the dispatch decision, which concentrates hot prefixes on few
instances (the positive-feedback skew of Fig. 2a) — benchmarked in
benchmarks/bench_scheduler.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Tuple


@dataclasses.dataclass
class InstanceLoad:
    name: str
    load: float                # U_p = C/C_max + M/M_max  (Eq. 37)
    queue_len: int
    # modelled seconds until this instance's queue drains — the virtual-
    # clock queue-delay signal TTFT-aware routing keys on
    queue_delay_s: float = 0.0
    # probability-like score in [0, 1] that placing one more request here
    # evicts a resident (decode slots full / scheduler would pick_victim)
    preempt_risk: float = 0.0
    # baseline-router signal only:
    cached_prefix_tokens: Dict[bytes, int] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RequestInfo:
    rid: int
    prompt_len: int
    est_load: float            # EstimateLoad(req)
    prefix_key: Optional[bytes] = None   # leading block hash (for baseline)
    est_time_s: float = 0.0    # modelled service seconds (queue-delay bump)


class Router(Protocol):
    def dispatch(self, reqs: Sequence[RequestInfo],
                 instances: List[InstanceLoad]) -> Dict[int, str]: ...


# ---------------------------------------------------------------------------
# Live-engine adapter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LoadReport:
    """One live engine's utilization snapshot — the Eq. 32/37 inputs.

    ``compute_frac``/``memory_frac`` are the C/C_max and M/M_max terms;
    ``cached_prefix_tokens`` (leading-block hash -> cached tokens) is the
    locality signal the prefix-aware baseline router keys on.
    ``layer_span`` identifies a partial-stack (layer-span) engine — its
    fractions are already scaled by the span's share of the stack, so span
    stages and full instances compare on one utilization axis (§4.1).
    ``queue_delay_s`` is the engine's modelled backlog-drain time (virtual
    seconds) — the TTFT term queue-delay-aware routing minimizes.
    ``preempt_risk`` in [0, 1] flags targets where accepting one more
    request would evict a resident (PR 8 frontier: preemption-aware
    routing steers work away from such instances when peers have room)."""
    compute_frac: float
    memory_frac: float
    queue_len: int
    queue_delay_s: float = 0.0
    preempt_risk: float = 0.0
    cached_prefix_tokens: Dict[bytes, int] = dataclasses.field(
        default_factory=dict)
    layer_span: Optional[Tuple[int, int]] = None

    @property
    def load(self) -> float:               # Eq. 37
        return self.compute_frac + self.memory_frac


class ReportsLoad(Protocol):
    """Anything that can be routed over: live engines, simulator shims."""
    name: str

    def load_report(self) -> LoadReport: ...


def live_instance_loads(engines: Sequence[ReportsLoad]) -> List[InstanceLoad]:
    """Derive router inputs from live engines instead of simulator state.

    This is the seam that lets ``LoadAwareRouter``/``PrefixAwareRouter`` run
    unchanged over both the discrete-event simulator (serving/cluster.py) and
    the live fleet (serving/orchestrator.py)."""
    out: List[InstanceLoad] = []
    for e in engines:
        r = e.load_report()
        out.append(InstanceLoad(
            name=e.name, load=r.load, queue_len=r.queue_len,
            queue_delay_s=r.queue_delay_s, preempt_risk=r.preempt_risk,
            cached_prefix_tokens=dict(r.cached_prefix_tokens)))
    return out


class LoadAwareRouter:
    """Algorithm 2: least-loaded first; past δ_L, lowest queue delay.

    Queue-delay awareness: utilization is ranked in coarse bands (a
    float EMA never ties exactly, which would starve the tie-break), and
    within a band the modelled backlog-drain time decides (then queue
    length).  Each dispatch bumps the target's ``queue_delay_s`` by the
    request's modelled service time — so a burst spreads by *expected
    TTFT*, not just by request count.  Because the backlog is priced on
    each instance's own roofline, this is where a heterogeneous fleet's
    fast parts attract more than an equal share of work.

    Preemption awareness: ``preempt_penalty`` adds a rank penalty of
    ``penalty * preempt_risk`` utilization points to instances where
    placing the request would evict a resident, so work lands on peers
    with free room first and only falls back to eviction when the whole
    fleet is at risk (penalty shifts rank uniformly, so the saturated
    tie-break is unaffected)."""

    def __init__(self, load_threshold: float = 1.6,
                 preempt_penalty: float = 0.0):
        self.delta_l = load_threshold
        self.preempt_penalty = preempt_penalty

    # utilization band width: differences smaller than this are EMA
    # noise, not signal — defer to the modelled queue delay instead
    LOAD_BAND = 0.25

    def _rank(self, p: InstanceLoad) -> Tuple[int, float, int, float]:
        load = p.load + self.preempt_penalty * p.preempt_risk
        # raw load last: when delay and queue length both tie (an idle
        # fleet, where they are all zero), fine-grained utilization must
        # still spread work or every request lands on the first instance
        return (int(load / self.LOAD_BAND), p.queue_delay_s, p.queue_len,
                load)

    def dispatch(self, reqs: Sequence[RequestInfo],
                 instances: List[InstanceLoad]) -> Dict[int, str]:
        plan: Dict[int, str] = {}
        # Step 2/3: least by (load + preempt penalty, queue delay, queue)
        # per request — min() is stable like the sort it replaces, and the
        # single-request case (every simulator arrival) stays O(|P|)
        cands = list(instances)
        for req in reqs:                      # Step 3: dispatch loop
            target = min(cands, key=self._rank)
            if target.load >= self.delta_l:
                # every candidate saturated: minimize added queueing delay
                target = min(cands,
                             key=lambda p: (p.queue_delay_s, p.queue_len))
            plan[req.rid] = target.name
            target.load += req.est_load
            target.queue_delay_s += req.est_time_s
            target.queue_len += 1
        return plan


class PrefixAwareRouter:
    """Baseline (Fig. 2a): score = hit_bonus·cached_fraction − load.

    Replicates the positive-feedback dynamic: instances holding a popular
    prefix win its future requests, growing their cache share further."""

    def __init__(self, hit_bonus: float = 2.0):
        self.hit_bonus = hit_bonus

    def dispatch(self, reqs: Sequence[RequestInfo],
                 instances: List[InstanceLoad]) -> Dict[int, str]:
        plan: Dict[int, str] = {}
        for req in reqs:
            def score(p: InstanceLoad) -> float:
                hit = 0.0
                if req.prefix_key is not None and \
                        req.prefix_key in p.cached_prefix_tokens:
                    hit = p.cached_prefix_tokens[req.prefix_key] / max(
                        req.prompt_len, 1)
                return self.hit_bonus * hit - p.load
            target = max(instances, key=score)
            plan[req.rid] = target.name
            target.load += req.est_load
            target.queue_len += 1
            if req.prefix_key is not None:       # cache grows where routed
                target.cached_prefix_tokens[req.prefix_key] = req.prompt_len
        return plan


class RoundRobinRouter:
    def __init__(self):
        self._i = 0

    def dispatch(self, reqs, instances):
        plan = {}
        for req in reqs:
            target = instances[self._i % len(instances)]
            self._i += 1
            plan[req.rid] = target.name
            target.load += req.est_load
            target.queue_len += 1
        return plan


def load_skew(instances: Sequence[InstanceLoad]) -> float:
    """max−min utilization gap — the imbalance metric of Fig. 2a."""
    loads = [p.load for p in instances]
    return max(loads) - min(loads)


def utilization_gap(utils: Dict[str, float]) -> float:
    """max−min over a device→utilization snapshot — the Δ the Algorithm 1
    controller drives down (Eq. 33/35).  0 for degenerate fleets."""
    if len(utils) < 2:
        return 0.0
    vals = list(utils.values())
    return max(vals) - min(vals)
