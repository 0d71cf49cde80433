"""Multi-tenant fair-share admission scheduling (ROADMAP item 4).

One FIFO admission queue is not a production front door: a single tenant
flooding long prompts starves everyone else's TTFT (the overload regime
Mooncake meets with early rejection).  This module puts a weighted-fair
queue *ahead of* the central queue shared by both serving backends:

* **WFQ with SRPT bias and aging** (``FairShareScheduler.select``):
  start-time fair queueing over per-tenant virtual finish times — a
  tenant with weight ``w`` advances its virtual clock by ``size/w`` per
  dispatched request, so long-run service is proportional to weight
  regardless of offered load.  ``srpt_bias`` tilts ties toward short
  remaining work (shortest-remaining-processing-time: small requests
  jump long ones of equal fairness rank), and ``aging_rate`` converts
  queue wait into rank credit so no request starves behind an endless
  stream of better-ranked ones.
* **Per-tenant budgets** (``TenantPolicy`` / ``admit``): concurrency
  (requests in flight), tokens-in-flight (prompt + decode budget of all
  admitted, unfinished requests) and a token-bucket rate limit.  A
  request over budget is REJECTED at its arrival event through the
  existing outcome machinery — an explicit refusal, never a silent drop.
* **Decode preemption** (``pick_victim``): when a request is ready for
  capacity a lower-priority tenant is hogging, the backend asks for a
  victim — lowest tenant priority first, most remaining tokens first
  (the cheapest progress to displace).  The backend then applies the
  configured policy: ``swap`` (KV pages demoted to the host tier via
  ``core/kvstore.py`` billing, resumed bit-identically) or ``sacrifice``
  (pages dropped, KV recomputed by re-prefill).

The scheduler is deliberately backend-agnostic: it orders/admits
``Request`` objects and never touches engines, so ``Orchestrator`` and
``ClusterSim`` wire it identically behind the ``ServingBackend``
contract (``api.Server(scheduler=...)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .request import Request

__all__ = ["TenantPolicy", "SchedulerConfig", "FairShareScheduler"]


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Budgets and share of one tenant (unknown tenants get the config's
    ``default`` policy)."""
    weight: float = 1.0                  # WFQ share (service ∝ weight)
    priority: int = 0                    # preemption tier (higher wins)
    max_inflight_requests: Optional[int] = None
    max_inflight_tokens: Optional[int] = None   # prompt + decode budget
    rate_rps: Optional[float] = None     # token-bucket refill rate
    burst: int = 1                       # token-bucket depth


@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "wfq"                  # wfq | fifo
    srpt_bias: float = 0.25              # rank units per size unit
    aging_rate: float = 0.0              # rank units per waiting second
    preemption: Optional[str] = None     # None | swap | sacrifice
    tenants: Dict[str, TenantPolicy] = dataclasses.field(
        default_factory=dict)
    default: TenantPolicy = TenantPolicy()

    def __post_init__(self):
        if self.policy not in ("wfq", "fifo"):
            raise ValueError(f"unknown scheduler policy {self.policy!r}")
        if self.preemption not in (None, "swap", "sacrifice"):
            raise ValueError(
                f"unknown preemption policy {self.preemption!r}")


def _service_size(r: Request) -> float:
    """Estimated service demand of a request, in tokens: prompt compute
    plus its full decode budget (what admission must provision for)."""
    return float(r.prompt_len + r.max_new_tokens)


class FairShareScheduler:
    """Stateful WFQ + budgets + victim selection over tenants.

    Backends call ``admit`` at each arrival event (rejecting on a
    non-None reason), ``select``/``pick`` when releasing requests from
    the central queue, ``release`` on every terminal outcome, and
    ``pick_victim`` when a ready request finds no decode capacity."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self._vtime = 0.0                          # system virtual time
        self._finish: Dict[str, float] = {}        # tenant -> vfinish
        self._inflight_reqs: Dict[str, int] = {}
        self._inflight_tokens: Dict[str, float] = {}
        self._admitted: set = set()                # rids (release is idempotent)
        self._bucket: Dict[str, Tuple[float, float]] = {}  # (tokens, t)
        self.rejections: Dict[str, int] = {}       # reason -> count

    def policy_of(self, tenant: str) -> TenantPolicy:
        return self.cfg.tenants.get(tenant, self.cfg.default)

    # -- budgets / admission ----------------------------------------------
    def admit(self, req: Request, now: float) -> Optional[str]:
        """Budget gate at arrival time.  Returns None and registers the
        request's in-flight footprint when admitted, else the rejection
        reason (``rate`` | ``concurrency`` | ``tokens``)."""
        pol = self.policy_of(req.tenant)
        t = req.tenant
        if pol.rate_rps is not None:
            tokens, last = self._bucket.get(t, (float(pol.burst), now))
            tokens = min(tokens + (now - last) * pol.rate_rps,
                         float(pol.burst))
            if tokens < 1.0:
                self._bucket[t] = (tokens, now)
                return self._reject("rate")
            self._bucket[t] = (tokens - 1.0, now)
        if pol.max_inflight_requests is not None and \
                self._inflight_reqs.get(t, 0) >= pol.max_inflight_requests:
            return self._reject("concurrency")
        if pol.max_inflight_tokens is not None and \
                self._inflight_tokens.get(t, 0.0) + _service_size(req) \
                > pol.max_inflight_tokens:
            return self._reject("tokens")
        self._inflight_reqs[t] = self._inflight_reqs.get(t, 0) + 1
        self._inflight_tokens[t] = (self._inflight_tokens.get(t, 0.0)
                                    + _service_size(req))
        self._admitted.add(req.rid)
        return None

    def _reject(self, reason: str) -> str:
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        return reason

    def release(self, req: Request) -> None:
        """Drop a terminal request's in-flight footprint (idempotent: the
        abort path and the completion path may both report)."""
        if req.rid not in self._admitted:
            return
        self._admitted.discard(req.rid)
        t = req.tenant
        self._inflight_reqs[t] = max(self._inflight_reqs.get(t, 0) - 1, 0)
        self._inflight_tokens[t] = max(
            self._inflight_tokens.get(t, 0.0) - _service_size(req), 0.0)

    def inflight(self, tenant: str) -> int:
        return self._inflight_reqs.get(tenant, 0)

    # -- WFQ ordering ------------------------------------------------------
    def _rank(self, r: Request, now: float) -> float:
        """Start-time-fair rank: lower dispatches first.  The base term is
        the tenant's virtual start tag; SRPT bias adds (weighted) size so
        short work wins ties; aging subtracts accrued wait."""
        pol = self.policy_of(r.tenant)
        size = _service_size(r) / max(pol.weight, 1e-9)
        start = max(self._vtime, self._finish.get(r.tenant, 0.0))
        return (start + self.cfg.srpt_bias * size
                - self.cfg.aging_rate * max(now - r.arrival, 0.0))

    def _charge(self, r: Request) -> None:
        """Advance the tenant's virtual finish time by the dispatched
        request's weighted size (the WFQ service charge)."""
        pol = self.policy_of(r.tenant)
        start = max(self._vtime, self._finish.get(r.tenant, 0.0))
        self._finish[r.tenant] = start + _service_size(r) \
            / max(pol.weight, 1e-9)
        self._vtime = start

    def peek(self, queue: Sequence[Request], now: float) -> Request:
        """Best-ranked request WITHOUT charging its tenant — the probe
        backends use to ask "who would dispatch next?" (e.g. to pick whom
        to preempt capacity for)."""
        if self.cfg.policy == "fifo" or len(queue) <= 1:
            return queue[0]
        return min(queue, key=lambda r: self._rank(r, now))

    def pick(self, queue: Sequence[Request], now: float) -> int:
        """Index of the next request to dispatch from ``queue`` (FIFO tie
        break on equal rank keeps same-tenant order arrival-stable)."""
        if self.cfg.policy == "fifo" or len(queue) <= 1:
            self._charge(queue[0])
            return 0
        best, best_rank = 0, self._rank(queue[0], now)
        for i in range(1, len(queue)):
            rank = self._rank(queue[i], now)
            if rank < best_rank - 1e-12:
                best, best_rank = i, rank
        self._charge(queue[best])
        return best

    def select(self, queue: Sequence[Request], now: float,
               budget: Optional[int] = None) -> List[Request]:
        """Dispatch order for up to ``budget`` requests of ``queue``
        (everything when None or under FIFO — FIFO is the do-nothing
        baseline and must not hold work back)."""
        if self.cfg.policy == "fifo":
            for r in queue:
                self._charge(r)
            return list(queue)
        n = len(queue) if budget is None else max(min(budget, len(queue)), 0)
        avail = list(queue)
        chosen: List[Request] = []
        for _ in range(n):
            chosen.append(avail.pop(self.pick(avail, now)))
        return chosen

    # -- preemption --------------------------------------------------------
    @property
    def preemption(self) -> Optional[str]:
        return self.cfg.preemption

    def pick_victim(self, waiting: Request,
                    running: Sequence[Tuple[Request, int]]
                    ) -> Optional[Request]:
        """Victim for ``waiting`` among ``running`` (request, remaining
        tokens) pairs: only strictly lower-priority tenants are eligible;
        among those, lowest priority first, most remaining tokens first
        (displacing the least sunk progress).  None = don't preempt."""
        if self.cfg.preemption is None:
            return None
        wp = self.policy_of(waiting.tenant).priority
        cands = [(r, rem) for r, rem in running
                 if self.policy_of(r.tenant).priority < wp]
        if not cands:
            return None
        return min(cands, key=lambda c: (
            self.policy_of(c[0].tenant).priority, -c[1], c[0].rid))[0]
