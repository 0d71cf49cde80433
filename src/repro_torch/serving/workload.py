"""Workload generators: Poisson arrivals with Alpaca-like (short) and
LongBench-like (long) prompt-length distributions plus shared-prefix
structure (§5.1.2/5.1.3).

Arrival timestamps are VIRTUAL-clock seconds (serving/clock.py): both the
simulator and the live orchestrator inject them as timed events, so
``rps`` is calibrated against the §4.3 analytical event costs of the
model being served, not wall time — a smoke-sized model saturates around
1e6–1e8 rps, a paper-sized one around 1–10 (see tests/test_scenarios.py).

Alpaca: prompt lengths ~4–50 tokens (Fig. 7a).
LongBench: ~2k–85k tokens, log-normal-ish (Fig. 7b).
Output length capped at 512 (paper: "maximum output length is capped at
512 tokens").  Shared prefixes follow a Zipf popularity law — the regime
where prefix-cache-aware routing skews load (Fig. 2a).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .request import Request


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    kind: str = "alpaca"            # alpaca | longbench | synthetic
    rps: float = 5.0
    n_requests: int = 100
    # time-varying arrival intensity: ((duration_s, rps), ...) segments
    # cycled forever — a piecewise-constant λ(t) for diurnal / ramp
    # scenarios.  None keeps the homogeneous-Poisson path (``rps``)
    # byte-identical under seed.  Build sinusoidal days with
    # ``diurnal_schedule``; arrivals come from Lewis-Shedler thinning
    # against max λ, so the process stays an exact (inhomogeneous)
    # Poisson process and deterministic per seed.
    rate_schedule: Optional[Tuple[Tuple[float, float], ...]] = None
    vocab_size: int = 512
    seed: int = 0
    max_new_tokens: int = 512
    # shared-prefix structure
    n_prefix_groups: int = 8
    prefix_share: float = 0.5       # fraction of requests carrying a shared prefix
    prefix_zipf: float = 1.2        # popularity skew across groups
    # synthetic-kind overrides
    prompt_len_lo: int = 16
    prompt_len_hi: int = 64
    # multi-tenant tagging: every request carries ``tenant``, or draws one
    # from ``tenant_mix`` — ((name, probability), ...) pairs — when set.
    # Shapes that differ per tenant compose via ``merge_workloads``.
    tenant: str = "default"
    tenant_mix: Optional[Tuple[Tuple[str, float], ...]] = None


def _prompt_len(cfg: WorkloadConfig, rng: np.random.Generator) -> int:
    if cfg.kind == "alpaca":
        return int(rng.integers(4, 51))                      # Fig. 7a
    if cfg.kind == "longbench":
        # log-normal spanning ~2k..85k (Fig. 7b)
        x = rng.lognormal(mean=9.2, sigma=0.8)
        return int(np.clip(x, 2000, 85000))
    return int(rng.integers(cfg.prompt_len_lo, cfg.prompt_len_hi + 1))


def _out_len(cfg: WorkloadConfig, rng: np.random.Generator) -> int:
    lo = min(16, cfg.max_new_tokens)
    return int(rng.integers(lo, cfg.max_new_tokens + 1))


def _prefix_pool(cfg: WorkloadConfig, rng: np.random.Generator):
    """(group token pool, Zipf popularity) shared by both client shapes."""
    ranks = np.arange(1, cfg.n_prefix_groups + 1, dtype=np.float64)
    pop = ranks ** (-cfg.prefix_zipf)
    pop /= pop.sum()
    group_prefix_tokens = [
        rng.integers(0, cfg.vocab_size, size=(4096,), dtype=np.int32)
        for _ in range(cfg.n_prefix_groups)]
    return group_prefix_tokens, pop


def _draw_tenant(cfg: WorkloadConfig, rng: np.random.Generator) -> str:
    if cfg.tenant_mix is None:
        return cfg.tenant
    names = [t for t, _ in cfg.tenant_mix]
    probs = np.asarray([p for _, p in cfg.tenant_mix], dtype=np.float64)
    probs /= probs.sum()
    return names[int(rng.choice(len(names), p=probs))]


def _make_request(cfg: WorkloadConfig, rng: np.random.Generator, rid: int,
                  t: float, group_prefix_tokens, pop) -> Request:
    """One request of the configured shape, arriving at ``t``."""
    plen = _prompt_len(cfg, rng)
    tenant = _draw_tenant(cfg, rng)
    if rng.random() < cfg.prefix_share and cfg.n_prefix_groups > 0:
        gid = int(rng.choice(cfg.n_prefix_groups, p=pop))
        pfx_len = min(plen // 2, 4096)
        prompt = np.concatenate([
            group_prefix_tokens[gid][:pfx_len],
            rng.integers(0, cfg.vocab_size, size=(plen - pfx_len,),
                         dtype=np.int32)])
        return Request(rid=rid, arrival=t, prompt=prompt,
                       max_new_tokens=_out_len(cfg, rng),
                       prefix_id=gid, prefix_len=pfx_len, tenant=tenant)
    prompt = rng.integers(0, cfg.vocab_size, size=(plen,), dtype=np.int32)
    return Request(rid=rid, arrival=t, max_new_tokens=_out_len(cfg, rng),
                   prompt=prompt, tenant=tenant)


def diurnal_schedule(period_s: float, lo_rps: float, hi_rps: float,
                     n_segments: int = 24
                     ) -> Tuple[Tuple[float, float], ...]:
    """One sinusoidal 'day' as a piecewise-constant ``rate_schedule``:
    λ(t) sweeps trough→peak→trough over ``period_s``, sampled at segment
    midpoints.  Cycled forever by ``generate``, so one tuple describes
    arbitrarily many days."""
    assert n_segments >= 2 and period_s > 0 and 0 < lo_rps <= hi_rps
    seg = period_s / n_segments
    mid = lo_rps + (hi_rps - lo_rps) / 2.0
    amp = (hi_rps - lo_rps) / 2.0
    return tuple(
        (seg, mid - amp * math.cos(2.0 * math.pi * (i + 0.5) / n_segments))
        for i in range(n_segments))


def rate_at(cfg: WorkloadConfig, t: float) -> float:
    """Instantaneous arrival intensity λ(t) of the configured process."""
    if cfg.rate_schedule is None:
        return cfg.rps
    total = sum(d for d, _ in cfg.rate_schedule)
    t = t % total if total > 0 else 0.0
    for dur, rps in cfg.rate_schedule:
        if t < dur:
            return rps
        t -= dur
    return cfg.rate_schedule[-1][1]


def _next_arrival(cfg: WorkloadConfig, rng: np.random.Generator,
                  t: float, rate_max: Optional[float]) -> float:
    """The next arrival after ``t``: one exponential gap when the process
    is homogeneous (``rate_max`` None — the historical draw order, so
    seeded streams stay byte-identical), else Lewis-Shedler thinning —
    candidate gaps at the peak rate, accepted w.p. λ(t)/λ_max, which
    yields an exact inhomogeneous Poisson process."""
    if rate_max is None:
        return t + rng.exponential(1.0 / cfg.rps)
    while True:
        t += rng.exponential(1.0 / rate_max)
        if rng.random() * rate_max <= rate_at(cfg, t):
            return t


def generate(cfg: WorkloadConfig) -> List[Request]:
    """Open-loop client: (inhomogeneous) Poisson arrival process with
    shared-prefix groups — the arrival rate is fixed (or follows
    ``rate_schedule``) regardless of service speed."""
    rng = np.random.default_rng(cfg.seed)
    group_prefix_tokens, pop = _prefix_pool(cfg, rng)
    rate_max = (max(r for _, r in cfg.rate_schedule)
                if cfg.rate_schedule is not None else None)
    assert rate_max is None or rate_max > 0, \
        "rate_schedule needs at least one positive rate"
    reqs: List[Request] = []
    t = 0.0
    for rid in range(cfg.n_requests):
        t = _next_arrival(cfg, rng, t, rate_max)
        reqs.append(_make_request(cfg, rng, rid, t, group_prefix_tokens,
                                  pop))
    return reqs


def merge_workloads(*streams: Sequence[Request]) -> List[Request]:
    """Interleave independently-generated request streams (e.g. one per
    tenant, each with its own shape/rate) into one arrival-ordered
    workload with globally unique rids."""
    merged = sorted((r for s in streams for r in s),
                    key=lambda r: (r.arrival, r.tenant, r.rid))
    for rid, r in enumerate(merged):
        r.rid = rid
    return merged


class ClosedLoopClients:
    """Closed-loop client pool: ``n_clients`` concurrent sessions, each
    keeping exactly one request in flight — every completion triggers the
    next submission (after ``think_time_s`` virtual seconds).

    This is the saturation-experiment shape an open-loop Poisson process
    cannot express: offered load tracks service capacity by construction,
    so the system runs at a fixed concurrency instead of a fixed rps
    (``cfg.rps`` is ignored; ``cfg.n_requests`` bounds the total issued).
    Driven by ``api.Server.run_closed_loop``.
    """

    def __init__(self, cfg: WorkloadConfig, n_clients: int,
                 think_time_s: float = 0.0):
        assert n_clients >= 1
        self.cfg = cfg
        self.n_clients = n_clients
        self.think_time_s = float(think_time_s)
        # an independent stream derived from the same seed: a closed-loop
        # run over one config must NOT replay generate()'s exact prompts
        # (same-seed duplication), but must stay deterministic per seed
        self._rng = np.random.default_rng([cfg.seed, 1])
        self._pool, self._pop = _prefix_pool(cfg, self._rng)
        self.issued = 0

    def _next(self, t: float) -> Request:
        req = _make_request(self.cfg, self._rng, self.issued, t,
                            self._pool, self._pop)
        self.issued += 1
        return req

    def initial(self, now: float = 0.0) -> List[Request]:
        """The first wave: one request per client (capped by the total
        request budget), all arriving at ``now``."""
        n = min(self.n_clients, self.cfg.n_requests)
        return [self._next(now) for _ in range(n)]

    def on_complete(self, req: Request, now: float) -> Optional[Request]:
        """Called on EVERY terminal outcome (completed, rejected,
        aborted): the client submits its next request — arriving at
        ``now + think_time_s`` — or None once the total budget is
        exhausted.  Rejections burn budget instead of killing the
        client, so the pool's concurrency never silently shrinks."""
        if self.issued >= self.cfg.n_requests:
            return None
        return self._next(now + self.think_time_s)
