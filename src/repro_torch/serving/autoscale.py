"""SLO-driven autoscaling over heterogeneous prefill/decode tiers.

The Algorithm 1 migration controller rebalances a *fixed* fleet; this
module is the policy layer above it that lets the fleet itself breathe
(ROADMAP item 3, grounded in "Taming the Chaos" coordinated autoscaling
and P/D-Serve's at-scale P/D-ratio adaptation).  It is pure policy —
deciding *whether* and *what* to scale from queue-delay / utilization /
attainment signals — while the backends own the mechanism:

* **scale-up** bills realistic warm-up on the virtual clock (full weight
  set streamed host→device at the part's DMA bandwidth plus a
  jit-compile cost — ``analytical.instance_warmup_time``) before the new
  instance takes any traffic, and the instance costs instance-seconds
  from the moment it is *ordered*;
* **scale-down** drains through the existing extract/adopt and
  span-migration machinery, so in-flight requests keep their exact token
  streams (pinned in tests/test_autoscale.py);
* **heterogeneity**: when several ``HardwareProfile``s are offered, the
  policy lands decode orders on the highest-HBM-bandwidth part (decode
  is memory-bound, Eq. 22) and prefill orders on the highest-FLOPs part
  (compute-bound, Eq. 20) — the same comparative advantage the
  load-aware router exploits through per-instance ``queue_delay_s``.

Both backends expose the same three hooks (``_autoscale_signals``,
``_scale_up``, ``_scale_down``) behind ``BackendBase.set_autoscaler``,
so one policy instance drives the discrete-event simulator at
hundreds-of-instances scale and the live orchestrator identically.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..core import analytical as A


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs.  Defaults favour stability over twitchiness: scale
    up on sustained modelled queue delay, down only when a tier is both
    idle *and* currently attaining its SLO."""
    # scale-up triggers: per-instance modelled backlog-drain seconds, OR
    # tier utilization at the ceiling (anticipatory — decode backlog only
    # becomes visible once every slot is full, which is already too late)
    target_delay_s: float = 1.0
    high_util: float = 0.9
    # scale-down triggers: tier utilization floor + attainment gate
    low_util: float = 0.3
    min_attainment: float = 0.9
    # decision cadence and per-tier cooldown between actions
    interval_s: float = 2.0
    cooldown_s: float = 4.0
    # fleet envelope (per tier)
    min_prefill: int = 1
    max_prefill: int = 64
    min_decode: int = 1
    max_decode: int = 64
    # at most this many instances ordered per tier per decision
    step_max: int = 4
    # warm-up billing: jit/trace seconds added to the weight-load time
    jit_compile_s: float = 2.0
    # hardware menu for new instances; None = backend default profile.
    # Ordering does not matter — the policy picks per tier by roofline.
    profiles: Optional[Tuple[A.HardwareProfile, ...]] = None


@dataclasses.dataclass
class TierSignals:
    """One tier's (prefill or decode) load snapshot, produced by the
    backend every control tick."""
    n_active: int                 # warmed, serving instances
    n_warming: int                # ordered, not yet taking traffic
    n_draining: int               # excluded from new work, not yet retired
    util: float                   # mean busy fraction over active, [0, 1]
    queue_delay_s: float          # modelled backlog seconds per active inst
    backlog: int                  # requests waiting for this tier

    @property
    def n_provisioned(self) -> int:
        return self.n_active + self.n_warming


@dataclasses.dataclass
class FleetSignals:
    t: float
    prefill: TierSignals
    decode: TierSignals
    # SLO attainment over the recent window (None = no SLO configured /
    # nothing terminal yet) — gates scale-down, never scale-up
    slo_attainment: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    role: str                     # "prefill" | "decode"
    delta: int                    # +k instances ordered / -k drains started
    profile: Optional[A.HardwareProfile]
    reason: str

    def __str__(self) -> str:
        hw = f" on {self.profile.name}" if self.profile else ""
        return f"{self.role}{self.delta:+d}{hw} ({self.reason})"


def pick_profile(role: str, profiles: Optional[Tuple[A.HardwareProfile, ...]]
                 ) -> Optional[A.HardwareProfile]:
    """Roofline-matched placement: decode is memory-bound → max HBM
    bandwidth; prefill is compute-bound → max peak FLOPs."""
    if not profiles:
        return None
    if role == "decode":
        return max(profiles, key=lambda p: (p.hbm_bw, p.peak_flops))
    return max(profiles, key=lambda p: (p.peak_flops, p.hbm_bw))


class SLOAutoscaler:
    """Turns ``FleetSignals`` into ``ScaleDecision``s.

    Scale-up: a tier whose modelled per-instance queue delay exceeds
    ``target_delay_s`` (with real backlog behind it) orders enough
    instances to bring the modelled delay back under target — discounted
    by capacity already warming, so one burst never double-orders.  A
    tier running at/above ``high_util`` with nothing warming orders one
    instance even before a backlog forms (anticipatory ramp).

    Scale-down: a tier under ``low_util`` with an empty backlog, nothing
    warming, and recent SLO attainment at/above ``min_attainment``
    drains one instance per decision (conservative by design: draining
    is cheap to repeat, thrash is not).
    """

    def __init__(self, cfg: AutoscaleConfig = AutoscaleConfig()):
        self.cfg = cfg
        self._last_tick: float = -math.inf
        self._last_action: Dict[str, float] = {"prefill": -math.inf,
                                               "decode": -math.inf}
        self.decisions: List[Tuple[float, ScaleDecision]] = []

    # -- helpers -----------------------------------------------------------
    def _bounds(self, role: str) -> Tuple[int, int]:
        c = self.cfg
        return ((c.min_prefill, c.max_prefill) if role == "prefill"
                else (c.min_decode, c.max_decode))

    def due(self, now: float) -> bool:
        return now - self._last_tick >= self.cfg.interval_s

    # -- the policy --------------------------------------------------------
    def plan(self, sig: FleetSignals) -> List[ScaleDecision]:
        """One decision round.  Call at control-tick cadence; internally
        rate-limited to ``interval_s`` (and per-tier ``cooldown_s``)."""
        if not self.due(sig.t):
            return []
        self._last_tick = sig.t
        out: List[ScaleDecision] = []
        for role, tier in (("prefill", sig.prefill), ("decode", sig.decode)):
            d = self._plan_tier(sig, role, tier)
            if d is not None:
                self._last_action[role] = sig.t
                self.decisions.append((sig.t, d))
                out.append(d)
        return out

    def _plan_tier(self, sig: FleetSignals, role: str,
                   tier: TierSignals) -> Optional[ScaleDecision]:
        c = self.cfg
        lo, hi = self._bounds(role)
        if sig.t - self._last_action[role] < c.cooldown_s:
            return None
        # capacity already ordered discounts the observed delay: k warming
        # instances will absorb ~ k/(active+k) of the backlog when ready
        n_act = max(tier.n_active, 1)
        eff_delay = tier.queue_delay_s * n_act / max(
            n_act + tier.n_warming, 1)
        if tier.backlog > 0 and eff_delay > c.target_delay_s \
                and tier.n_provisioned < hi:
            # order enough to bring modelled delay under target
            want = math.ceil(eff_delay / c.target_delay_s * n_act) - n_act \
                - tier.n_warming
            k = max(1, min(want, c.step_max, hi - tier.n_provisioned))
            return ScaleDecision(
                role, +k, pick_profile(role, c.profiles),
                f"queue_delay {eff_delay:.2f}s > {c.target_delay_s:.2f}s, "
                f"backlog {tier.backlog}")
        # hysteresis band top: running hot with nothing warming → order
        # one ahead of the backlog (cooldown paces the ramp)
        if tier.util >= c.high_util and tier.n_warming == 0 \
                and tier.n_provisioned < hi:
            return ScaleDecision(
                role, +1, pick_profile(role, c.profiles),
                f"util {tier.util:.2f} >= {c.high_util:.2f}, hot")
        attain_ok = (sig.slo_attainment is None
                     or sig.slo_attainment >= c.min_attainment)
        if tier.backlog == 0 and tier.n_warming == 0 \
                and tier.util < c.low_util and attain_ok \
                and tier.n_active - tier.n_draining > lo:
            return ScaleDecision(
                role, -1, None,
                f"util {tier.util:.2f} < {c.low_util:.2f}, idle")
        return None
