"""Algorithm 1 — Adaptive Module Migration (§4.4.1).

Periodic control cycle: measure normalized utilization U_d = C/C_max +
M/M_max on every device, classify overload/underload against threshold δ,
and migrate modules (layers, or KV head groups) from the most-loaded to the
least-loaded device while Benefit/Cost ≥ ρ.  Hysteresis (δ↑ to start, δ↓ to
stop) prevents oscillation.

The controller is pure policy: it consumes utilization snapshots and emits
``MigrationAction``s; execution is delegated to whatever runtime hosts it
(here the live orchestrator's ``apply_action``).  A copy of the JAX
package's framework-free ``core/migration.py``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class MigrationKind(str, enum.Enum):
    LAYER = "layer"           # coarse: weights + KV for contiguous layers
    KV_HEADS = "kv_heads"     # fine: KV head subset only (Fig. 4)


@dataclasses.dataclass(frozen=True)
class DeviceLoad:
    device: str
    compute_frac: float       # C/C_max ∈ [0,1]
    memory_frac: float        # M/M_max ∈ [0,1]
    supports_layer: bool = True
    supports_attention: bool = True

    @property
    def utilization(self) -> float:          # Eq. 32, range [0,2]
        return self.compute_frac + self.memory_frac


@dataclasses.dataclass(frozen=True)
class MigrationAction:
    kind: MigrationKind
    src: str
    dst: str
    amount: int                # layers or kv-head groups
    predicted_benefit: float   # Δ_before − Δ_after (Eq. 35)
    predicted_cost: float      # seconds


@dataclasses.dataclass
class ControllerConfig:
    delta_up: float = 0.35         # hysteresis: start migrating above this gap
    delta_down: float = 0.15       # ... stop once gap is below this
    rho: float = 0.5               # min Benefit/Cost ratio (Eq. 35)
    layer_step: int = 2            # layers moved per action
    head_step: int = 1             # kv-head groups per action
    max_actions_per_cycle: int = 4
    t_budget: float = 0.5          # per-cycle migration latency budget (Eq. 2)


class MigrationController:
    """Algorithm 1.  ``cost_fn(kind, src, dst, amount) -> (benefit, cost)``
    lets the host plug in the Eq. 4/11 analytical costs for its hardware."""

    def __init__(self, cfg: ControllerConfig,
                 cost_fn: Callable[[MigrationKind, DeviceLoad, DeviceLoad, int],
                                   Tuple[float, float]]):
        self.cfg = cfg
        self.cost_fn = cost_fn
        self._active = False       # hysteresis state

    def plan(self, loads: Sequence[DeviceLoad]) -> List[MigrationAction]:
        """One control cycle.  O(|D| + N_m) per Eq. 36."""
        if len(loads) < 2:
            return []
        util = {d.device: d.utilization for d in loads}
        lo, hi = min(util.values()), max(util.values())
        delta = self.cfg.delta_down if self._active else self.cfg.delta_up
        # Step 2: classify (Eq. 33)
        overload = [d for d in loads if util[d.device] - lo > delta]
        underload = [d for d in loads if hi - util[d.device] > delta]
        if not overload or not underload:
            self._active = False
            return []
        self._active = True

        actions: List[MigrationAction] = []
        budget = self.cfg.t_budget
        util = dict(util)
        # Step 3: migration decision loop
        while (overload and underload
               and len(actions) < self.cfg.max_actions_per_cycle):
            d_o = max(overload, key=lambda d: util[d.device])
            # try underloaded peers in ascending-utilization order until one
            # admits a profitable action (Benefit/Cost >= rho)
            best = None
            d_u_chosen = None
            for d_u in sorted(underload, key=lambda d: util[d.device]):
                gap = util[d_o.device] - util[d_u.device]
                if gap < delta or d_o.device == d_u.device:
                    continue
                # prefer coarse layer migration for large gaps, fine KV-head
                # migration otherwise (paper: "flexible trade-off")
                candidates = []
                if d_o.supports_layer:
                    candidates.append((MigrationKind.LAYER,
                                       self.cfg.layer_step))
                if d_o.supports_attention:
                    candidates.append((MigrationKind.KV_HEADS,
                                       self.cfg.head_step))
                for kind, amount in candidates:
                    benefit, cost = self.cost_fn(kind, d_o, d_u, amount)
                    if cost > budget or cost <= 0:
                        continue
                    ratio = benefit / cost
                    if ratio >= self.cfg.rho and (best is None
                                                  or ratio > best[0]):
                        best = (ratio, kind, amount, benefit, cost)
                        d_u_chosen = d_u
                if best is not None:
                    break
            if best is None:
                # nothing profitable from the hottest device: drop it and
                # consider the next-hottest (Algorithm 1's loop continues
                # while both sets are non-empty)
                overload = [d for d in overload if d is not d_o]
                continue
            _, kind, amount, benefit, cost = best
            d_u = d_u_chosen
            actions.append(MigrationAction(kind, d_o.device, d_u.device,
                                           amount, benefit, cost))
            budget -= cost
            # Step 4: update loads optimistically (half the gap moves)
            gap = util[d_o.device] - util[d_u.device]
            shift = min(benefit, gap / 2)
            util[d_o.device] -= shift
            util[d_u.device] += shift
            overload = [d for d in overload
                        if util[d.device] - min(util.values()) > delta]
            underload = [d for d in underload
                         if max(util.values()) - util[d.device] > delta]
        return actions
