"""Discrete-event cluster simulator for disaggregated LLM serving.

Reproduces the paper's system-level comparisons (Figures 8–11) on this
CPU-only container: per-step costs come from the §4.3 analytical model
(core.analytical) instead of GPU wall clocks, so results are *relative*
orderings across systems, not absolute tokens/s.

Three system models share one event loop:

* ``colocated``  (vLLM-like): every instance serves prefill AND decode;
  prefill jobs preempt decode iterations (compute contention — §2.2).
* ``static_pd``  (DistServe-like): fixed prefill/decode instance split,
  per-instance prefix caches, prefix-cache-aware routing (Fig. 2a baseline),
  KV transfer charged between tiers.
* ``banaserve``: PD split + Global KV Cache Store (shared prefix cache, no
  locality constraint), load-aware routing (Algorithm 2), and the Algorithm 1
  migration controller continuously shifting capacity between the prefill
  and decode roles (layer-level) and across decode instances (KV-head
  level).

Capacity abstraction: layer-level migration moves fractions of an
instance's compute between roles (a GPU holding k of N layers of the
prefill replica contributes k/N of a GPU to the prefill tier) — the
system-level effect of Fig. 3 without simulating per-layer pipelines.

A copy of the JAX package's framework-free ``serving/cluster.py``; its
imports resolve inside the port (``python -m repro_torch.launch.serve
--backend sim`` drives it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import analytical as A
from ..core.kvstore import GlobalKVStore
from ..core.migration import (ControllerConfig, DeviceLoad, MigrationAction,
                              MigrationController, MigrationKind)
from ..core.pipeline import PipelineModel
from ..core.scheduling import (InstanceLoad, LoadAwareRouter,
                               PrefixAwareRouter, RequestInfo,
                               RoundRobinRouter)
from ..models.config import ModelConfig
from .api import BackendBase
from .autoscale import FleetSignals, TierSignals
from .clock import VirtualClock
from .request import SLO, Metrics, Phase, Request
from .workload import WorkloadConfig, generate


@dataclasses.dataclass(frozen=True)
class SimConfig:
    model: ModelConfig
    mode: str = "banaserve"            # colocated | static_pd | banaserve
    hw: A.HardwareProfile = A.A100_80G
    # heterogeneous fleets: per-instance profiles cycled over the initial
    # fleet (prefill tier first, then decode).  None = homogeneous ``hw``.
    # Cost billing, load reports and the migration controller all see the
    # instance's own part, so the router lands work by actual speed.
    profiles: Optional[Tuple[A.HardwareProfile, ...]] = None
    n_instances: int = 4
    prefill_fraction: float = 0.5      # initial/static role split (PD modes)
    decode_batch_max: int = 64
    router: str = "load_aware"         # load_aware | prefix_aware | round_robin
    global_store: bool = True
    migration: bool = True
    control_interval: float = 0.25
    efficiency: float = 0.5            # MFU for prefill compute
    local_cache_groups: int = 2        # per-instance prefix cache capacity
    util_window: float = 1.0           # utilization EMA window (s)
    slo: Optional[SLO] = None          # TTFT/TPOT targets (goodput/attain)
    # speculative decoding (analytical twin of EngineConfig.speculation):
    # the sim has no real tokens, so acceptance is an assumed rate and
    # iterations commit the expected token count.  The same load-aware
    # flip as the live orchestrator decides per iteration whether the
    # speculative cost-per-committed-token beats a plain step.
    speculation: str = "off"           # off | ngram | draft
    spec_len: int = 4                  # proposed tokens per iteration (k)
    spec_accept: float = 0.7           # assumed per-proposal acceptance
    draft_model: Optional[ModelConfig] = None   # billed when "draft"
    # preemption-aware decode placement: > 0 demotes targets where taking
    # the request would evict a resident below every target with a free
    # slot (the default — today's behaviour); 0 ranks risky targets
    # purely by service rate, i.e. risk-blind (the preemption-frontier A/B)
    preempt_penalty: float = 1.0

    @staticmethod
    def preset(model: ModelConfig, system: str, n_instances: int = 4,
               hw: A.HardwareProfile = A.A100_80G) -> "SimConfig":
        if system == "vllm":
            return SimConfig(model, "colocated", hw,
                             n_instances=n_instances,
                             router="prefix_aware", global_store=False,
                             migration=False)
        if system == "distserve":
            return SimConfig(model, "static_pd", hw,
                             n_instances=n_instances,
                             router="prefix_aware", global_store=False,
                             migration=False)
        if system == "banaserve":
            return SimConfig(model, "banaserve", hw,
                             n_instances=n_instances,
                             router="load_aware", global_store=True,
                             migration=True)
        raise ValueError(system)


@dataclasses.dataclass
class _DecodeSlot:
    req: Request
    remaining: int
    context: int
    # fractional committed-token carry under speculation: each iteration
    # adds E[tokens/iter]; whole tokens commit, the remainder accumulates
    credit: float = 0.0


class _Instance:
    def __init__(self, name: str, prefill_cap: float, decode_cap: float,
                 hw: A.HardwareProfile = A.A100_80G):
        self.name = name
        self.prefill_cap = prefill_cap
        self.decode_cap = decode_cap
        self.hw = hw                      # this part's roofline — all costs
        self.warming_until = 0.0          # autoscaled: no traffic before
        self.draining = False             # autoscaled: no NEW work; retires
        self.prefill_queue: List[Request] = []
        # modelled seconds of queued prefill work on THIS part's roofline,
        # maintained incrementally at enqueue/dequeue — re-summing the
        # queue per routing decision was a 10^5-request-scale hot loop
        self.queued_prefill_s = 0.0
        self.inflight_prefill = 0         # prefill_done events outstanding
        self.busy_until = 0.0
        self.decode_slots: List[_DecodeSlot] = []
        self.decode_iter_scheduled = False
        self.spec_pending = False      # the in-flight iteration speculates
        self.kv_tokens = 0
        self.busy: float = 0.0            # cumulative compute-busy seconds
        self.util_ema = 0.0
        self._last_util_t = 0.0
        self.local_prefix: Dict[int, int] = {}
        self.mig_frozen_until = 0.0       # capacity unavailable during move
        self.work_p = 0.0                 # cumulative prefill work (cap-1 s)
        self.work_d = 0.0                 # cumulative decode work (cap-1 s)

    def compute_frac(self, now: float, window: float) -> float:
        return min(self.util_ema, 1.0)

    def note_busy(self, start: float, dur: float, window: float):
        self.busy += dur
        # EMA update at completion time
        t = start + dur
        dt = max(t - self._last_util_t, 1e-9)
        inst_util = min(dur / dt, 1.0)
        a = min(dt / window, 1.0)
        self.util_ema = (1 - a) * self.util_ema + a * inst_util
        self._last_util_t = t

    def decay_util(self, now: float, window: float):
        # branch-only (no min/max calls): runs once per instance per
        # routing decision, which is millions of times at 10^5 requests
        dt = now - self._last_util_t
        if dt > 0.0:
            a = dt / window
            self.util_ema *= (1.0 - a) if a < 1.0 else 0.0
            self._last_util_t = now


class ClusterSim(BackendBase):
    """The analytical serving backend: the same ``ServingBackend``
    surface — and the same ``api.BackendBase`` submit/step/abort/drain
    code — as the live orchestrator, with event costs from the §4.3
    model instead of real forwards.  ``workload`` is optional — it only
    feeds the legacy ``run()`` convenience; open-loop callers submit
    their own requests."""

    def __init__(self, cfg: SimConfig,
                 workload: Optional[WorkloadConfig] = None):
        self.cfg = cfg
        self.wcfg = workload
        self.model = cfg.model
        self.metrics = Metrics(slo=cfg.slo)
        # the shared virtual clock (serving/clock.py) — same event-loop
        # substrate as the live orchestrator
        self.clock = VirtualClock()
        self.migration_log: List[Tuple[float, MigrationAction]] = []
        self.util_trace: List[Tuple[float, Dict[str, float]]] = []

        n = cfg.n_instances

        def hw_for(i: int) -> A.HardwareProfile:
            if cfg.profiles:
                return cfg.profiles[i % len(cfg.profiles)]
            return cfg.hw
        if cfg.mode == "colocated":
            self.instances = [_Instance(f"gpu{i}", 1.0, 1.0, hw_for(i))
                              for i in range(n)]
            self.prefill_insts = self.instances
            self.decode_insts = self.instances
        else:
            n_p = max(1, int(round(n * cfg.prefill_fraction)))
            n_p = min(n_p, n - 1)
            self.instances = (
                [_Instance(f"prefill{i}", 1.0, 0.0, hw_for(i))
                 for i in range(n_p)]
                + [_Instance(f"decode{i}", 0.0, 1.0, hw_for(n_p + i))
                   for i in range(n - n_p)])
            self.prefill_insts = self.instances[:n_p]
            self.decode_insts = self.instances[n_p:]
        self.by_name = {i.name: i for i in self.instances}
        self.retired: List[_Instance] = []    # drained-down instances
        self._scale_seq = 0                   # autoscaled-instance naming
        # fleet-wide (prefill_cap, decode_cap) totals, invalidated on the
        # few events that change capacity: scale-up, retire, layer
        # migration.  _migration_cost reads this per candidate pair.
        self._caps_cache: Optional[Tuple[float, float]] = None
        # (prefill, decode) serving-candidate lists — eligibility only
        # flips at discrete events (warmed, draining, add/remove, layer
        # migration), so the per-event O(fleet) scans cache between them
        self._cands_cache: Optional[
            Tuple[List[_Instance], List[_Instance]]] = None

        if cfg.router == "load_aware":
            self.router = LoadAwareRouter(
                preempt_penalty=cfg.preempt_penalty)
        elif cfg.router == "prefix_aware":
            self.router = PrefixAwareRouter()
        else:
            self.router = RoundRobinRouter()

        self.store = GlobalKVStore(block_size=64) if cfg.global_store else None
        self.global_prefix: Dict[int, int] = {}   # prefix_id -> cached len

        if cfg.migration and cfg.mode == "banaserve":
            self.controller = MigrationController(
                ControllerConfig(rho=1.0, max_actions_per_cycle=2),
                self._migration_cost)
        else:
            self.controller = None
        self._last_work: Dict[str, Tuple[float, float]] = {
            i.name: (0.0, 0.0) for i in self.instances}
        # requests whose prefill finished against a saturated decode tier:
        # FIFO, drained event-driven (decode completions / capacity events)
        # instead of the 10 ms polling retry the sim used to schedule —
        # at 10^5-request scale the poll events dominated the heap
        self._decode_waiters: List[Tuple[str, Request]] = []
        # banaserve: Algorithm 2 dispatches from a central queue each cycle
        # (requests are never stranded on an instance whose capacity moved)
        self.pending: List[Request] = []
        self._last_ctl_t = 0.0
        self._tier_rates = (0.0, 0.0)     # (prefill, decode) demand rates
        self._layer_dir: Optional[str] = None   # anti-thrash cooldown
        self._layer_dir_t = -1e9
        self._control_armed = False
        self._n_transit = 0     # mid-prefill or awaiting a decode slot
        # preempted decode residents parked off-tier: (request, remaining
        # tokens, context, mode).  Swap bills host-tier bandwidth on the
        # way back; sacrifice bills a full re-prefill of the context.
        self._preempted: List[tuple] = []
        self.swap_io_s = 0.0    # modelled preemption swap traffic
        # load-aware speculation routing counters (mirrors Orchestrator)
        self.spec_iters = 0
        self.plain_iters = 0
        self._init_backend()    # _by_rid registry + admission_limit

    # ------------------------------------------------------------------
    @property
    def now(self) -> float:
        return self.clock.now

    def _push(self, t: float, kind: str, payload=None):
        self.clock.push(t, kind, payload)

    # -- the ServingBackend surface ---------------------------------------
    @property
    def fleet(self) -> Dict[str, str]:
        """Instance name -> current role, by capacity split (migration
        moves fractional capacity, so a partially-migrated instance reads
        ``colocated``)."""
        out = {}
        for i in self.instances:
            if i.prefill_cap > 0 and i.decode_cap > 0:
                role = "colocated"
            elif i.prefill_cap > 0:
                role = "prefill"
            elif i.decode_cap > 0:
                role = "decode"
            else:
                role = "idle"
            if i.warming_until > self.now:
                role += ":warming"
            elif i.draining:
                role += ":draining"
            out[i.name] = role
        return out

    def _role_of(self, inst: _Instance) -> str:
        return "prefill" if inst.prefill_cap >= inst.decode_cap else "decode"

    def in_flight(self) -> int:
        """Requests admitted and not yet terminal: queued centrally or on
        an instance, mid-prefill/transfer (including waiting out a
        saturated decode tier — part of ``_n_transit``), or holding a
        decode slot."""
        return (len(self.pending)
                + sum(len(i.prefill_queue) for i in self.instances)
                + sum(len(i.decode_slots) for i in self.instances)
                + self._n_transit
                + len(self._preempted))

    def _arm_control(self) -> None:
        if not self._control_armed:
            self._push(self.now + self.cfg.control_interval, "control")
            self._control_armed = True

    # submit / step / step_until / drain come from api.BackendBase; only
    # the structure-search half of ``abort`` is backend-specific.
    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it lives: central queue, instance
        prefill queue, a decode slot (its modelled KV frees immediately),
        or mid-prefill (dropped at its hand-off event)."""
        req = self._by_rid.get(rid)
        if req is None or req.outcome is not None or req.phase == Phase.DONE:
            return False
        if req in self.pending:
            self.pending.remove(req)
            return self._finish_abort(req)
        for inst in self.instances:
            if req in inst.prefill_queue:
                inst.prefill_queue.remove(req)
                self._unqueue_prefill(inst, req)
                return self._finish_abort(req)
            for slot in inst.decode_slots:
                if slot.req is req:
                    inst.decode_slots.remove(slot)
                    inst.kv_tokens -= slot.context
                    return self._finish_abort(req)
        for i, parked in enumerate(self._preempted):  # preemption-parked
            if parked[0] is req:
                self._preempted.pop(i)
                return self._finish_abort(req)
        # mid-prefill or arrival still scheduled: the matching handler
        # drops terminal requests when it fires
        return self._finish_abort(req)

    def _handle(self, ev) -> List[Request]:
        kind, payload = ev.kind, ev.payload
        if kind == "arrival":
            if self._admit(payload):   # bounced: aborted or queue full
                self._on_arrival(payload)
        elif kind == "prefill_done":
            name, req = payload
            self._on_prefill_done(self.by_name[name], req)
        elif kind == "decode_kick":
            self._schedule_decode(self.by_name[payload])
        elif kind == "decode_done":
            return self._on_decode_done(self.by_name[payload])
        elif kind == "control":
            self._on_control()
        elif kind == "warmed":
            self._on_warmed(payload)
        else:
            raise ValueError(f"unknown event kind {kind!r}")
        return []

    # -- cost models -----------------------------------------------------
    def _prefill_time(self, inst: _Instance, req: Request,
                      cached: int) -> float:
        eff_len = max(req.prompt_len - cached, 1)
        t = A.prefill_time(self.model, eff_len, inst.hw,
                           efficiency=self.cfg.efficiency)
        cap = max(inst.prefill_cap, 0.05)
        t = t / cap
        if cached > 0:
            # layer-wise overlapped fetch: charge only the residual stall
            pm = PipelineModel.from_workload(
                t_forward_total=t, hit_rate=cached / max(req.prompt_len, 1),
                n_layers=self.model.n_layers,
                kv_bytes_per_token_layer=self.model.
                kv_bytes_per_token_per_layer(),
                seq_len=req.prompt_len, bandwidth_bps=inst.hw.host_bw)
            t += pm.residual_stall()
        return t

    def _decode_iter_time(self, inst: _Instance,
                          speculate: bool = False) -> float:
        if not inst.decode_slots:
            return 0.0
        batch = len(inst.decode_slots)
        ctx = int(sum(s.context for s in inst.decode_slots) / batch)
        if speculate:
            t = A.speculative_decode_iter_time(
                self.model, ctx, inst.hw, batch=batch,
                k=max(self.cfg.spec_len, 1),
                draft_cfg=(self.cfg.draft_model
                           if self.cfg.speculation == "draft" else None))
        else:
            t = A.decode_time_per_token(self.model, ctx, inst.hw,
                                        batch=batch)
        t = t / max(inst.decode_cap, 0.05)
        if self.cfg.mode == "colocated":
            t += 1.5e-3        # monolithic scheduler overhead per iteration
        return t

    def _spec_decide(self, inst: _Instance) -> bool:
        """The orchestrator's load-aware speculation flip, analytically:
        speculate iff the (k+1)-wide verify iteration's cost per expected
        committed token undercuts a plain step at this batch/context."""
        if self.cfg.speculation == "off" or not inst.decode_slots:
            return False
        plain = self._decode_iter_time(inst, speculate=False)
        spec = self._decode_iter_time(inst, speculate=True)
        e_tok = A.speculative_tokens_per_iter(max(self.cfg.spec_len, 1),
                                              self.cfg.spec_accept)
        speculate = spec / e_tok < plain
        if speculate:
            self.spec_iters += 1
        else:
            self.plain_iters += 1
        return speculate

    # -- migration plumbing ------------------------------------------------
    def _layer_quantum(self, amount: int) -> float:
        """Capacity fraction moved by migrating ``amount`` layer groups.
        Scaled so repeated actions converge to a full role flip quickly —
        fractional decode capacity amortizes weight reads poorly, so the
        controller prefers whole-instance repurposing."""
        return min(1.0, amount / max(self.model.n_layers, 1) * 20)

    def _tier_demands(self) -> Tuple[float, float]:
        """(D_p, D_d): cluster demand per role in cap-1 GPU-seconds/second,
        including queued prefill backlog amortized over a short horizon."""
        dt = max(self.now - self._last_ctl_t, 1e-6)
        horizon = 4 * self.cfg.control_interval
        d_p = d_d = 0.0
        for inst in self.instances:
            lp, ld = self._last_work.get(inst.name, (0.0, 0.0))
            d_p += (inst.work_p - lp) / dt
            d_d += (inst.work_d - ld) / dt
            d_p += inst.queued_prefill_s / horizon
        horizon2 = 4 * self.cfg.control_interval
        for req in self.pending:
            d_p += A.prefill_time(self.model, req.prompt_len, self.cfg.hw,
                                  efficiency=self.cfg.efficiency) / horizon2
        # requests bounced off a full decode tier = unmet slot demand
        # (waiters park for ~their whole wait, so weight by the interval
        # over the old 10 ms retry quantum to keep the signal's magnitude)
        d_d += (len(self._decode_waiters) * (dt / 0.01)
                / max(self.cfg.decode_batch_max, 1))
        return d_p, d_d

    def _tier_caps(self) -> Tuple[float, float]:
        # hot: the controller's cost callback evaluates this per candidate
        # pair (O(fleet) per call, ~10^5 calls per large run) — capacity
        # only changes on scale-up/retire/layer-migration, so cache it
        if self._caps_cache is None:
            self._caps_cache = (
                sum(i.prefill_cap for i in self.instances),
                sum(i.decode_cap for i in self.instances))
        return self._caps_cache

    def _starved_role_global(self) -> str:
        d_p, d_d = self._tier_rates
        c_p, c_d = self._tier_caps()
        return "prefill" if d_p / max(c_p, 1e-6) >= d_d / max(c_d, 1e-6) \
            else "decode"

    def _migration_cost(self, kind: MigrationKind, d_o: DeviceLoad,
                        d_u: DeviceLoad, amount: int
                        ) -> Tuple[float, float]:
        src = self.by_name[d_o.device]
        dst = self.by_name[d_u.device]
        step = self._layer_quantum(amount)
        if kind == MigrationKind.LAYER:
            cost = A.layer_migration_time(self.model, amount,
                                          kv_tokens=src.kv_tokens,
                                          hw=self.cfg.hw)
            # truthful benefit: reduction in max tier utilization after
            # repurposing `step` of dst's capacity toward the starved role
            d_p, d_d = self._tier_rates
            c_p, c_d = self._tier_caps()
            role = self._starved_role_global()
            if role == "prefill":
                m = min(step, dst.decode_cap, max(c_d - 0.25, 0.0))
                c_p2, c_d2 = c_p + m, c_d - m
            else:
                m = min(step, dst.prefill_cap, max(c_p - 0.25, 0.0))
                c_p2, c_d2 = c_p - m, c_d + m
            if m <= 1e-9:
                return 0.0, max(cost, 1e-6)
            # anti-thrash: direction reversals need a 2 s cooldown
            if (self._layer_dir is not None and self._layer_dir != role
                    and self.now - self._layer_dir_t < 2.0):
                return 0.0, max(cost, 1e-6)
            u = lambda d, c: d / max(c, 1e-6)
            before = max(u(d_p, c_p), u(d_d, c_d))
            after = max(u(d_p, c_p2), u(d_d, c_d2))
            benefit = (before - after) * 2.0
        else:
            kv_share = src.kv_tokens // max(self.model.n_kv_heads, 1)
            cost = A.attention_migration_time(self.model, amount,
                                              kv_tokens=kv_share,
                                              hw=self.cfg.hw)
            gap = d_o.utilization - d_u.utilization
            # rebalances decode load only if both ends decode
            can = (src.decode_cap > 0 and dst.decode_cap > 0
                   and len(src.decode_slots) > 2 * len(dst.decode_slots)
                   and len(dst.decode_slots) < self.cfg.decode_batch_max)
            benefit = gap * 0.25 if can else 0.0
        return benefit, max(cost, 1e-6)

    def _apply_migration(self, act: MigrationAction):
        src = self.by_name[act.src]
        dst = self.by_name[act.dst]
        step = act.amount / max(self.model.n_layers, 1) * 8
        if act.kind == MigrationKind.LAYER:
            # Fig. 3: layers of the starved role's replica move onto the
            # underloaded device — i.e. dst's idle capacity is repurposed.
            role = self._starved_role_global()
            self._layer_dir = role
            self._layer_dir_t = self.now
            # never drain a role below a cluster-wide floor (the serving
            # path must always exist — Eq. 2's feasibility constraint)
            tot_p, tot_d = self._tier_caps()
            if role == "prefill":
                moved = min(step, dst.decode_cap, max(tot_d - 0.25, 0.0))
                dst.decode_cap -= moved
                dst.prefill_cap += moved
            else:
                moved = min(step, dst.prefill_cap, max(tot_p - 0.25, 0.0))
                dst.prefill_cap -= moved
                dst.decode_cap += moved
            self._invalidate_fleet_caches()
            if role == "prefill" and moved > 0 and dst.decode_slots:
                # the migrated layers' KV moves too: evacuate the same
                # fraction of resident decode requests to other decoders
                frac = moved / max(dst.decode_cap + moved, 1e-9)
                n_ev = int(len(dst.decode_slots) * frac)
                others = [i for i in self._decode_candidates()
                          if i is not dst
                          and len(i.decode_slots) < self.cfg.decode_batch_max]
                while n_ev > 0 and others:
                    tgt = min(others, key=lambda i: len(i.decode_slots))
                    if len(tgt.decode_slots) >= self.cfg.decode_batch_max:
                        others.remove(tgt)
                        continue
                    slot = dst.decode_slots.pop()
                    dst.kv_tokens -= slot.context
                    tgt.kv_tokens += slot.context
                    tgt.decode_slots.append(slot)
                    self._schedule_decode(tgt)
                    n_ev -= 1
            if self.cfg.mode == "banaserve":
                self._dispatch_pending()
            elif dst.prefill_cap > 0 and dst.prefill_queue:
                self._try_start_prefill(dst)
        else:  # KV_HEADS: move decode slots (KV) from hot to cold decoder
            n_move = max(1, len(src.decode_slots) // 4)
            for _ in range(n_move):
                if not src.decode_slots or \
                        len(dst.decode_slots) >= self.cfg.decode_batch_max:
                    break
                slot = src.decode_slots.pop()
                src.kv_tokens -= slot.context
                dst.kv_tokens += slot.context
                dst.decode_slots.append(slot)
            self._schedule_decode(dst)
        dst.mig_frozen_until = self.now + act.predicted_cost
        self.migration_log.append((self.now, act))
        self._drain_decode_waiters()   # capacity may have opened a slot

    # -- load snapshots -----------------------------------------------------
    def _device_loads(self) -> List[DeviceLoad]:
        out = []
        kv_bytes_tok = self.model.kv_bytes_per_token()
        dt = max(self.now - self._last_ctl_t, 1e-6)
        horizon = 4 * self.cfg.control_interval
        for inst in self.instances:
            if inst.warming_until > self.now or inst.draining:
                continue    # the migration controller leaves them alone
            inst.decay_util(self.now, self.cfg.util_window)
            mem = inst.kv_tokens * kv_bytes_tok / inst.hw.hbm_bytes
            lp, ld = self._last_work.get(inst.name, (0.0, 0.0))
            rate = ((inst.work_p - lp) + (inst.work_d - ld)) / dt
            backlog = inst.queued_prefill_s / horizon
            total_cap = max(inst.prefill_cap + inst.decode_cap, 1e-6)
            out.append(DeviceLoad(
                device=inst.name,
                compute_frac=min((rate + backlog) / total_cap, 1.0),
                memory_frac=min(mem * 8, 1.0),   # KV pool is ~1/8 of HBM
                supports_layer=True,
                supports_attention=(inst.decode_cap > 0),
            ))
        return out

    def _instance_loads(self, insts: List[_Instance]) -> List[InstanceLoad]:
        out = []
        kv_bytes_tok = self.model.kv_bytes_per_token()
        can_evict = (self.scheduler is not None
                     and self.scheduler.preemption is not None)
        prefix_aware = isinstance(self.router, PrefixAwareRouter)
        now = self.now
        window = self.cfg.util_window
        batch_max = self.cfg.decode_batch_max
        for inst in insts:
            inst.decay_util(now, window)
            # compute_frac (== clamped util_ema) inlined: this loop runs
            # per routing decision over the whole candidate fleet
            util = inst.util_ema
            if util > 1.0:
                util = 1.0
            mem = min(inst.kv_tokens * kv_bytes_tok * 8
                      / inst.hw.hbm_bytes, 1.0) if inst.kv_tokens else 0.0
            # the instance's own roofline prices its backlog: a v5p
            # drains the same queue ~2.3x faster than a v5e, and the
            # queue-delay-aware router sees exactly that
            cap = inst.prefill_cap
            if cap < 0.05:
                cap = 0.05
            backlog = inst.queued_prefill_s / cap
            il = InstanceLoad(inst.name,
                              load=util + mem,
                              queue_len=len(inst.prefill_queue),
                              queue_delay_s=backlog,
                              preempt_risk=(1.0 if can_evict
                                            and inst.decode_cap > 0
                                            and len(inst.decode_slots)
                                            >= batch_max
                                            else 0.0))
            if prefix_aware:      # only the baseline router reads this
                il.cached_prefix_tokens = {
                    bytes([gid % 256]): ln
                    for gid, ln in inst.local_prefix.items()}
            out.append(il)
        return out

    # -- event handlers -----------------------------------------------------
    def _serving(self, inst: _Instance) -> bool:
        """Eligible for NEW work: warmed up and not draining (draining
        instances keep running what they hold until it migrates off)."""
        return inst.warming_until <= self.now and not inst.draining

    def _invalidate_fleet_caches(self) -> None:
        self._caps_cache = None
        self._cands_cache = None

    def _prefill_candidates(self) -> List[_Instance]:
        if self._cands_cache is None:
            self._cands_cache = (
                [i for i in self.instances
                 if i.prefill_cap > 0 and self._serving(i)],
                [i for i in self.instances
                 if i.decode_cap > 0 and self._serving(i)])
        return self._cands_cache[0]

    def _decode_candidates(self) -> List[_Instance]:
        if self._cands_cache is None:
            self._prefill_candidates()
        return self._cands_cache[1]

    def _on_arrival(self, req: Request):
        if self.cfg.mode == "banaserve":
            self.pending.append(req)
            self._dispatch_pending()
            return
        loads = self._instance_loads(self._prefill_candidates())
        pkey = None
        if req.prefix_id is not None:
            pkey = bytes([req.prefix_id % 256])
        info = RequestInfo(req.rid, req.prompt_len,
                           est_load=min(req.prompt_len / 4096, 1.0),
                           prefix_key=pkey,
                           est_time_s=A.prefill_time(
                               self.model, req.prompt_len, self.cfg.hw,
                               efficiency=self.cfg.efficiency))
        plan = self.router.dispatch([info], loads)
        inst = self.by_name[plan[req.rid]]
        req.prefill_instance = inst.name
        req.advance(Phase.ROUTED)
        self._enqueue_prefill(inst, req)
        self._try_start_prefill(inst)

    def _dispatch_pending(self):
        """Algorithm 2 over the central queue: hand requests to idle
        prefill-capable instances, least-loaded first.

        Loads are snapshotted ONCE per call and each chosen instance is
        dropped from the candidate list (it just went busy) — behaviour-
        identical to recomputing per request (an idle instance's load
        cannot change between two dispatches at one timestamp) but O(n)
        instead of O(n²), which is what makes 10^5-request runs over
        hundreds of instances tractable."""
        if not self.pending:
            return
        now = self.now
        idle = [i for i in self._prefill_candidates()
                if i.busy_until <= now and not i.prefill_queue]
        if not idle:
            return
        loads = self._instance_loads(idle)
        while self.pending and loads:
            i = (self.scheduler.pick(self.pending, self.now)
                 if self.scheduler is not None else 0)
            req = self.pending.pop(i)
            info = RequestInfo(req.rid, req.prompt_len,
                               est_load=min(req.prompt_len / 4096, 1.0),
                               est_time_s=A.prefill_time(
                                   self.model, req.prompt_len, self.cfg.hw,
                                   efficiency=self.cfg.efficiency))
            plan = self.router.dispatch([info], loads)
            inst = self.by_name[plan[req.rid]]
            loads = [l for l in loads if l.name != inst.name]
            req.prefill_instance = inst.name
            req.advance(Phase.ROUTED)
            self._enqueue_prefill(inst, req)
            self._try_start_prefill(inst)

    def _cached_tokens(self, inst: _Instance, req: Request) -> int:
        if req.prefix_id is None:
            return 0
        if self.store is not None:                     # Global KV Store
            got = self.global_prefix.get(req.prefix_id, 0)
            return min(got, req.prefix_len)
        got = inst.local_prefix.get(req.prefix_id, 0)  # local cache only
        return min(got, req.prefix_len)

    # Every prefill_queue mutation goes through these two so the
    # incremental queued-work counter (queued_prefill_s) stays in sync.
    def _enqueue_prefill(self, inst: _Instance, req: Request) -> None:
        inst.prefill_queue.append(req)
        inst.queued_prefill_s += A.prefill_time(
            self.model, req.prompt_len, inst.hw,
            efficiency=self.cfg.efficiency)

    def _unqueue_prefill(self, inst: _Instance, req: Request) -> None:
        inst.queued_prefill_s -= A.prefill_time(
            self.model, req.prompt_len, inst.hw,
            efficiency=self.cfg.efficiency)
        if not inst.prefill_queue:      # pin out accumulated float drift
            inst.queued_prefill_s = 0.0

    def _try_start_prefill(self, inst: _Instance):
        if inst.busy_until > self.now or not inst.prefill_queue:
            return
        if inst.prefill_cap <= 0:
            return
        # colocated contention: prefill preempts — decode iters stall behind
        req = inst.prefill_queue.pop(0)
        self._unqueue_prefill(inst, req)
        req.advance(Phase.PREFILL)
        self._n_transit += 1
        cached = self._cached_tokens(inst, req)
        req.cached_tokens = cached
        req.t_prefill_start = self.now
        dur = self._prefill_time(inst, req, cached)
        inst.work_p += dur * max(inst.prefill_cap, 0.05)
        inst.busy_until = self.now + dur
        inst.inflight_prefill += 1
        inst.note_busy(self.now, dur, self.cfg.util_window)
        self._push(self.now + dur, "prefill_done", (inst.name, req))

    def _on_prefill_done(self, inst: _Instance, req: Request):
        inst.inflight_prefill -= 1
        if req.outcome is not None:
            # aborted mid-prefill (or while waiting out a saturated decode
            # tier): drop its KV, let the instance move on
            self._n_transit -= 1
            self._try_start_prefill(inst)
            if self.cfg.mode == "banaserve":
                self._dispatch_pending()
            self._try_retire(inst)
            return
        # record cache contents
        if req.prefix_id is not None:
            if self.store is not None:
                self.global_prefix[req.prefix_id] = max(
                    self.global_prefix.get(req.prefix_id, 0), req.prefix_len)
            else:
                if len(inst.local_prefix) >= self.cfg.local_cache_groups and \
                        req.prefix_id not in inst.local_prefix:
                    inst.local_prefix.pop(next(iter(inst.local_prefix)))
                inst.local_prefix[req.prefix_id] = req.prefix_len
        if not self._finish_prefill(inst.name, req):
            # decode tier saturated: park in the waiter queue (the prefill
            # instance stays head-of-line blocked, exactly like the old
            # polling retry) — drained event-driven when a slot frees
            self._decode_waiters.append((inst.name, req))

    def _place_decode(self, req: Request) -> Optional[_Instance]:
        """Pick a decode target by modelled service rate: decode is
        memory-bound (Eq. 22), so a part with k× the HBM bandwidth
        drains the same batch k× faster — occupancy is priced relative
        to that speed.  Full instances stay in the pool (when the
        scheduler can evict) at a rank demotion of
        ``cfg.preempt_penalty`` — the default (1.0) never evicts while
        any free slot exists; 0 is risk-blind placement (a fast-but-full
        part may outrank an open slow one and trigger an eviction — the
        preemption-aware-routing A/B).  Returns None when the tier is
        saturated and no victim is eligible."""
        cands = self._decode_candidates()
        if not cands:
            return None
        can_evict = (self.scheduler is not None
                     and self.scheduler.preemption is not None)
        ref_bw = self.cfg.hw.hbm_bw
        batch_max = self.cfg.decode_batch_max
        penalty = self.cfg.preempt_penalty
        rank = lambda i: ((len(i.decode_slots) + 1) * ref_bw
                          / (max(i.decode_cap, 0.05) * i.hw.hbm_bw),
                          i.kv_tokens)
        best, best_key = None, None
        for i in cands:
            n_slots = len(i.decode_slots)
            full = n_slots >= batch_max
            if full and not can_evict:
                continue
            cap = i.decode_cap
            if cap < 0.05:
                cap = 0.05
            key = (penalty if full else 0.0,
                   (n_slots + 1) * ref_bw / (cap * i.hw.hbm_bw),
                   i.kv_tokens)
            if best_key is None or key < best_key:
                best, best_key = i, key
        if best is None:
            return None
        if len(best.decode_slots) >= self.cfg.decode_batch_max:
            # ranked target is full: evict per the scheduler's policy,
            # then place into whatever slot that freed (or fall back to
            # any open peer if no victim ranks below this request)
            self._preempt_for(req)
            open_ = [i for i in cands
                     if len(i.decode_slots) < self.cfg.decode_batch_max]
            if not open_:
                return None
            best = min(open_, key=rank)
        return best

    def _finish_prefill(self, src_name: str, req: Request) -> bool:
        """Hand a prefill-complete request to the decode tier.  False =
        no slot available (caller parks it in ``_decode_waiters``)."""
        dec = self._place_decode(req)
        if dec is None:
            return False
        src = self.by_name.get(src_name)   # may have retired while parked
        t_x = 0.0
        if dec is not src:
            t_x = A.kv_transfer_time(self.model, req.prompt_len, self.cfg.hw)
        req.decode_instance = dec.name
        if req.phase != Phase.TRANSFER:
            req.advance(Phase.TRANSFER)
        req.advance(Phase.DECODE)
        self._n_transit -= 1          # now accounted by its decode slot
        req.t_first_token = self.now + t_x
        req.t_tokens.append(req.t_first_token)
        req.generated.append(0)
        dec.decode_slots.append(
            _DecodeSlot(req, max(req.max_new_tokens - 1, 0),
                        req.prompt_len + 1))
        dec.kv_tokens += req.prompt_len
        self._push(self.now + t_x, "decode_kick", dec.name)
        if src is not None:
            self._try_start_prefill(src)
            self._try_retire(src)
        if self.cfg.mode == "banaserve":
            self._dispatch_pending()
        return True

    def _drain_decode_waiters(self) -> None:
        """Place parked prefill-complete requests as capacity frees.
        FIFO with head-of-line blocking: called from decode completions,
        control ticks, migrations and warm-ups — every event that can
        open a slot — replacing the old 10 ms polling retry."""
        while self._decode_waiters:
            name, req = self._decode_waiters[0]
            if req.outcome is not None:      # aborted while parked
                self._decode_waiters.pop(0)
                self._n_transit -= 1
                src = self.by_name.get(name)
                if src is not None:
                    self._try_start_prefill(src)
                    self._try_retire(src)
                if self.cfg.mode == "banaserve":
                    self._dispatch_pending()
                continue
            if not self._finish_prefill(name, req):
                return
            self._decode_waiters.pop(0)

    def _on_warmed(self, name: str) -> None:
        """An autoscaled instance finished its billed warm-up (weights
        streamed + jit) and starts taking traffic."""
        if name not in self.by_name:
            return
        self._invalidate_fleet_caches()   # the instance is now eligible
        self._record_fleet()
        if self.cfg.mode == "banaserve":
            self._dispatch_pending()
        self._drain_decode_waiters()

    # -- decode preemption (swap / sacrifice, analytical twin) -------------
    def _preempt_for(self, waiting: Request) -> bool:
        """Ask the scheduler for a decode-resident victim whose tenant
        ranks strictly below ``waiting``'s and evict it under the
        configured policy.  Returns True when a slot was freed."""
        running, where = [], {}
        for inst in self._decode_candidates():
            for slot in inst.decode_slots:
                running.append((slot.req, slot.remaining))
                where[slot.req.rid] = (inst, slot)
        victim = self.scheduler.pick_victim(waiting, running)
        if victim is None:
            return False
        inst, slot = where[victim.rid]
        self._preempt_slot(inst, slot, self.scheduler.preemption)
        return True

    def _preempt_slot(self, inst: _Instance, slot, mode: str) -> None:
        """Evict one decode slot: swap bills its context's KV across the
        host boundary (via the store when present), sacrifice just drops
        it — the recompute is billed at resume time."""
        inst.decode_slots.remove(slot)
        inst.kv_tokens -= slot.context
        pages = 0
        if mode == "swap":
            nbytes = int(slot.context * self.model.kv_bytes_per_token())
            self.swap_io_s += (self.store.swap_out(nbytes)
                               if self.store is not None
                               else nbytes / self.cfg.hw.host_bw)
            bs = self.store.block_size if self.store is not None else 64
            pages = -(-slot.context // bs)
        self.metrics.record_preempted(slot.req, mode, pages=pages)
        self._preempted.append((slot.req, slot.remaining, slot.context,
                                mode))

    def _resume_preempted(self) -> None:
        """Bring parked victims back into decode slots — but only when
        spare slots exceed the claims of admitted work still on its way
        to the decode tier, so a fresh preemption isn't undone."""
        if not self._preempted:
            return
        claimed = (len(self.pending) + self._n_transit
                   + sum(len(i.prefill_queue) for i in self.instances))
        while self._preempted:
            cands = [i for i in self._decode_candidates()
                     if len(i.decode_slots) < self.cfg.decode_batch_max]
            free = sum(self.cfg.decode_batch_max - len(i.decode_slots)
                       for i in cands)
            if free - claimed <= 0:
                return
            req, rem, ctx, mode = self._preempted.pop(0)
            if req.outcome is not None:
                continue
            dec = min(cands, key=lambda i: (
                (len(i.decode_slots) + 1) / max(i.decode_cap, 0.05),
                i.kv_tokens))
            if mode == "swap":
                nbytes = int(ctx * self.model.kv_bytes_per_token())
                t_res = (self.store.swap_in(nbytes)
                         if self.store is not None
                         else nbytes / self.cfg.hw.host_bw)
                self.swap_io_s += t_res
            else:            # sacrifice: recompute the whole context
                t_res = A.prefill_time(self.model, ctx, self.cfg.hw,
                                       efficiency=self.cfg.efficiency)
            dec.decode_slots.append(_DecodeSlot(req, rem, ctx))
            dec.kv_tokens += ctx
            self._push(self.now + t_res, "decode_kick", dec.name)

    def preempt(self, rid: int, mode: Optional[str] = None) -> bool:
        """Force-preempt a decode-resident request (ops/test hook);
        ``mode`` defaults to the scheduler's configured policy.  False
        when ``rid`` is not decode-resident."""
        if mode is None and self.scheduler is not None:
            mode = self.scheduler.preemption
        if mode not in ("swap", "sacrifice"):
            raise ValueError(f"unknown preemption mode {mode!r}")
        for inst in self._decode_candidates():
            for slot in list(inst.decode_slots):
                if slot.req.rid == rid:
                    self._preempt_slot(inst, slot, mode)
                    self._resume_preempted()
                    return True
        return False

    def _schedule_decode(self, inst: _Instance):
        if inst.decode_iter_scheduled or not inst.decode_slots:
            return
        start = max(self.now, inst.mig_frozen_until)
        if self.cfg.mode == "colocated":
            # exclusive compute: decode waits for any running prefill and
            # occupies the timeline (the §2.2 interference)
            start = max(start, inst.busy_until)
        inst.spec_pending = self._spec_decide(inst)
        dur = self._decode_iter_time(inst, speculate=inst.spec_pending)
        fill = len(inst.decode_slots) / max(self.cfg.decode_batch_max, 1)
        inst.work_d += dur * max(inst.decode_cap, 0.05) * fill
        if self.cfg.mode == "colocated":
            inst.busy_until = start + dur
        inst.decode_iter_scheduled = True
        self._push(start + dur, "decode_done", inst.name)
        inst.note_busy(start, dur * (1.0 if self.cfg.mode == "colocated"
                                     else 0.4), self.cfg.util_window)

    def _on_decode_done(self, inst: _Instance) -> List[Request]:
        inst.decode_iter_scheduled = False
        self.metrics.decode_iters += 1
        # a speculative iteration commits E[tokens/iter] per slot (whole
        # tokens now, the fraction carries); a plain one commits exactly 1
        e_tok = (A.speculative_tokens_per_iter(max(self.cfg.spec_len, 1),
                                               self.cfg.spec_accept)
                 if inst.spec_pending else 1.0)
        inst.spec_pending = False
        finished = []
        now = self.now
        for slot in inst.decode_slots:
            slot.credit += e_tok
            n = min(int(slot.credit), slot.remaining)
            slot.credit -= n
            for _ in range(n):
                slot.req.generated.append(0)
                t_tokens = slot.req.t_tokens
                last = t_tokens[-1] if t_tokens else now
                t_tokens.append(now if now > last else last)
            slot.remaining -= n
            slot.context += n
            inst.kv_tokens += n
            if slot.remaining <= 0:
                finished.append(slot)
        for slot in finished:
            inst.decode_slots.remove(slot)
            inst.kv_tokens -= slot.context
            slot.req.t_done = self.now
            slot.req.advance(Phase.DONE)
            self._sched_done(slot.req)
            self.metrics.record(slot.req)
        if self.cfg.mode == "colocated":
            self._try_start_prefill(inst)     # prefill priority (vLLM)
        if (self.cfg.mode == "banaserve" and not inst.decode_slots
                and inst.decode_cap >= 0.5 and self._serving(inst)):
            self._steal_decode_work(inst)
        # freed slots serve parked prefill-complete work before resuming
        # preemption victims (admission order — waiters were never evicted)
        self._drain_decode_waiters()
        self._resume_preempted()
        self._schedule_decode(inst)
        if inst.draining:
            self._try_retire(inst)
        return [slot.req for slot in finished]

    def _steal_decode_work(self, inst: _Instance):
        """Event-driven attention-level migration: an idle fast decoder
        pulls KV (requests) from the slowest-per-slot decoder.  Cheap —
        only the migrated heads'/requests' KV moves (Eq. 11)."""
        donors = [i for i in self._decode_candidates()
                  if i is not inst and len(i.decode_slots) >= 2]
        if not donors:
            return
        donor = max(donors,
                    key=lambda i: len(i.decode_slots) / max(i.decode_cap, 0.05))
        # only steal if per-slot service rate actually improves
        if len(donor.decode_slots) / max(donor.decode_cap, 0.05) <=                 len(inst.decode_slots) + 1:
            return
        n_move = len(donor.decode_slots) // 2
        moved_tokens = 0
        for _ in range(n_move):
            if len(inst.decode_slots) >= self.cfg.decode_batch_max:
                break
            slot = donor.decode_slots.pop()
            donor.kv_tokens -= slot.context
            inst.kv_tokens += slot.context
            inst.decode_slots.append(slot)
            moved_tokens += slot.context
        if moved_tokens:
            t_mig = A.attention_migration_time(
                self.model, self.model.n_kv_heads, moved_tokens, self.cfg.hw)
            inst.mig_frozen_until = max(inst.mig_frozen_until,
                                        self.now + t_mig)
            self.migration_log.append((self.now, MigrationAction(
                MigrationKind.KV_HEADS, donor.name, inst.name, n_move,
                0.0, t_mig)))

    def _on_control(self):
        self._control_armed = False
        if self.cfg.mode == "banaserve":
            self._dispatch_pending()
        if self.controller is not None:
            d_p, d_d = self._tier_demands()
            op, od = self._tier_rates
            self._tier_rates = (0.5 * op + 0.5 * d_p, 0.5 * od + 0.5 * d_d)
            for act in self.controller.plan(self._device_loads()):
                self._apply_migration(act)
            self._last_work = {i.name: (i.work_p, i.work_d)
                               for i in self.instances}
            self._last_ctl_t = self.now
        self._drain_decode_waiters()
        for inst in [i for i in self.instances if i.draining]:
            self._try_retire(inst)
        self._autoscale_tick()
        utils = {i.name: i.compute_frac(self.now, self.cfg.util_window)
                 for i in self.instances}
        self.util_trace.append((self.now, utils))
        if self.autoscaler is not None:
            self.metrics.record_util(self.now, utils)
        if self.clock or self._decode_waiters:
            self._arm_control()

    # -- autoscaling hooks (api.BackendBase._autoscale_tick drives these) --
    def _fleet_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for i in self.instances:
            if i.warming_until > self.now:
                k = "warming"
            elif i.draining:
                k = "draining"
            elif i.prefill_cap > 0 and i.decode_cap > 0:
                k = "colocated"
            elif i.prefill_cap > 0:
                k = "prefill"
            elif i.decode_cap > 0:
                k = "decode"
            else:
                k = "idle"
            out[k] = out.get(k, 0) + 1
        return out

    def _autoscale_signals(self) -> FleetSignals:
        now = self.now
        warm = {"prefill": 0, "decode": 0}
        drain = {"prefill": 0, "decode": 0}
        act_p: List[_Instance] = []
        act_d: List[_Instance] = []
        for i in self.instances:
            # partition by DOMINANT role — the same membership rule
            # ``_scale_down`` selects by, so the policy's floor gate
            # (n_active > min) matches what the mechanism can drain
            if i.warming_until > now:
                warm[self._role_of(i)] += 1
            elif i.draining:
                drain[self._role_of(i)] += 1
            elif self._role_of(i) == "prefill":
                act_p.append(i)
            else:
                act_d.append(i)
        # prefill tier: modelled backlog-drain seconds over active capacity
        t_back = sum(A.prefill_time(self.model, r.prompt_len, self.cfg.hw,
                                    efficiency=self.cfg.efficiency)
                     for r in self.pending)
        backlog_p = len(self.pending)
        for i in act_p:
            backlog_p += len(i.prefill_queue)
            t_back += i.queued_prefill_s
        cap_p = sum(i.prefill_cap for i in act_p)
        util_p = 0.0
        if act_p:
            util_p = sum(i.compute_frac(now, self.cfg.util_window)
                         for i in act_p) / len(act_p)
        prefill = TierSignals(
            n_active=len(act_p), n_warming=warm["prefill"],
            n_draining=drain["prefill"], util=util_p,
            queue_delay_s=t_back / max(cap_p, 0.05), backlog=backlog_p)
        # decode tier: slot occupancy is the utilization; the backlog is
        # everything bounced off a full tier (waiters + preempted)
        slots = sum(len(i.decode_slots) for i in act_d)
        cap_slots = len(act_d) * max(self.cfg.decode_batch_max, 1)
        util_d = slots / max(cap_slots, 1)
        backlog_d = len(self._decode_waiters) + len(self._preempted)
        qd_d = 0.0
        if backlog_d and act_d:
            rem = sum(s.remaining for i in act_d for s in i.decode_slots)
            kv = sum(i.kv_tokens for i in act_d)
            mean_ctx = int(kv / max(slots, 1)) or 256
            t_iter = A.decode_time_per_token(
                self.model, mean_ctx, self.cfg.hw,
                batch=max(slots // max(len(act_d), 1), 1))
            # a waiter's slot frees after the mean resident finishes
            qd_d = (rem / max(slots, 1)) * t_iter * backlog_d \
                / max(len(act_d), 1)
        decode = TierSignals(
            n_active=len(act_d), n_warming=warm["decode"],
            n_draining=drain["decode"], util=util_d,
            queue_delay_s=qd_d, backlog=backlog_d)
        return FleetSignals(t=now, prefill=prefill, decode=decode)

    def _scale_up(self, role: str,
                  profile: Optional[A.HardwareProfile] = None
                  ) -> Optional[str]:
        """Order one instance for ``role``.  It bills instance-seconds
        immediately but takes no traffic until its warm-up — weight
        streaming at the part's DMA bandwidth plus jit — elapses on the
        virtual clock (the ``warmed`` event)."""
        hw = profile or self.cfg.hw
        self._scale_seq += 1
        name = f"{role}-s{self._scale_seq}"
        if self.cfg.mode == "colocated":
            caps = (1.0, 1.0)
        else:
            caps = (1.0, 0.0) if role == "prefill" else (0.0, 1.0)
        inst = _Instance(name, caps[0], caps[1], hw)
        jit_s = (self.autoscaler.cfg.jit_compile_s
                 if self.autoscaler is not None else 2.0)
        inst.warming_until = self.now + A.instance_warmup_time(
            self.model, hw, jit_compile_s=jit_s)
        inst._last_util_t = self.now
        self.instances.append(inst)
        self._invalidate_fleet_caches()
        if self.cfg.mode != "colocated":
            (self.prefill_insts if role == "prefill"
             else self.decode_insts).append(inst)
        self.by_name[name] = inst
        self._last_work[name] = (0.0, 0.0)
        self._push(inst.warming_until, "warmed", name)
        return name

    def _scale_down(self, role: str) -> bool:
        """Start draining the least-loaded serving instance of ``role``:
        queued prefill re-routes, decode residents migrate off with their
        KV (billed), and the instance retires once empty."""
        cands = [i for i in self.instances
                 if self._serving(i) and self._role_of(i) == role
                 and (i.prefill_cap if role == "prefill"
                      else i.decode_cap) > 0]
        if len(cands) <= 1:
            return False    # never drain a tier's last instance
        if role == "prefill":
            victim = min(cands, key=lambda i: (
                len(i.prefill_queue) + i.inflight_prefill, i.work_p))
        else:
            victim = min(cands, key=lambda i: (
                len(i.decode_slots), i.kv_tokens))
        victim.draining = True
        self._invalidate_fleet_caches()
        if victim.prefill_queue:
            reqs, victim.prefill_queue = victim.prefill_queue, []
            victim.queued_prefill_s = 0.0
            if self.cfg.mode == "banaserve":
                self.pending = reqs + self.pending
                self._dispatch_pending()
            else:
                for r in reqs:
                    self._on_arrival(r)   # re-route over remaining fleet
        if victim.decode_slots:
            self._offload_decode_slots(victim)
        self._try_retire(victim)
        return True

    def _offload_decode_slots(self, inst: _Instance) -> None:
        """Migrate a draining instance's decode residents (and their KV)
        to open peers — attention-level migration billed on the target's
        ``mig_frozen_until``, token streams untouched."""
        moved: Dict[str, int] = {}
        rank = lambda i: ((len(i.decode_slots) + 1) / max(i.decode_cap, 0.05),
                          i.kv_tokens)
        while inst.decode_slots:
            open_ = [i for i in self._decode_candidates()
                     if i is not inst
                     and len(i.decode_slots) < self.cfg.decode_batch_max]
            if not open_:
                break       # retried at the next decode completion
            tgt = min(open_, key=rank)
            slot = inst.decode_slots.pop()
            inst.kv_tokens -= slot.context
            tgt.kv_tokens += slot.context
            tgt.decode_slots.append(slot)
            slot.req.decode_instance = tgt.name
            moved[tgt.name] = moved.get(tgt.name, 0) + slot.context
        for name, toks in moved.items():
            tgt = self.by_name[name]
            t_mig = A.attention_migration_time(
                self.model, self.model.n_kv_heads, toks, self.cfg.hw)
            tgt.mig_frozen_until = max(tgt.mig_frozen_until,
                                       self.now + t_mig)
            self.migration_log.append((self.now, MigrationAction(
                MigrationKind.KV_HEADS, inst.name, tgt.name, 1, 0.0,
                t_mig)))
            self._schedule_decode(tgt)

    def _try_retire(self, inst: _Instance) -> bool:
        """Remove a drained instance from the fleet once it holds no
        work and no outstanding events reference it."""
        if not inst.draining or inst.name not in self.by_name:
            return False
        if inst.decode_slots:
            self._offload_decode_slots(inst)
        if (inst.prefill_queue or inst.decode_slots
                or inst.inflight_prefill or inst.decode_iter_scheduled
                or inst.busy_until > self.now):
            return False
        for lst in (self.prefill_insts, self.decode_insts):
            if lst is not self.instances and inst in lst:
                lst.remove(inst)
        self.instances.remove(inst)
        self._invalidate_fleet_caches()
        self.by_name.pop(inst.name, None)
        self._last_work.pop(inst.name, None)
        self.retired.append(inst)
        self._record_fleet()
        return True

    # ------------------------------------------------------------------
    def run(self, reqs: Optional[List[Request]] = None
            ) -> Dict[str, object]:
        """Batch drive over the streaming surface: submit every request at
        its workload arrival stamp, drain, summarize.  Without ``reqs``
        the constructor's workload config generates them (legacy mode)."""
        if reqs is None:
            assert self.wcfg is not None, \
                "ClusterSim.run() without requests needs a workload config"
            reqs = generate(self.wcfg)
        for r in sorted(reqs, key=lambda r: r.arrival):
            self.submit(r, at=r.arrival)
        self.drain()
        return self.summary()

    def summary(self) -> Dict[str, object]:
        summary = self.metrics.summary()
        summary["migrations"] = len(self.migration_log)
        summary["mode"] = self.cfg.mode
        summary["speculation"] = self.cfg.speculation
        if self.cfg.speculation != "off":
            summary["spec_iters"] = self.spec_iters
            summary["spec_plain_iters"] = self.plain_iters
        if self.store is not None:
            summary["store_entries"] = len(self.store)
        loads = [i.busy for i in self.instances]
        summary["busy_skew"] = (max(loads) - min(loads)) / max(max(loads), 1e-9)
        # Fig. 2a metric: imbalance *within the prefill tier* (instances that
        # ever served prefill) — the skew prefix-aware routing induces
        pw = [i.work_p for i in self.instances if i.work_p > 0
              or i.prefill_cap > 0]
        if pw:
            summary["prefill_skew"] = (max(pw) - min(pw)) / max(max(pw), 1e-9)
        else:
            summary["prefill_skew"] = 0.0
        if self.scheduler is not None:
            summary["scheduler"] = self.scheduler.cfg.policy
            summary["sched_rejections"] = dict(self.scheduler.rejections)
            summary["swap_io_s"] = self.swap_io_s
        if self.autoscaler is not None:
            summary["autoscale_decisions"] = len(self.autoscaler.decisions)
            summary["n_retired"] = len(self.retired)
        return summary
