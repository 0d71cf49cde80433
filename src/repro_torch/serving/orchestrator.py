"""Live disaggregated orchestrator of the port: an event-driven
virtual-clock loop over real engines (the JAX package's
``serving/orchestrator.py``).

Tokens are exact (every forward really runs, on the card); time is
virtual — each event's duration is charged from the §4.3 analytical model
(``core/analytical.py``, on the fleet's ``HardwareProfile``, by default
the H100's data sheet) for the real batch shapes the engines ran.

Events:

* ``arrival`` — a request reaches the central queue; Algorithm 2
  (§4.4.2, the load-aware router by default) dispatches the queue over
  live load snapshots onto prefill members.
* ``prefill`` / ``prefill_done`` — an idle prefill member picks up to
  ``prefill_chunk`` requests (admission-controlled by reserved decode
  slots) and runs ONE prefill wave per event; with ``chunk_tokens`` long
  prompts split into successive chunk waves.  A finished request's paged
  state is handed off to the least-loaded decode unit, billed as the
  §4.2 layer-wise overlapped transfer of the state's bytes (half of them
  for int8 KV); prefix pages already resident in a full-stack target's
  pool are bound by reference instead of copied (prefix-cacheable stacks
  only).  Hand-offs into span pipelines copy: the store never registers
  their pools.
* ``decode_kick`` / ``decode_done`` — a decode unit (a full-stack engine,
  or with ``decode_split > 1`` a ``serving/span.py`` pipeline of span
  stages, one fleet member each) runs one continuous-batching iteration
  per event.  With speculation configured, a full-stack unit decides
  speculate-or-plain from the analytical cost per committed token at its
  live batch and the measured acceptance, and bills the chosen cost;
  pipelines decode plain.
* ``control`` — with ``migration`` on or an autoscaler installed, every
  ``control_interval`` virtual seconds the Algorithm 1 controller
  (§4.4.1, ``core/migration.py``) plans over per-member ``DeviceLoad``s
  and ``apply_action`` executes each action: LAYER between adjacent
  stages of one pipeline moves boundary layers live (their weights are
  views; the resident slots' KV is re-split at the new cut); LAYER
  between full-stack members re-rolls a whole instance's role (Fig. 3);
  KV_HEADS moves in-flight slots between decode units (attention-level
  migration).  Hosts and tests
  force actions through ``apply_action`` as well.  The same tick runs
  the SLO autoscaler (``serving/autoscale.py``): ``_scale_up`` spawns an
  engine on the fleet's device over the same parameter tensors, serving
  once its virtual warm-up (``A.instance_warmup_time``) has passed
  (``warmed``); ``_scale_down`` drains a member (decode residents move by
  extract/adopt) and retires it once nothing references it.

With a fair-share scheduler (``Server(scheduler=...)``) the central queue
is released in WFQ order up to the fleet's uncommitted decode capacity;
when it is exhausted a decode resident of a strictly lower-priority
tenant is preempted: *swap* extracts its paged state (kept on the card,
billed both ways at the store's host-tier bandwidth) and re-adopts it
once capacity frees, *sacrifice* drops it and re-prefills a clone of its
prompt plus committed tokens, whose state the original adopts at the
clone's hand-off.  ``preempt`` forces either.  Members may sit on their
own ``HardwareProfile`` (``hw_profiles``, or an autoscaled spawn's part):
each is billed on its own roofline.

Every hand-off, migration and preemption is exact state surgery
(``models/kvcache.py``, ``core/layer_migration.py``), so greedy streams
equal a single-engine rollout.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from .. import device as D
from ..core import analytical as A
from ..core.kvstore import GlobalKVStore, chain_hashes, leading_block_key
from ..core.layer_migration import even_spans
from ..core.migration import (ControllerConfig, DeviceLoad, MigrationAction,
                              MigrationController, MigrationKind)
from ..core.scheduling import (LoadAwareRouter, PrefixAwareRouter,
                               RequestInfo, RoundRobinRouter,
                               live_instance_loads, utilization_gap)
from ..models import kvcache as KC
from ..models.config import ModelConfig
from .api import BackendBase
from .autoscale import FleetSignals, TierSignals
from .clock import VirtualClock
from .engine import DecodeEngine, EngineConfig, PrefillEngine
from .request import SLO, Metrics, Phase, Request
from .span import DecodePipeline

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


def _make_router(name: str):
    if name == "load_aware":
        return LoadAwareRouter()
    if name == "prefix_aware":
        return PrefixAwareRouter()
    if name == "round_robin":
        return RoundRobinRouter()
    raise ValueError(f"unknown router {name!r}")


def _default_controller() -> ControllerConfig:
    """The JAX orchestrator's Algorithm 1 settings, built per config (a
    dataclass instance is no valid field default on Python 3.11+)."""
    return ControllerConfig(delta_up=0.5, delta_down=0.25, rho=0.5,
                            max_actions_per_cycle=2)


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    n_prefill: int = 2
    n_decode: int = 2
    router: str = "load_aware"     # load_aware | prefix_aware | round_robin
    global_store: bool = True      # shared store vs per-instance caches
    # zero-copy prefix sharing: store entries point at live decode-pool
    # pages and hand-offs bind cached prefixes by reference
    prefix_sharing: bool = True
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    # Algorithm 1 (§4.4.1): the migration controller's control loop
    migration: bool = True
    # its cadence in virtual seconds; None derives ~2 decode iterations of
    # the fleet's model on its hardware
    control_interval: Optional[float] = None
    controller: ControllerConfig = dataclasses.field(
        default_factory=_default_controller)
    hw: A.HardwareProfile = A.H100_SXM
    # heterogeneous fleets: per-member profiles cycled over the initial
    # fleet (prefill members first, then decode); None = homogeneous
    # ``hw``.  Each member's event costs, store-fetch overlap and
    # queue-delay reports are billed on its own part.  Span pipelines stay
    # on the fleet default (one pipeline = one part).
    hw_profiles: Optional[tuple] = None
    prefill_chunk: int = 4         # max requests per prefill batch
    # chunked prefill: max prompt tokens one row computes per wave (None =
    # one-shot); exactness holds at any value
    chunk_tokens: Optional[int] = None
    min_prefill: int = 1           # role floors: the serving path must exist
    min_decode: int = 1
    # layer-span partitioning of the decode tier: each of the n_decode
    # decode instances becomes a pipeline of this many span stages (one
    # fleet member each); LAYER actions between adjacent stages move
    # boundary layers instead of re-rolling whole instances
    decode_split: int = 1
    slo: Optional[SLO] = None      # TTFT/TPOT targets for goodput accounting
    efficiency: float = 0.5        # prefill MFU for event costs (Eq. 20)
    trace_events: bool = False     # keep the clock's per-event (t, kind) log


class _Member:
    """One fleet slot: a named device playing one role.  Exactly one of
    ``prefill`` / ``decode`` is live; a re-roll swaps them.  A member may
    be one *stage* of a decode pipeline (``pipe`` / ``stage`` set): it
    then hosts a partial-stack engine, and LAYER moves re-slice its span
    rather than its role.  Token counters live here, so they survive
    re-rolls."""

    def __init__(self, name: str, role: str,
                 hw: Optional[A.HardwareProfile] = None):
        self.name = name
        self.role = role
        self.hw = hw                   # this part's roofline (None = fleet)
        self.warming_until = 0.0       # autoscaled: no traffic before
        self.draining = False          # autoscaled: no new work; retires
        self.prefill: Optional[PrefillEngine] = None
        self.decode: Optional[DecodeEngine] = None
        self.pipe: Optional[DecodePipeline] = None
        self.stage = 0
        self.rerolled = False          # role changed at least once
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self.fetch_latency_s = 0.0
        self.busy = False              # a prefill wave's event is in flight
        self._wavegen = None           # resumable prefill_waves generator
        self._batch: List[Request] = []
        self._wave_left = 0            # batch requests not yet handed off

    @property
    def engine(self):
        return self.prefill if self.role == ROLE_PREFILL else self.decode

    @property
    def unit(self):
        """The decode unit this member serves in: its pipeline when it is
        a span stage, else its own engine."""
        return self.pipe if self.pipe is not None else self.decode

    def load_report(self):
        return self.engine.load_report()


class Orchestrator(BackendBase):
    """Owns the fleet; the virtual clock drives route → (chunked) prefill
    → hand-off → decode → control as independently timed events.  The
    submit/step/abort/drain front door comes from ``api.BackendBase``.

    ``device`` (default the CUDA card) is where every engine runs; the
    parameters must already live there.  ``draft=(cfg, params)`` is the
    draft model handed to every decode engine when
    ``engine.speculation == "draft"``.

    A cross-attention stack (seamless-m4t) needs each request's encoder
    frames at prefill, and the orchestrator, like JAX's, carries none
    (``Request`` has no frames): it raises ``ValueError`` before any
    work.  Such a stack is served through the engines,
    ``PrefillEngine.run(req, frames)`` then ``DecodeEngine.insert``."""

    def __init__(self, cfg: ModelConfig, params,
                 ocfg: OrchestratorConfig = OrchestratorConfig(),
                 device: D.DeviceLike = None, draft=None):
        if cfg.cross_attention:
            raise ValueError(
                f"{cfg.name}: cross attention needs per-request encoder "
                "frames at prefill, and the orchestrator carries none; "
                "serve it through the engines (PrefillEngine.run(req, "
                "frames), then DecodeEngine.insert)")
        if ocfg.n_prefill < 1 or ocfg.n_decode < 1:
            raise ValueError("fleet needs >=1 prefill and >=1 decode "
                             f"instance, got {ocfg.n_prefill}p/"
                             f"{ocfg.n_decode}d")
        if ocfg.decode_split < 1 or ocfg.decode_split > cfg.n_layers:
            raise ValueError(f"decode_split {ocfg.decode_split} must be in "
                             f"[1, {cfg.n_layers}]")
        self.device = D.resolve(device)
        self.cfg = cfg
        self.params = params
        self.ocfg = ocfg
        self.draft = draft
        self.ecfg = (dataclasses.replace(ocfg.engine, hw=ocfg.hw,
                                         efficiency=ocfg.efficiency)
                     if ocfg.engine.hw is None else ocfg.engine)
        self.store = (GlobalKVStore(block_size=self.ecfg.block_size)
                      if ocfg.global_store else None)
        self.router = _make_router(ocfg.router)
        self.members: List[_Member] = []
        self._hw_seq = 0
        for i in range(ocfg.n_prefill):
            m = _Member(f"prefill{i}", ROLE_PREFILL, hw=self._next_hw())
            m.prefill = self._new_prefill(m.name, m.hw)
            self.members.append(m)
        self.decode_pipes: List[DecodePipeline] = []
        for i in range(ocfg.n_decode):
            if ocfg.decode_split == 1:
                m = _Member(f"decode{i}", ROLE_DECODE, hw=self._next_hw())
                m.decode = self._new_decode(m.name, m.hw)
                self.members.append(m)
                continue
            # one pipeline of decode_split span stages, one member each
            bounds = even_spans(cfg.n_layers, ocfg.decode_split)
            stages = []
            for j, span in enumerate(bounds):
                m = _Member(f"decode{i}.{j}", ROLE_DECODE)
                m.decode = DecodeEngine(cfg, params, self.ecfg, name=m.name,
                                        device=self.device, draft=draft,
                                        layer_span=span)
                m.stage = j
                stages.append(m)
                self.members.append(m)
            pipe = DecodePipeline(cfg, params, self.ecfg, bounds,
                                  name=f"decode{i}",
                                  engines=[m.decode for m in stages])
            for m in stages:
                m.pipe = pipe
            self.decode_pipes.append(pipe)
        self._by_name = {m.name: m for m in self.members}
        # zero-copy prefix sharing binds pages of full-stack decode pools
        # the shared store holds; span pipelines take the copy path
        self.prefix_sharing = (ocfg.prefix_sharing
                               and self.store is not None
                               and KC.prefix_cacheable(cfg))
        self.pages_bound = 0           # prefix pages bound by reference
        self.bound_bytes_saved = 0.0   # hand-off bytes the binds skipped
        if self.prefix_sharing:
            for m in self.decode_members():
                if m.pipe is None and m.decode.paged:
                    m.decode.attach_store(self.store)
        self.controller = (MigrationController(ocfg.controller,
                                               self._migration_cost)
                           if ocfg.migration else None)
        self.clock = VirtualClock(trace=ocfg.trace_events)
        self.control_interval = (
            float(ocfg.control_interval) if ocfg.control_interval is not None
            else 2.0 * A.decode_iter_time(cfg, self.ecfg.max_len, ocfg.hw,
                                          batch=max(self.ecfg.max_batch, 1)))
        self._control_armed = False
        self.pending: Deque[Request] = deque()  # submitted, not yet routed
        self.metrics = Metrics(slo=ocfg.slo)
        self.migration_log: List[MigrationAction] = []
        self.util_trace: List[Dict[str, float]] = []
        # (gap before, gap after) per control cycle that applied actions:
        # the utilization gap the controller drives down (Eq. 35)
        self.control_trace: List[tuple] = []
        self.span_move_log: List[Dict] = []
        self.n_handoffs = 0
        self.handoff_serial_s = 0.0
        self.handoff_overlap_s = 0.0
        # decode slots reserved by prefill batches in flight: prefill never
        # produces KV that has nowhere to land
        self._reserved = 0
        self._unit_busy: Set[str] = set()   # decode iteration in flight
        # stale-event fencing: a re-roll bumps its member's epoch so decode
        # completions scheduled for the old engine are dropped
        self._epoch: Dict[str, int] = {}
        # speculation routing: iterations billed at the speculative cost vs
        # sent back to plain decode
        self.spec_iters = 0
        self.plain_iters = 0
        # swap-preempted decode residents, parked with their state on the
        # card: rid -> (request, paged state, pending token).  Resumed
        # (adopt) once capacity frees and no admitted work still waits
        # for a slot.
        self._swapped: Dict[int, tuple] = {}
        # sacrifice re-prefill clones: clone rid -> (clone, original)
        self._resume_of: Dict[int, tuple] = {}
        self._clone_rid = -1           # clones use negative rids
        self.swap_io_s = 0.0           # modelled host-tier swap traffic
        self.retired: List[_Member] = []    # drained-down members
        self._scale_seq = 0                 # autoscaled-member naming
        self._init_backend()

    # -- fleet views -----------------------------------------------------
    def _next_hw(self) -> A.HardwareProfile:
        hw = (self.ocfg.hw_profiles[self._hw_seq % len(self.ocfg.hw_profiles)]
              if self.ocfg.hw_profiles else self.ocfg.hw)
        self._hw_seq += 1
        return hw

    def _member_hw(self, m: Optional[_Member]) -> A.HardwareProfile:
        return m.hw if m is not None and m.hw is not None else self.ocfg.hw

    def _ecfg_for(self, hw: Optional[A.HardwareProfile]) -> EngineConfig:
        """The fleet engine config rebased onto one member's part, so the
        engine's store-fetch overlap and queue-delay reports price its own
        roofline."""
        if hw is None or hw is self.ecfg.hw:
            return self.ecfg
        return dataclasses.replace(self.ecfg, hw=hw)

    def _new_prefill(self, name: str,
                     hw: Optional[A.HardwareProfile] = None) -> PrefillEngine:
        store = self.store if self.store is not None else \
            GlobalKVStore(block_size=self.ecfg.block_size)
        return PrefillEngine(self.cfg, self.params, self._ecfg_for(hw), store,
                             name=name, device=self.device)

    def _new_decode(self, name: str,
                    hw: Optional[A.HardwareProfile] = None) -> DecodeEngine:
        """A full-stack decode engine on the fleet's device over the same
        parameter tensors (no copy); it captures its own CUDA graphs at
        its first decode step."""
        return DecodeEngine(self.cfg, self.params, self._ecfg_for(hw),
                            name=name, device=self.device, draft=self.draft)

    def _serving_member(self, m: _Member) -> bool:
        """Eligible for new work: warmed up and not draining."""
        return m.warming_until <= self.clock.now and not m.draining

    def prefill_members(self) -> List[_Member]:
        return [m for m in self.members if m.role == ROLE_PREFILL]

    def decode_members(self) -> List[_Member]:
        return [m for m in self.members if m.role == ROLE_DECODE]

    def decode_units(self) -> List:
        """Schedulable decode targets: a pipeline counts once (its stages
        share one slot layout), a full-stack engine as itself."""
        units, seen = [], set()
        for m in self.decode_members():
            u = m.unit
            if id(u) not in seen:
                seen.add(id(u))
                units.append(u)
        return units

    def _unit_member(self, unit) -> _Member:
        """The member that owns a unit's counters (a pipeline's lead
        stage, or the engine's own member)."""
        name = unit.lead.name if isinstance(unit, DecodePipeline) \
            else unit.name
        return self._by_name[name]

    def _placeable_units(self) -> List:
        """Decode units that may take new residents: their member is warmed
        up and not draining.  Warming and draining units still run the
        iterations for whatever they already hold."""
        return [u for u in self.decode_units()
                if self._serving_member(self._unit_member(u))]

    def _unit_by_name(self, name: str):
        for u in self.decode_units():
            if u.name == name:
                return u
        return None

    @property
    def fleet(self) -> Dict[str, str]:
        out = {}
        for m in self.members:
            role = m.role
            if m.warming_until > self.clock.now:
                role += ":warming"
            elif m.draining:
                role += ":draining"
            out[m.name] = role
        return out

    def in_flight(self) -> int:
        return (len(self.pending)
                + sum(len(m.prefill.queue) for m in self.prefill_members())
                + self._reserved
                + sum(u.active for u in self.decode_units())
                + len(self._swapped))

    def _free_capacity(self) -> int:
        """Decode slots available for NEW prefill admissions."""
        return sum(u.free_slots for u in self._placeable_units()) \
            - self._reserved

    def _target(self):
        """Hand-off target: the least-loaded placeable unit with a free
        slot (ties broken by name, so the choice is deterministic)."""
        return min((u for u in self._placeable_units() if u.free_slots > 0),
                   key=lambda u: (u.active, u.kv_tokens, u.name))

    def _arm_control(self) -> None:
        if (self.controller is not None or self.autoscaler is not None) \
                and not self._control_armed:
            self.clock.push_in(self.control_interval, "control")
            self._control_armed = True

    # -- submission / routing ---------------------------------------------
    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it lives.  A decode-resident request
        frees its slot and pages immediately, a swap-parked one drops its
        parked state; a mid-prefill one (or a sacrificed one whose clone
        is mid-prefill) is dropped at its hand-off."""
        req = self._by_rid.get(rid)
        if req is None or req.outcome is not None or req.phase == Phase.DONE:
            return False
        if req in self.pending:
            self.pending.remove(req)
            return self._finish_abort(req)
        for m in self.prefill_members():
            if req in m.prefill.queue:
                m.prefill.queue.remove(req)
                return self._finish_abort(req)
        for u in self.decode_units():
            for slot, s in enumerate(u.slots):
                if s is req:
                    u.release_slot(slot)
                    ok = self._finish_abort(req)
                    self._dispatch()          # freed capacity admits more
                    return ok
        if rid in self._swapped:                      # swap-parked
            self._swapped.pop(rid)
            return self._finish_abort(req)
        # a sacrificed original waiting on its re-prefill clone: pull the
        # clone from any queue it still sits in (a mid-prefill clone stays
        # mapped; the hand-off handler drops its recomputed state instead)
        for crid, (clone, orig) in list(self._resume_of.items()):
            if orig.rid != rid:
                continue
            if clone in self.pending:
                self.pending.remove(clone)
                del self._resume_of[crid]
            else:
                for m in self.prefill_members():
                    if clone in m.prefill.queue:
                        m.prefill.queue.remove(clone)
                        del self._resume_of[crid]
                        break
            break
        return self._finish_abort(req)

    def _prefix_key(self, req: Request) -> Optional[bytes]:
        return leading_block_key(req.prompt, self.ecfg.block_size)

    def _account_handoff(self, req: Request, st: Dict) -> float:
        """Cost the hand-off's per-layer transfer schedule with and without
        §4.2 layer-wise overlap (Eq. 4/11); the overlap partner is the
        destination's per-layer decode compute.  Returns the overlapped
        seconds the first token pays."""
        sched = KC.layer_transfer_schedule(st)
        if not sched:
            return 0.0
        t_layer = A.decode_time_per_token(
            self.cfg, req.prompt_len, self.ocfg.hw) / max(len(sched), 1)
        nbytes = [b for _, b in sched]
        self.n_handoffs += 1
        self.handoff_serial_s += A.serial_schedule_time(
            nbytes, self.ocfg.hw.net_bw, t_layer, t_sync=0.0)
        t_ov = A.overlapped_schedule_time(nbytes, self.ocfg.hw.net_bw,
                                          t_layer, t_sync=0.0)
        self.handoff_overlap_s += t_ov
        return t_ov

    def _sharing_target(self, tgt) -> bool:
        """Does ``tgt`` bind store pages by reference?  Only full-stack
        paged engines whose pool the shared store holds (span pipelines
        and dense rows take the copy path)."""
        return (self.prefix_sharing and isinstance(tgt, DecodeEngine)
                and tgt.paged and tgt._store is self.store)

    def _bind_shared(self, st: Dict, tgt: DecodeEngine,
                     keys: List[bytes]) -> tuple:
        """Zero-copy bind: drop from the wire state the prefix pages
        ``tgt``'s pool already holds and return them for by-reference
        binding.  Returns (possibly head-split state, pages)."""
        if not keys:
            return st, []
        pages = self.store.resident_prefix(keys, tgt.name)
        n = min(len(pages), int(st["n_blocks"]))
        if n <= 0:
            return st, []
        full = KC.state_num_bytes(st)
        st = KC.split_paged_state(st, n, self.ecfg.block_size)
        self.pages_bound += n
        self.bound_bytes_saved += full - KC.state_num_bytes(st)
        return st, pages[:n]

    def _register_prefix(self, req: Request, tgt: DecodeEngine, slot: int,
                         keys: List[bytes]) -> None:
        """Re-point the store's entries for the prompt's full blocks at the
        pages now resident in ``tgt``'s pool."""
        n_full = req.prompt_len // self.ecfg.block_size
        if n_full <= 0:
            return
        row = tgt.slot_pages(slot)
        self.store.register_pages(keys[:n_full], tgt.name, row[:n_full])

    def _dispatch(self) -> None:
        """Algorithm 2 over the central queue (with a fair-share scheduler,
        over the WFQ-ordered slice capacity can serve) onto serving
        prefill members, then kick idle members."""
        members = [m for m in self.prefill_members()
                   if self._serving_member(m)]
        if not members:
            return                   # whole tier warming/draining: wait
        release = (self._sched_release() if self.scheduler is not None
                   else list(self.pending))
        if release:
            loads = live_instance_loads([m.prefill for m in members])
            budget = max(self.ecfg.max_batch * self.ecfg.max_len, 1)
            infos = [RequestInfo(
                r.rid, r.prompt_len,
                est_load=min(r.prompt_len / budget, 1.0),
                prefix_key=self._prefix_key(r),
                est_time_s=A.prefill_time(self.cfg, r.prompt_len,
                                          self.ocfg.hw,
                                          efficiency=self.ocfg.efficiency))
                for r in release]
            plan = self.router.dispatch(infos, loads)
            for req in release:
                self._by_name[plan[req.rid]].prefill.enqueue(req)
        if self.scheduler is None:
            self.pending.clear()
        self._kick_prefills()

    def _sched_release(self) -> List[Request]:
        """The fair-share gate between the central queue and the router:
        release at most the fleet's uncommitted decode capacity, in WFQ
        order (the FIFO policy releases everything).  When capacity is
        exhausted and preemption is configured, evict a victim for the
        best-ranked waiter."""
        if not self.pending:
            return []
        queued = sum(len(m.prefill.queue) for m in self.prefill_members())
        budget = self._free_capacity() - queued
        if self.scheduler.preemption is not None:
            while budget < 1 and self.pending:
                head = self.scheduler.peek(list(self.pending),
                                           self.clock.now)
                if not self._preempt_for(head):
                    break
                budget = self._free_capacity() - queued
        chosen = self.scheduler.select(list(self.pending), self.clock.now,
                                       budget=max(budget, 0))
        for r in chosen:
            self.pending.remove(r)
        return chosen

    def _kick_prefills(self) -> None:
        self._resume_swapped()
        for m in self.prefill_members():
            if m.warming_until > self.clock.now:
                continue       # wakes via its "warmed" event
            if not m.busy and (m._wavegen is not None or m.prefill.queue):
                self.clock.push(self.clock.now, "prefill", m.name)

    # -- decode preemption (swap / sacrifice) ------------------------------
    def _preempt_for(self, waiting: Request) -> bool:
        """Ask the scheduler for a decode-resident victim whose tenant
        ranks strictly below ``waiting``'s, then apply the configured
        eviction policy.  Returns True when a slot was freed."""
        running, where = [], {}
        for u in self.decode_units():
            for slot, r in enumerate(u.slots):
                if r is None:
                    continue
                running.append((r, r.max_new_tokens - len(r.generated)))
                where[r.rid] = (u, slot)
        victim = self.scheduler.pick_victim(waiting, running)
        if victim is None:
            return False
        u, slot = where[victim.rid]
        if self.scheduler.preemption == "swap":
            self._swap_out(u, slot)
        else:
            self._sacrifice(u, slot)
        return True

    def _swap_out(self, unit, slot: int) -> None:
        """Swap a decode resident out: its pages free at once, its gathered
        state parks (on the card, where ``extract_slot`` leaves it), and
        the store bills its host tier's bandwidth (here and at resume)."""
        req, st, tok = unit.extract_slot(slot)
        nbytes = KC.state_num_bytes(st)
        self.swap_io_s += (self.store.swap_out(nbytes)
                           if self.store is not None
                           else nbytes / self.ocfg.hw.host_bw)
        self._swapped[req.rid] = (req, st, tok)
        pages = int(st["n_blocks"]) if "n_blocks" in st else 0
        self.metrics.record_preempted(req, "swap", pages=pages)

    def _sacrifice(self, unit, slot: int) -> None:
        """Drop a decode resident's KV and recompute it later: a clone
        request (prompt = the original prompt plus every committed token
        but the last) rides the normal chunked-prefill path, and the
        original adopts the recomputed state at the clone's hand-off."""
        victim = unit.release_slot(slot)
        clone = Request(
            rid=self._clone_rid, arrival=self.clock.now,
            prompt=np.concatenate([
                victim.prompt,
                np.asarray(victim.generated[:-1],
                           dtype=victim.prompt.dtype)]),
            max_new_tokens=max(
                victim.max_new_tokens - len(victim.generated), 1),
            tenant=victim.tenant)
        self._clone_rid -= 1
        self._resume_of[clone.rid] = (clone, victim)
        self.metrics.record_preempted(victim, "sacrifice")
        self.pending.append(clone)

    def _finish_resume(self, clone: Request, st: Dict) -> None:
        """A sacrifice clone's recompute finished: the original adopts the
        rebuilt state and continues from its last committed token, so its
        stream equals an uninterrupted run's."""
        _, orig = self._resume_of.pop(clone.rid)
        if orig.outcome is not None:
            return                     # aborted while recomputing
        tgt = self._target()
        t_ov = self._account_handoff(orig, st)
        tgt.adopt(orig, st, int(orig.generated[-1]))
        self.clock.push_in(t_ov, "decode_kick", tgt.name)

    def _resume_swapped(self) -> None:
        """Bring swap-parked victims back, but only when spare capacity
        exceeds the claims of admitted work still waiting for a slot, so a
        fresh preemption is not undone at once."""
        if not self._swapped:
            return
        claimed = len(self.pending) + sum(
            len(m.prefill.queue) for m in self.prefill_members())
        while self._swapped and self._free_capacity() - claimed > 0:
            rid = next(iter(self._swapped))
            req, st, tok = self._swapped.pop(rid)
            if req.outcome is not None:
                continue
            nbytes = KC.state_num_bytes(st)
            t_in = (self.store.swap_in(nbytes) if self.store is not None
                    else nbytes / self.ocfg.hw.host_bw)
            self.swap_io_s += t_in
            tgt = self._target()
            tgt.adopt(req, st, tok)
            self.clock.push_in(t_in, "decode_kick", tgt.name)

    def preempt(self, rid: int, mode: Optional[str] = None) -> bool:
        """Force-preempt a decode-resident request: ``swap`` parks its
        state, ``sacrifice`` drops it for re-prefill.  ``mode`` defaults
        to the scheduler's policy.  False when ``rid`` is not
        decode-resident."""
        if mode is None and self.scheduler is not None:
            mode = self.scheduler.preemption
        if mode not in ("swap", "sacrifice"):
            raise ValueError(f"unknown preemption mode {mode!r}")
        for u in self.decode_units():
            for slot, r in enumerate(u.slots):
                if r is not None and r.rid == rid:
                    if mode == "swap":
                        self._swap_out(u, slot)
                    else:
                        self._sacrifice(u, slot)
                    self._dispatch()
                    return True
        return False

    def _spec_capable(self, unit) -> bool:
        """Can this unit run the speculative verify step at all?  Only
        full-stack engines with speculation configured."""
        return isinstance(unit, DecodeEngine) and unit._spec_ok

    def _accept_estimate(self, unit: DecodeEngine) -> float:
        """The unit's measured acceptance rate, optimistic (0.8) until it
        has evidence."""
        if unit.spec_proposed > 0:
            return unit.spec_accepted / unit.spec_proposed
        return 0.8

    def _kick_decode(self, unit) -> None:
        """Schedule one continuous-batching iteration for ``unit`` if it
        has work and none is in flight; cost = the analytical iteration
        time for the real batch shape (Eq. 22).

        When the unit can speculate, the cost per committed token of a
        speculative iteration (verification compute ~(k+1)x, bytes barely
        move, plus the draft's steps) is compared with a plain step at the
        unit's live batch and context; the unit's ``spec_on`` switch makes
        the next ``step()`` obey, and the chosen cost is billed."""
        if unit is None or unit.name in self._unit_busy or unit.active == 0:
            return
        hw = self._member_hw(self._unit_member(unit))
        ctx = unit.kv_tokens // max(unit.active, 1)
        cost = A.decode_iter_time(self.cfg, max(ctx, 1), hw,
                                  batch=unit.active)
        if self._spec_capable(unit):
            k = max(self.ecfg.spec_len, 1)
            spec_cost = A.speculative_decode_iter_time(
                self.cfg, max(ctx, 1), hw, batch=unit.active, k=k,
                draft_cfg=self.draft[0] if self.draft else None)
            e_tok = A.speculative_tokens_per_iter(
                k, self._accept_estimate(unit))
            speculate = spec_cost / e_tok < cost
            unit.spec_on = speculate
            if speculate:
                cost = spec_cost
                self.spec_iters += 1
            else:
                self.plain_iters += 1
        self._unit_busy.add(unit.name)
        self.clock.push_in(cost, "decode_done",
                           (unit.name, self._epoch.get(unit.name, 0)))

    # -- event handlers ---------------------------------------------------
    def _handle(self, ev) -> List[Request]:
        if ev.kind == "arrival":
            if self._admit(ev.payload):
                self.pending.append(ev.payload)
                self._dispatch()
        elif ev.kind == "prefill":
            self._on_prefill(ev.payload)
        elif ev.kind == "prefill_done":
            self._on_prefill_done(*ev.payload)
        elif ev.kind == "decode_kick":
            self._kick_decode(self._unit_by_name(ev.payload))
        elif ev.kind == "decode_done":
            return self._on_decode_done(*ev.payload)
        elif ev.kind == "control":
            self._on_control()
        elif ev.kind == "warmed":
            self._on_warmed(ev.payload)
        else:
            raise ValueError(f"unknown event kind {ev.kind!r}")
        return []

    def _on_prefill(self, name: str) -> None:
        """One prefill wave: pick up a batch if idle, run the next forward
        (one chunk per row at most), charge its analytical cost."""
        m = self._by_name.get(name)
        if m is None or m.role != ROLE_PREFILL or m.busy:
            return
        if m._wavegen is None:
            if m.draining:
                # a draining member finishes its in-flight wave but never
                # starts another; it retires once idle
                self._try_retire_member(m)
                return
            n = min(self.ocfg.prefill_chunk, len(m.prefill.queue),
                    self._free_capacity())
            if n <= 0:
                return
            batch = [m.prefill.queue.popleft() for _ in range(n)]
            for r in batch:
                r.t_prefill_start = r.t_prefill_start or self.clock.now
            self._reserved += n
            m._wave_left = n
            m._batch = batch
            m._wavegen = m.prefill.prefill_waves(
                batch, chunk_tokens=self.ocfg.chunk_tokens)
        before = (m.prefill.tokens_prefilled, m.prefill.fetch_latency_s)
        wave = next(m._wavegen, None)
        m.tokens_prefilled += m.prefill.tokens_prefilled - before[0]
        m.fetch_latency_s += m.prefill.fetch_latency_s - before[1]
        if wave is None:
            m._wavegen = None
            m._batch = []
            return
        done = [(m._batch[i], st, lg) for i, st, lg in wave["done"]]
        m._wave_left -= len(done)
        if m._wave_left <= 0:
            m._wavegen = None
            m._batch = []
        cost = A.prefill_time(self.cfg, wave["padded_len"],
                              self._member_hw(m), batch=wave["rows"],
                              efficiency=self.ocfg.efficiency)
        m.busy = True
        self.clock.push_in(cost, "prefill_done", (name, done))

    def _on_prefill_done(self, name: str, done) -> None:
        m = self._by_name.get(name)
        if m is not None:
            m.busy = False
        for req, st, logits in done:
            self._reserved -= 1
            if req.rid in self._resume_of:
                self._finish_resume(req, st)   # a sacrifice clone landed
                continue
            if req.outcome is not None:
                continue       # aborted mid-prefill: its KV is dropped here
            req.advance(Phase.TRANSFER)
            tgt = self._target()
            shared: List[int] = []
            keys: List[bytes] = []
            if self._sharing_target(tgt):
                keys = chain_hashes(req.prompt, self.ecfg.block_size)
                st, shared = self._bind_shared(st, tgt, keys)
            # the hand-off bills only the pages that actually move
            t_ov = self._account_handoff(req, st)
            first = int(torch.argmax(logits))
            slot = (tgt.insert(req, st, first, shared_pages=shared)
                    if shared else tgt.insert(req, st, first))
            if keys:
                self._register_prefix(req, tgt, slot, keys)
            req.t_first_token = self.clock.now + t_ov
            req.t_tokens.append(req.t_first_token)
            self.clock.push_in(t_ov, "decode_kick", tgt.name)
        if m is not None and m.role == ROLE_PREFILL and \
                (m._wavegen is not None or m.prefill.queue):
            self.clock.push(self.clock.now, "prefill", m.name)
        if m is not None and m.draining:
            self._try_retire_member(m)

    def _on_decode_done(self, name: str, epoch: int) -> List[Request]:
        self._unit_busy.discard(name)
        if epoch != self._epoch.get(name, 0):
            return []                      # unit re-rolled mid-iteration
        unit = self._unit_by_name(name)
        if unit is None:
            return []
        m = self._unit_member(unit)
        before_tok = unit.tokens_decoded
        snapshot = [(r, len(r.generated))
                    for r in unit.slots if r is not None]
        finished = [req for req, _slot in unit.step()]
        now = self.clock.now
        self.metrics.decode_iters += 1
        for req, n0 in snapshot:
            # one stamp per committed token, monotonic per request (a
            # hand-off's transfer latency may overlap this iteration)
            for _ in range(len(req.generated) - n0):
                last = req.t_tokens[-1] if req.t_tokens else now
                req.t_tokens.append(max(now, last))
        for req in finished:
            req.t_done = req.t_tokens[-1] if req.t_tokens else now
            self._sched_done(req)
            self.metrics.record(req)
        m.tokens_decoded += unit.tokens_decoded - before_tok
        if unit.active:
            self._kick_decode(unit)
        if finished:
            self._dispatch()               # freed slots -> admit more
        return finished

    def _on_control(self) -> None:
        self._control_armed = False
        if self.controller is not None:
            self._control()
        self._autoscale_tick()
        for m in [m for m in self.members if m.draining]:
            self._try_retire_member(m)
        if self.autoscaler is not None:
            self.metrics.record_util(self.clock.now, {
                d.device: d.utilization for d in self._device_loads()})
        if self.in_flight() > 0 or self.clock:
            self._arm_control()

    # -- autoscaling hooks (api.BackendBase._autoscale_tick drives them) --
    def set_autoscaler(self, policy) -> None:
        if policy is not None and self.ocfg.decode_split != 1:
            raise ValueError("autoscaling requires decode_split == 1 "
                             "(span pipelines scale by re-slicing, not "
                             "by spawn/retire)")
        super().set_autoscaler(policy)

    def _on_warmed(self, name: str) -> None:
        """A spawned member finished its billed warm-up and starts taking
        traffic."""
        if name not in self._by_name:
            return
        self._record_fleet()
        self._dispatch()

    def _fleet_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for m in self.members:
            if m.warming_until > self.clock.now:
                k = "warming"
            elif m.draining:
                k = "draining"
            else:
                k = m.role
            out[k] = out.get(k, 0) + 1
        return out

    def _autoscale_signals(self) -> FleetSignals:
        now = self.clock.now
        warm = {ROLE_PREFILL: 0, ROLE_DECODE: 0}
        drain = {ROLE_PREFILL: 0, ROLE_DECODE: 0}
        act_p: List[_Member] = []
        act_d: List[_Member] = []
        for m in self.members:
            if m.warming_until > now:
                warm[m.role] += 1
            elif m.draining:
                drain[m.role] += 1
            elif m.role == ROLE_PREFILL:
                act_p.append(m)
            elif m.pipe is None or m.stage == 0:
                act_d.append(m)        # pipelines count once (lead stage)
        backlog_p = len(self.pending) + sum(
            len(m.prefill.queue) for m in act_p)
        qd_p = util_p = 0.0
        if act_p:
            reps = [m.load_report() for m in act_p]
            qd_p = sum(r.queue_delay_s for r in reps) / len(act_p)
            util_p = sum(min(r.compute_frac, 1.0)
                         for r in reps) / len(act_p)
        qd_p += sum(A.prefill_time(self.cfg, r.prompt_len, self.ocfg.hw,
                                   efficiency=self.ocfg.efficiency)
                    for r in self.pending) / max(len(act_p), 1)
        prefill = TierSignals(
            n_active=len(act_p), n_warming=warm[ROLE_PREFILL],
            n_draining=drain[ROLE_PREFILL], util=util_p,
            queue_delay_s=qd_p, backlog=backlog_p)
        units = [m.unit for m in act_d]
        active = sum(u.active for u in units)
        total = sum(u.active + u.free_slots for u in units)
        backlog_d = len(self._swapped)
        qd_d = 0.0
        if backlog_d and active:
            ctx = sum(u.kv_tokens for u in units) / active
            t_iter = A.decode_iter_time(
                self.cfg, max(int(ctx), 1), self.ocfg.hw,
                batch=max(active // max(len(units), 1), 1))
            rem = sum(r.max_new_tokens - len(r.generated)
                      for u in units for r in u.slots if r is not None)
            qd_d = (rem / max(active, 1)) * t_iter * backlog_d \
                / max(len(units), 1)
        decode = TierSignals(
            n_active=len(act_d), n_warming=warm[ROLE_DECODE],
            n_draining=drain[ROLE_DECODE],
            util=active / max(total, 1),
            queue_delay_s=qd_d, backlog=backlog_d)
        return FleetSignals(t=now, prefill=prefill, decode=decode)

    def _scale_up(self, role: str, profile=None) -> Optional[str]:
        """Spawn a live engine for ``role`` on the fleet's device, over the
        same parameter tensors.  The member exists (and costs
        instance-seconds) at once, but takes no traffic until its warm-up
        (the weights at the part's host bandwidth plus the compile
        constant) has passed on the virtual clock."""
        if role == ROLE_DECODE and self.ocfg.decode_split != 1:
            return None
        hw = profile or self.ocfg.hw
        self._scale_seq += 1
        name = f"{role}-s{self._scale_seq}"
        m = _Member(name, role, hw=hw)
        if role == ROLE_PREFILL:
            m.prefill = self._new_prefill(name, hw)
        else:
            m.decode = self._new_decode(name, hw)
            if self.prefix_sharing and m.decode.paged:
                m.decode.attach_store(self.store)
        jit_s = (self.autoscaler.cfg.jit_compile_s
                 if self.autoscaler is not None else 2.0)
        m.warming_until = self.clock.now + A.instance_warmup_time(
            self.cfg, hw, jit_compile_s=jit_s)
        self.members.append(m)
        self._by_name[name] = m
        self.clock.push(m.warming_until, "warmed", name)
        return name

    def _scale_down(self, role: str) -> bool:
        """Start draining the least-loaded serving member of ``role``.
        Prefill: queued requests re-route centrally, the in-flight wave
        finishes, then the member retires.  Decode: residents move to
        peers by extract/adopt (streams unchanged), then it retires."""
        if role == ROLE_PREFILL:
            cands = [m for m in self.prefill_members()
                     if self._serving_member(m)]
            if len(cands) <= max(self.ocfg.min_prefill, 1):
                return False
            victim = min(cands, key=lambda m: (
                len(m.prefill.queue), m.tokens_prefilled))
            victim.draining = True
            if victim.prefill.queue:
                self.pending.extendleft(reversed(victim.prefill.queue))
                victim.prefill.queue.clear()
                self._dispatch()
            self._try_retire_member(victim)
            return True
        cands = [m for m in self.decode_members()
                 if self._serving_member(m) and m.pipe is None]
        if len(cands) <= max(self.ocfg.min_decode, 1):
            return False
        victim = min(cands, key=lambda m: (m.decode.active,
                                           m.decode.kv_tokens))
        victim.draining = True
        spare = sum(u.free_slots for u in self._placeable_units()) \
            - self._reserved
        if victim.decode.active > spare:
            victim.draining = False
            return False        # residents would not fit on the peers
        self._epoch[victim.name] = self._epoch.get(victim.name, 0) + 1
        self._unit_busy.discard(victim.name)
        for req, st, tok in victim.decode.drain():
            tgt = self._target()
            t_ov = self._account_handoff(req, st)
            tgt.adopt(req, st, tok)
            self.clock.push_in(t_ov, "decode_kick", tgt.name)
        if self.store is not None:
            self.store.detach_pool(victim.name)
        self._try_retire_member(victim)
        return True

    def _try_retire_member(self, m: _Member) -> bool:
        """Remove a drained member once nothing references it."""
        if not m.draining or m.name not in self._by_name:
            return False
        if m.role == ROLE_PREFILL:
            if m.busy or m._wavegen is not None or m.prefill.queue:
                return False
        elif m.decode is not None and (m.decode.active > 0
                                       or m.name in self._unit_busy):
            return False
        self.members.remove(m)
        del self._by_name[m.name]
        self.retired.append(m)
        self._record_fleet()
        return True

    # -- public drive ------------------------------------------------------
    def run(self, reqs: Sequence[Request],
            max_events: int = 1_000_000) -> dict:
        """Batch drive over the streaming surface: each request is
        submitted at its workload arrival stamp (the virtual arrival
        time), then the loop drains, event for event what
        ``api.Server.run`` does.  Raises ``RuntimeError`` naming any
        request left without an outcome; returns ``summary()``."""
        for r in sorted(reqs, key=lambda r: r.arrival):
            self.submit(r, at=r.arrival)
        self.drain(max_events=max_events)
        lost = [r.rid for r in reqs if r.outcome is None]
        if lost:
            raise RuntimeError(f"orchestrator lost requests {lost}")
        return self.summary()

    # -- Algorithm 1: control cycle --------------------------------------
    def _device_loads(self) -> List[DeviceLoad]:
        out = []
        for m in self.members:
            if not self._serving_member(m):
                continue   # the migration controller leaves them alone
            r = m.load_report()
            out.append(DeviceLoad(
                device=m.name, compute_frac=r.compute_frac,
                memory_frac=r.memory_frac, supports_layer=True,
                supports_attention=(m.role == ROLE_DECODE)))
        return out

    def _control(self) -> List[MigrationAction]:
        loads = self._device_loads()
        utils = {d.device: d.utilization for d in loads}
        self.util_trace.append(utils)
        acts = self.controller.plan(loads)
        applied = [a for a in acts if self.apply_action(a)]
        if applied:
            after = {d.device: d.utilization for d in self._device_loads()}
            self.control_trace.append((utilization_gap(utils),
                                       utilization_gap(after)))
        return applied

    def _span_pair(self, src: _Member, dst: _Member
                   ) -> Optional[DecodePipeline]:
        """The pipeline owning src/dst iff they are adjacent stages of the
        same one (the only topology a live span move serves)."""
        if (src.pipe is not None and src.pipe is dst.pipe
                and abs(src.stage - dst.stage) == 1):
            return src.pipe
        return None

    def _can_reroll(self, member: _Member, new_role: str) -> bool:
        if member.pipe is not None:
            return False       # pipeline stages re-slice spans, not roles
        if member.role == new_role:
            return False
        if not self._serving_member(member):
            return False       # the autoscaler owns warming/draining members
        if member.role == ROLE_PREFILL:
            if len(self.prefill_members()) <= self.ocfg.min_prefill:
                return False
            if member.busy or member._wavegen is not None:
                return False   # a prefill batch is mid-flight on it
        else:
            if len(self.decode_units()) <= self.ocfg.min_decode:
                return False
            # resident KV must fit on the remaining decode units, net of
            # slots reserved by in-flight prefill batches
            spare = sum(u.free_slots for u in self._placeable_units()
                        if u is not member.unit) - self._reserved
            if member.decode.active > spare:
                return False
        return True

    def _migration_cost(self, kind: MigrationKind, d_o: DeviceLoad,
                        d_u: DeviceLoad, amount: int):
        """Benefit/cost hook for the controller, over live fleet state.
        Benefit is the utilization-gap reduction a feasible action buys;
        cost is the Eq. 4/11 analytical transfer time on ``ocfg.hw``."""
        src = self._by_name[d_o.device]
        dst = self._by_name[d_u.device]
        gap = d_o.utilization - d_u.utilization
        if kind == MigrationKind.LAYER:
            pipe = self._span_pair(src, dst)
            if pipe is not None:
                # a span move: only the boundary layers' weights and
                # resident KV, layer-wise overlapped (Eq. 4/11)
                a, b = src.decode.layer_span
                n = min(amount, (b - a) - 1)
                t_layer = A.decode_time_per_token(
                    self.cfg, self.ecfg.max_len, self.ocfg.hw) \
                    / max(self.cfg.n_layers, 1)
                cost = max(A.span_migration_time(
                    self.cfg, max(n, 1), kv_tokens=src.decode.kv_tokens,
                    hw=self.ocfg.hw, t_layer_compute=t_layer), 1e-6)
                if n <= 0:
                    return 0.0, cost
                # moving n layers closes ~n/span of the stage gap
                return gap * n / max(b - a, 1), cost
            kv = dst.decode.kv_tokens if dst.role == ROLE_DECODE else 0
            cost = max(A.layer_migration_time(self.cfg, self.cfg.n_layers,
                                              kv_tokens=kv, hw=self.ocfg.hw),
                       1e-6)
            # span stages never trade roles with anything outside their
            # pipeline: pricing such a pair as a re-roll would plan
            # actions apply_action must refuse
            if src.pipe is not None or not self._can_reroll(dst, src.role):
                return 0.0, cost
            return gap / 2.0, cost
        # KV_HEADS: rebalance in-flight decode KV between two decode units
        su = src.unit if src.role == ROLE_DECODE else None
        du = dst.unit if dst.role == ROLE_DECODE else None
        cost = max(A.attention_migration_time(
            self.cfg, amount,
            kv_tokens=su.kv_tokens if su is not None else 0,
            hw=self.ocfg.hw), 1e-6)
        if (su is None or du is None or su is du
                or su.active <= du.active + 1 or du.free_slots <= 0):
            return 0.0, cost
        return gap / 4.0, cost

    # -- action execution -------------------------------------------------
    def apply_action(self, act: MigrationAction) -> bool:
        """Execute one controller action against the live fleet.  Public so
        hosts and tests can force a migration.  Returns True if applied.

        LAYER between adjacent stages of one decode pipeline = a live span
        move of ``act.amount`` boundary layers; LAYER between full-stack
        members = a whole-instance role re-roll of ``act.dst`` into
        ``act.src``'s role; KV_HEADS = a slot rebalance between decode
        units."""
        src = self._by_name.get(act.src)
        dst = self._by_name.get(act.dst)
        if src is None or dst is None:
            return False
        if act.kind == MigrationKind.LAYER:
            pipe = self._span_pair(src, dst)
            if pipe is not None:
                res = pipe.move_span(src.stage, dst.stage, act.amount)
                ok = res is not None
                if ok:
                    self.span_move_log.append(res)
            elif src.pipe is None and dst.pipe is None:
                ok = self._reroll(dst, src.role)
            else:
                ok = False     # span stages never trade roles with others
        else:
            ok = self._rebalance_decode(src, dst)
        if ok:
            self.migration_log.append(act)
            # re-plumb the event flow around the new topology: requeued
            # requests re-route, adopters and the new capacity get kicked
            self._dispatch()
            for u in self.decode_units():
                self._kick_decode(u)
        return ok

    def _reroll(self, member: _Member, new_role: str) -> bool:
        """Fig. 3 executable: repurpose ``member`` into ``new_role``."""
        if not self._can_reroll(member, new_role):
            return False
        self._epoch[member.name] = self._epoch.get(member.name, 0) + 1
        self._unit_busy.discard(member.name)
        if new_role == ROLE_DECODE:
            # prefill -> decode: queued (unstarted) requests go back to the
            # front of the central queue; Algorithm 2 re-routes them
            self.pending.extendleft(reversed(member.prefill.queue))
            member.prefill.queue.clear()
            member.prefill = None
            member.decode = self._new_decode(member.name)
            if self.prefix_sharing and member.decode.paged:
                member.decode.attach_store(self.store)
        else:
            # decode -> prefill: evacuate resident KV to decode peers first
            for req, st, tok in member.decode.drain():
                tgt = min((u for u in self._placeable_units()
                           if u is not member.unit and u.free_slots > 0),
                          key=lambda u: (u.active, u.name))
                tgt.adopt(req, st, tok)
            if self.store is not None:
                # the pool's pages die with the engine: demote the store's
                # page-resident entries to the backing tiers first
                self.store.detach_pool(member.name)
            member.decode = None
            member.prefill = self._new_prefill(member.name)
        member.role = new_role
        member.rerolled = True
        return True

    def _rebalance_decode(self, src: _Member, dst: _Member) -> bool:
        """Attention-level migration: move half the slot excess src→dst.
        Units speak the full-stack wire format, so slots move freely
        between pipelines (even with different cuts) and full-stack
        engines."""
        if src.role != ROLE_DECODE or dst.role != ROLE_DECODE:
            return False
        su, du = src.unit, dst.unit
        if su is du:
            return False
        n = min((su.active - du.active) // 2, du.free_slots)
        if n <= 0:
            return False
        moved = 0
        for slot, s in enumerate(su.slots):
            if moved >= n:
                break
            if s is None:
                continue
            req, st, tok = su.extract_slot(slot)
            du.adopt(req, st, tok)
            moved += 1
        return moved > 0

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        s = self.metrics.summary()
        s["router"] = self.ocfg.router
        s["global_store"] = self.ocfg.global_store
        s["migrations"] = len(self.migration_log)
        s["fleet"] = self.fleet
        s["virtual_time_s"] = self.clock.now
        s["events"] = self.clock.n_processed
        s["chunk_tokens"] = self.ocfg.chunk_tokens
        s["span_moves"] = len(self.span_move_log)
        s["span_bytes_moved"] = sum(r["weight_bytes"] + r["kv_bytes"]
                                    for r in self.span_move_log)
        if self.decode_pipes:
            s["span_bounds"] = {p.name: [tuple(b) for b in p.bounds]
                                for p in self.decode_pipes}
        if self.control_trace:
            s["util_gap_before"] = float(
                sum(g for g, _ in self.control_trace)
                / len(self.control_trace))
            s["util_gap_after"] = float(
                sum(g for _, g in self.control_trace)
                / len(self.control_trace))
        s["speculation"] = self.ecfg.speculation
        if self.ecfg.speculation != "off":
            s["spec_iters"] = self.spec_iters
            s["spec_plain_iters"] = self.plain_iters
        s["handoffs"] = self.n_handoffs
        s["handoff_serial_s"] = self.handoff_serial_s
        s["handoff_overlap_s"] = self.handoff_overlap_s
        if self.autoscaler is not None:
            s["autoscale_decisions"] = len(self.autoscaler.decisions)
            s["n_retired"] = len(self.retired)
        if self.scheduler is not None:
            s["scheduler"] = self.scheduler.cfg.policy
            s["sched_rejections"] = dict(self.scheduler.rejections)
            s["swap_io_s"] = self.swap_io_s
        s["store_fetch_s"] = sum(m.fetch_latency_s for m in self.members)
        # routing imbalance: members that held the prefill role throughout
        pw = [m.tokens_prefilled for m in self.prefill_members()
              if not m.rerolled]
        s["prefill_token_skew"] = ((max(pw) - min(pw)) / max(max(pw), 1)
                                   if pw else 0.0)
        engines = [e for u in self.decode_units()
                   for e in getattr(u, "engines", [u])]
        if self.store is not None:
            s["store_hit_rate"] = self.store.stats.hit_rate
            s["store_entries"] = len(self.store)
            s["prefix_sharing"] = self.prefix_sharing
            s["pages_bound"] = self.pages_bound
            s["bound_bytes_saved"] = self.bound_bytes_saved
            s["cow_forks"] = sum(e.cow_forks for e in engines)
            s["store_registered_blocks"] = \
                self.store.stats.registered_blocks
            s["store_demotions"] = self.store.stats.demotions
            s["hbm_pages_peak"] = sum(e.pool.peak_used for e in engines
                                      if e.paged)
        else:
            # per-instance caches; an int8-KV stack's engines hold none
            stores = [m.prefill.store for m in self.prefill_members()
                      if m.prefill.store is not None]
            hits = sum(st.stats.hit_blocks for st in stores)
            tot = hits + sum(st.stats.miss_blocks for st in stores)
            s["store_hit_rate"] = hits / tot if tot else 0.0
            s["store_entries"] = sum(len(st) for st in stores)
        return s
