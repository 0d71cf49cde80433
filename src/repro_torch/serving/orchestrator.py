"""Live disaggregated orchestrator of the port: an event-driven
virtual-clock loop over real engines (the main-path subset of the JAX
package's ``serving/orchestrator.py``).

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
  state is handed off to the least-loaded decode engine, billed as the
  §4.2 layer-wise overlapped transfer; prefix pages already resident in
  the target's pool are bound by reference instead of copied.
* ``decode_kick`` / ``decode_done`` — a decode engine runs one
  continuous-batching iteration per event.

Not in this slice (ROADMAP A6, A7, A11): the Algorithm 1
migration controller and role re-rolls, layer-span pipelines,
speculation, preemption and fair-share scheduling, autoscaling.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Set

import torch

from .. import device as D
from ..core import analytical as A
from ..core.kvstore import GlobalKVStore, chain_hashes, leading_block_key
from ..core.scheduling import (LoadAwareRouter, PrefixAwareRouter,
                               RequestInfo, RoundRobinRouter,
                               live_instance_loads)
from ..models import kvcache as KC
from ..models.config import ModelConfig
from .api import BackendBase
from .clock import VirtualClock
from .engine import DecodeEngine, EngineConfig, PrefillEngine
from .request import SLO, Metrics, Phase, Request

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
    hw: A.HardwareProfile = A.H100_SXM
    prefill_chunk: int = 4         # max requests per prefill batch
    # chunked prefill: max prompt tokens one row computes per wave (None =
    # one-shot); exactness holds at any value
    chunk_tokens: Optional[int] = None
    slo: Optional[SLO] = None      # TTFT/TPOT targets for goodput accounting
    efficiency: float = 0.5        # prefill MFU for event costs (Eq. 20)
    trace_events: bool = False     # keep the clock's per-event (t, kind) log


class _Member:
    """One fleet slot: a named device playing one role.  Its prefill token
    and fetch counters live here."""

    def __init__(self, name: str, role: str):
        self.name = name
        self.role = role
        self.prefill: Optional[PrefillEngine] = None
        self.decode: Optional[DecodeEngine] = None
        self.tokens_prefilled = 0
        self.fetch_latency_s = 0.0
        self.busy = False              # a prefill wave's event is in flight
        self._wavegen = None           # resumable prefill_waves generator
        self._batch: List[Request] = []
        self._wave_left = 0            # batch requests not yet handed off


class Orchestrator(BackendBase):
    """Owns the fleet; the virtual clock drives route → (chunked) prefill
    → hand-off → decode as independently timed events.  The
    submit/step/abort/drain front door comes from ``api.BackendBase``.

    ``device`` (default the CUDA card) is where every engine runs; the
    parameters must already live there."""

    def __init__(self, cfg: ModelConfig, params,
                 ocfg: OrchestratorConfig = OrchestratorConfig(),
                 device: D.DeviceLike = None):
        if ocfg.n_prefill < 1 or ocfg.n_decode < 1:
            raise ValueError("fleet needs >=1 prefill and >=1 decode "
                             f"instance, got {ocfg.n_prefill}p/"
                             f"{ocfg.n_decode}d")
        self.device = D.resolve(device)
        self.cfg = cfg
        self.params = params
        self.ocfg = ocfg
        self.ecfg = (dataclasses.replace(ocfg.engine, hw=ocfg.hw,
                                         efficiency=ocfg.efficiency)
                     if ocfg.engine.hw is None else ocfg.engine)
        self.store = (GlobalKVStore(block_size=self.ecfg.block_size)
                      if ocfg.global_store else None)
        self.router = _make_router(ocfg.router)
        self.members: List[_Member] = []
        for i in range(ocfg.n_prefill):
            m = _Member(f"prefill{i}", ROLE_PREFILL)
            store = self.store if self.store is not None else \
                GlobalKVStore(block_size=self.ecfg.block_size)
            m.prefill = PrefillEngine(cfg, params, self.ecfg, store,
                                      name=m.name, device=self.device)
            self.members.append(m)
        for i in range(ocfg.n_decode):
            m = _Member(f"decode{i}", ROLE_DECODE)
            m.decode = DecodeEngine(cfg, params, self.ecfg, name=m.name,
                                    device=self.device)
            self.members.append(m)
        self._by_name = {m.name: m for m in self.members}
        self.prefix_sharing = (ocfg.prefix_sharing
                               and self.store is not None
                               and KC.prefix_cacheable(cfg))
        self.pages_bound = 0           # prefix pages bound by reference
        self.bound_bytes_saved = 0.0   # hand-off bytes the binds skipped
        if self.prefix_sharing:
            for m in self.decode_members():
                m.decode.attach_store(self.store)
        self.clock = VirtualClock(trace=ocfg.trace_events)
        self.pending: Deque[Request] = deque()  # submitted, not yet routed
        self.metrics = Metrics(slo=ocfg.slo)
        self.n_handoffs = 0
        self.handoff_serial_s = 0.0
        self.handoff_overlap_s = 0.0
        # decode slots reserved by prefill batches in flight: prefill never
        # produces KV that has nowhere to land
        self._reserved = 0
        self._unit_busy: Set[str] = set()   # decode iteration in flight
        self._init_backend()

    # -- fleet views -----------------------------------------------------
    def prefill_members(self) -> List[_Member]:
        return [m for m in self.members if m.role == ROLE_PREFILL]

    def decode_members(self) -> List[_Member]:
        return [m for m in self.members if m.role == ROLE_DECODE]

    def decode_units(self) -> List[DecodeEngine]:
        return [m.decode for m in self.decode_members()]

    def _unit_by_name(self, name: str) -> Optional[DecodeEngine]:
        m = self._by_name.get(name)
        return m.decode if m is not None else None

    @property
    def fleet(self) -> Dict[str, str]:
        return {m.name: m.role for m in self.members}

    def in_flight(self) -> int:
        return (len(self.pending)
                + sum(len(m.prefill.queue) for m in self.prefill_members())
                + self._reserved
                + sum(u.active for u in self.decode_units()))

    def _free_capacity(self) -> int:
        """Decode slots available for NEW prefill admissions."""
        return sum(u.free_slots for u in self.decode_units()) \
            - self._reserved

    def _target(self) -> DecodeEngine:
        """Hand-off target: the least-loaded engine with a free slot (ties
        broken by name, so the choice is deterministic)."""
        return min((u for u in self.decode_units() if u.free_slots > 0),
                   key=lambda u: (u.active, u.kv_tokens, u.name))

    # -- backend hooks this slice does not provide ----------------------
    def set_scheduler(self, sched) -> None:
        if sched is not None:
            raise NotImplementedError("fair-share scheduling and preemption "
                                      "are not ported yet")
        self.scheduler = None

    def _arm_control(self) -> None:
        """No control loop in this slice (no migration controller and no
        autoscaler)."""

    # -- submission / routing ---------------------------------------------
    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it lives.  A decode-resident request
        frees its slot and pages immediately; a mid-prefill one is dropped
        at its hand-off."""
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
        """Algorithm 2 over the central queue, then kick idle members."""
        release = list(self.pending)
        if release:
            members = self.prefill_members()
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
        self.pending.clear()
        self._kick_prefills()

    def _kick_prefills(self) -> None:
        for m in self.prefill_members():
            if not m.busy and (m._wavegen is not None or m.prefill.queue):
                self.clock.push(self.clock.now, "prefill", m.name)

    def _kick_decode(self, unit: Optional[DecodeEngine]) -> None:
        """Schedule one continuous-batching iteration for ``unit`` if it
        has work and none is in flight; cost = the analytical iteration
        time for the real batch shape (Eq. 22)."""
        if unit is None or unit.name in self._unit_busy or unit.active == 0:
            return
        ctx = unit.kv_tokens // max(unit.active, 1)
        cost = A.decode_iter_time(self.cfg, max(ctx, 1), self.ocfg.hw,
                                  batch=unit.active)
        self._unit_busy.add(unit.name)
        self.clock.push_in(cost, "decode_done", unit.name)

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
            return self._on_decode_done(ev.payload)
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
        cost = A.prefill_time(self.cfg, wave["padded_len"], self.ocfg.hw,
                              batch=wave["rows"],
                              efficiency=self.ocfg.efficiency)
        m.busy = True
        self.clock.push_in(cost, "prefill_done", (name, done))

    def _on_prefill_done(self, name: str, done) -> None:
        m = self._by_name[name]
        m.busy = False
        for req, st, logits in done:
            self._reserved -= 1
            if req.outcome is not None:
                continue       # aborted mid-prefill: its KV is dropped here
            req.advance(Phase.TRANSFER)
            tgt = self._target()
            shared: List[int] = []
            keys: List[bytes] = []
            if self.prefix_sharing:
                keys = chain_hashes(req.prompt, self.ecfg.block_size)
                st, shared = self._bind_shared(st, tgt, keys)
            # the hand-off bills only the pages that actually move
            t_ov = self._account_handoff(req, st)
            slot = tgt.insert(req, st, int(torch.argmax(logits)),
                              shared_pages=shared or None)
            if keys:
                self._register_prefix(req, tgt, slot, keys)
            req.t_first_token = self.clock.now + t_ov
            req.t_tokens.append(req.t_first_token)
            self.clock.push_in(t_ov, "decode_kick", tgt.name)
        if m._wavegen is not None or m.prefill.queue:
            self.clock.push(self.clock.now, "prefill", m.name)

    def _on_decode_done(self, name: str) -> List[Request]:
        self._unit_busy.discard(name)
        unit = self._unit_by_name(name)
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
        if unit.active:
            self._kick_decode(unit)
        if finished:
            self._dispatch()               # freed slots -> admit more
        return finished

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        s = self.metrics.summary()
        s["router"] = self.ocfg.router
        s["global_store"] = self.ocfg.global_store
        s["fleet"] = self.fleet
        s["virtual_time_s"] = self.clock.now
        s["events"] = self.clock.n_processed
        s["chunk_tokens"] = self.ocfg.chunk_tokens
        s["handoffs"] = self.n_handoffs
        s["handoff_serial_s"] = self.handoff_serial_s
        s["handoff_overlap_s"] = self.handoff_overlap_s
        s["store_fetch_s"] = sum(m.fetch_latency_s for m in self.members)
        pw = [m.tokens_prefilled for m in self.prefill_members()]
        s["prefill_token_skew"] = ((max(pw) - min(pw)) / max(max(pw), 1)
                                   if pw else 0.0)
        if self.store is not None:
            s["store_hit_rate"] = self.store.stats.hit_rate
            s["store_entries"] = len(self.store)
            s["prefix_sharing"] = self.prefix_sharing
            s["pages_bound"] = self.pages_bound
            s["bound_bytes_saved"] = self.bound_bytes_saved
            s["cow_forks"] = sum(u.cow_forks for u in self.decode_units())
            s["store_registered_blocks"] = \
                self.store.stats.registered_blocks
            s["store_demotions"] = self.store.stats.demotions
            s["hbm_pages_peak"] = sum(u.pool.peak_used
                                      for u in self.decode_units())
        else:
            stores = [m.prefill.store for m in self.prefill_members()]
            hits = sum(st.stats.hit_blocks for st in stores)
            tot = hits + sum(st.stats.miss_blocks for st in stores)
            s["store_hit_rate"] = hits / tot if tot else 0.0
            s["store_entries"] = sum(len(st) for st in stores)
        return s
