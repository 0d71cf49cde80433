"""Span-partitioned serving: pipelined partial-stack engines (§4.1).

A *span pipeline* hosts one logical serving instance across several
partial-stack stages: stage *k* owns a contiguous layer span (views of the
span's weights and that span's paged KV pool), and the batch's residual
stream flows stage to stage each forward, so outputs are those of a
full-stack engine.  This is the execution substrate of the paper's
layer-level migration (Eq. 5, Fig. 3): moving the boundary between two
adjacent stages re-slices their weight views and moves only the boundary
layers' per-slot KV pages; the cost scales with the moved span, never the
stack.

* ``PrefillPipeline`` — chained prefill.  The lead stage runs the bucketed
  wave loop (``serving/engine.py``) and hands each wave's residual stream
  down the chain; per-span states merge back into the full-stack wire
  format, so a span-partitioned prefill hands off to any decode unit.
* ``DecodePipeline`` — chained continuous-batching decode.  All stages keep
  one slot layout (the lead owns request lifecycles, the followers mirror
  its commits), inserts split the wire state per span, extracts merge it
  back, and ``move_span`` executes a live ``MigrationKind.LAYER`` action
  between adjacent stages.

The port of the JAX package's ``serving/span.py``.  States cross stage
boundaries in JAX's canonical form: a leaf is paged iff its cache length
equals the full stack's page space.  A stage whose own page space is
smaller (a span of ring layers only) pages internally at its window and
de-pages on exit (``_canon_state``); a span of recurrent layers only
serves on dense rows, as does every stage of an xLSTM stack; cross
caches ride slot-dense with their layers.  An int8-KV stack is served as
JAX serves it: its stages hold int8 pools, and a prompt longer than
``chunk_tokens`` raises ``ValueError`` (no resume).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import device as D
from ..core import layer_migration as LM
from ..models import kvcache as KC
from ..models.config import ModelConfig
from .engine import (DecodeEngine, EngineConfig, PrefillEngine,
                     check_servable)
from .request import Phase, Request


def _check_bounds(bounds: Sequence[Tuple[int, int]], n_layers: int) -> None:
    if not (bounds and bounds[0][0] == 0 and bounds[-1][1] == n_layers):
        raise ValueError(f"bounds {bounds} must partition [0, {n_layers})")
    for (_, b0), (a1, _) in zip(bounds, bounds[1:]):
        if b0 != a1:
            raise ValueError(f"bounds not contiguous: {bounds}")
    if not all(b > a for a, b in bounds):
        raise ValueError(f"empty span in {bounds}")


def _adjacent(src: int, dst: int) -> None:
    if abs(src - dst) != 1:
        raise ValueError("span moves are between adjacent stages")


class PrefillPipeline:
    """A prefill instance partitioned into chained layer-span stages.

    Presents ``PrefillEngine``'s prefill calls (prefill_waves / run_batch
    / run); the lead stage buckets and drives the chain wave by wave."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 bounds: Sequence[Tuple[int, int]], name: str = "pp0",
                 device: D.DeviceLike = None):
        _check_bounds(bounds, cfg.n_layers)
        self.cfg = cfg
        self.ecfg = ecfg
        self.name = name
        self.engines = [
            PrefillEngine(cfg, params, ecfg, None, name=f"{name}.{k}",
                          device=device, layer_span=span)
            for k, span in enumerate(bounds)]
        self.engines[0]._followers = self.engines[1:]

    @property
    def bounds(self) -> List[Tuple[int, int]]:
        return [e.layer_span for e in self.engines]

    @property
    def lead(self) -> PrefillEngine:
        return self.engines[0]

    @property
    def queue(self):
        return self.lead.queue

    def enqueue(self, req: Request) -> None:
        self.lead.enqueue(req)
        req.prefill_instance = self.name

    def load_report(self):
        return self.lead.load_report()

    def prefill_waves(self, reqs, frames=None, chunk_tokens=None):
        """Wave generator over the chained stages (``PrefillEngine``'s):
        each wave's residual stream (and ``frames``, a cross-attention
        stack's encoder output) flows through every span in turn."""
        return self.lead.prefill_waves(reqs, frames=frames,
                                       chunk_tokens=chunk_tokens)

    def run_batch(self, reqs, frames=None, chunk_tokens=None):
        return self.lead.run_batch(reqs, frames=frames,
                                   chunk_tokens=chunk_tokens)

    def run(self, req: Request, frames=None):
        return self.lead.run(req, frames=frames)

    def run_queued(self, max_reqs: int, frames=None, chunk_tokens=None):
        return self.lead.run_queued(max_reqs, frames=frames,
                                    chunk_tokens=chunk_tokens)

    def move_span(self, src: int, dst: int, n: int) -> Optional[int]:
        """Shift ``n`` boundary layers from stage ``src`` to the adjacent
        stage ``dst``.  Prefill stages hold no resident serving state, so
        only the weight views re-slice.  Returns the moved layer count, or
        None when the move would empty ``src``."""
        _adjacent(src, dst)
        ei, ej = self.engines[src], self.engines[dst]
        a, b = ei.layer_span
        n = min(n, (b - a) - 1)
        if n <= 0:
            return None
        if dst == src + 1:           # tail of src -> head of dst
            ei.rebase_span((a, b - n))
            ej.rebase_span((b - n, ej.layer_span[1]))
        else:                        # head of src -> tail of dst
            ei.rebase_span((a + n, b))
            ej.rebase_span((ej.layer_span[0], a + n))
        return n


class DecodePipeline:
    """A decode instance partitioned into chained layer-span stages.

    All stages share one slot layout: the lead stage owns request
    lifecycles and token streams; followers mirror its commits.  The
    pipeline speaks the full-stack wire format at its edges (insert /
    adopt / extract_slot / drain), so pipelines, full-stack engines and
    pipelines with other boundaries interoperate."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 bounds: Sequence[Tuple[int, int]], name: str = "dp0",
                 engines: Optional[Sequence[DecodeEngine]] = None,
                 device: D.DeviceLike = None):
        _check_bounds(bounds, cfg.n_layers)
        self.cfg = cfg
        self.ecfg = ecfg
        self.name = name
        if engines is None:
            engines = [DecodeEngine(cfg, params, ecfg, name=f"{name}.{k}",
                                    device=device, layer_span=span)
                       for k, span in enumerate(bounds)]
        self.engines: List[DecodeEngine] = list(engines)
        if [tuple(e.layer_span) for e in self.engines] != \
                [tuple(b) for b in bounds]:
            raise ValueError("engines do not host the given bounds")
        # the wire contract: leaves are paged iff their cache length equals
        # the full stack's page space (None: wire states are dense)
        self._wire_plen = check_servable(cfg, ecfg)

    # -- lead-delegated views --------------------------------------------
    @property
    def bounds(self) -> List[Tuple[int, int]]:
        return [e.layer_span for e in self.engines]

    @property
    def lead(self) -> DecodeEngine:
        return self.engines[0]

    @property
    def slots(self) -> List[Optional[Request]]:
        return self.lead.slots

    @property
    def active(self) -> int:
        return self.lead.active

    @property
    def free_slots(self) -> int:
        return self.lead.free_slots

    @property
    def kv_tokens(self) -> int:
        return self.lead.kv_tokens

    @property
    def tokens_decoded(self) -> int:
        return self.lead.tokens_decoded

    def free_slot(self) -> Optional[int]:
        return self.lead.free_slot()

    # -- wire-format edges -----------------------------------------------
    def _canon_state(self, e: DecodeEngine, st: Dict[str, Any]
                     ) -> Dict[str, Any]:
        """De-page a stage's state when its own page space differs from
        the wire's (a ring-only span pages internally at its window)."""
        if "n_blocks" in st and e.page_len != self._wire_plen:
            st = KC.paged_state_to_dense(st, self.ecfg.block_size,
                                         e.page_len)
        return st

    def adopt(self, req: Request, state: Dict[str, Any],
              next_token: int, slot: Optional[int] = None,
              shared_pages: Optional[Sequence[Tuple[int, ...]]] = None
              ) -> int:
        """Migration receive path: split the wire state at this pipeline's
        boundaries and land each part on its stage, in the same slot on
        every stage.

        ``shared_pages`` is the pipeline form of the zero-copy bind: one
        tuple of physical pages per shared block, one page per stage (the
        layout ``slot_pages`` reports), bound by reference on every stage;
        each stage forks (COW) at its own divergence point, so a fork on
        one stage never touches the others.  ``state`` must already be
        head-split past the shared blocks, and every stage must be paged
        at the wire's page length.  The orchestrator's store never
        registers pipeline pools (a span move re-creates their pages), so
        its hand-offs into a pipeline copy; this path serves sharing
        between pipeline slots directly, and a live ``move_span`` gathers
        the shared content and re-adopts it unshared."""
        if slot is None:
            slot = self.lead.free_slot()
        if slot is None:
            raise RuntimeError("decode pipeline full")
        shared = list(shared_pages or ())
        if shared and not all(e.paged and e.page_len == self._wire_plen
                              for e in self.engines):
            raise ValueError("shared-page binds need every stage paged at "
                             "the wire's page length")
        parts = LM.split_state_spans(self.cfg, state, self.bounds)
        for k, (e, part) in enumerate(zip(self.engines, parts)):
            sp = [t[k] for t in shared] if shared else None
            e.adopt(req, part, next_token, slot=slot, shared_pages=sp)
        req.decode_instance = self.name
        return slot

    def insert(self, req: Request, state: Dict[str, Any],
               first_token: int,
               shared_pages: Optional[Sequence[Tuple[int, ...]]] = None
               ) -> int:
        """KV transfer: place a prefilled request into a decode slot."""
        slot = self.adopt(req, state, int(first_token),
                          shared_pages=shared_pages)
        req.generated.append(int(first_token))
        req.advance(Phase.DECODE)
        return slot

    def slot_pages(self, slot: int) -> List[Tuple[int, ...]]:
        """The pages backing ``slot``, per block: element ``j`` holds
        block ``j``'s physical page on every stage, the layout ``adopt``'s
        ``shared_pages`` takes."""
        return list(zip(*(e.slot_pages(slot) for e in self.engines)))

    def extract_slot(self, slot: int
                     ) -> Tuple[Request, Dict[str, Any], int]:
        """Pull a slot off every stage and merge the parts back into the
        wire format (migration send path)."""
        parts, req, tok = [], None, 0
        for e in self.engines:
            req, st, tok = e.extract_slot(slot)
            parts.append(self._canon_state(e, st))
        return req, LM.merge_state_spans(self.cfg, parts, self.bounds), tok

    def drain(self) -> List[Tuple[Request, Dict[str, Any], int]]:
        return [self.extract_slot(i) for i, s in enumerate(self.lead.slots)
                if s is not None]

    def release_slot(self, slot: int) -> Request:
        """Abort path: free the slot (and its pages) on every stage
        without gathering any state."""
        req = self.lead.slots[slot]
        for e in self.engines:
            e.release_slot(slot)
        return req

    # -- pipelined decode -------------------------------------------------
    def step(self) -> List[Tuple[Request, int]]:
        """One decode iteration: the token column enters stage 0, the
        residual stream chains through every span (each stage replays its
        own compiled step, copying the upstream stream into its static
        input), logits leave the last stage; the lead commits and the
        followers mirror it."""
        if self.active == 0:
            return []
        for e in self.engines:
            e._prepare_pages()
        x = torch.from_numpy(self.lead.next_token[:, None])
        last = len(self.engines) - 1
        for k, e in enumerate(self.engines):
            x = e._forward_step(x, hidden_in=k > 0, hidden_out=k < last)
        nxt = torch.argmax(x, dim=-1).cpu().numpy()
        finished = self.lead.commit(nxt)
        done_slots = {s for _, s in finished}
        for e in self.engines[1:]:
            e.follow_commit(nxt, done_slots)
        return finished

    # -- layer-span migration ---------------------------------------------
    def move_span(self, src: int, dst: int, n: int
                  ) -> Optional[Dict[str, Any]]:
        """Live §4.1 span move: shift ``n`` boundary layers (weights and
        the active slots' per-layer KV) from stage ``src`` to the adjacent
        stage ``dst`` without perturbing any token stream.

        Returns ``{"layers": moved, "weight_bytes": …, "kv_bytes": …,
        "schedule": [(abs_layer, nbytes), …]}`` — the ordered per-layer
        payload ``analytical.overlapped_schedule_time`` bills (Eq. 4/11) —
        or None when the move would empty ``src``.  The weight bytes are
        counted from shapes: the stages' weights are views, so nothing is
        copied on one card."""
        _adjacent(src, dst)
        ei, ej = self.engines[src], self.engines[dst]
        a, b = ei.layer_span
        n = min(n, (b - a) - 1)
        if n <= 0:
            return None
        forward = dst == src + 1
        moved = (b - n, b) if forward else (a, a + n)
        union = (min(a, ej.layer_span[0]), max(b, ej.layer_span[1]))
        lo, hi = (ei, ej) if forward else (ej, ei)
        old_pair = [lo.layer_span, hi.layer_span]
        if forward:
            new_pair = [(a, b - n), (b - n, ej.layer_span[1])]
        else:
            new_pair = [(ej.layer_span[0], a + n), (a + n, b)]

        # every active slot's state across BOTH stages (the other stages
        # keep theirs untouched), merged over the union span
        snap: List[Tuple[int, Request, int, Dict[str, Any]]] = []
        for s in range(self.ecfg.max_batch):
            if ei.slots[s] is None:
                continue
            parts, req, tok = [], None, 0
            for e in (lo, hi):
                req, st, tok = e.extract_slot(s)
                parts.append(self._canon_state(e, st))
            snap.append((s, req, tok,
                         LM.merge_state_spans(self.cfg, parts, old_pair)))

        # the migrated payload: the moved layers' weights plus their share
        # of every resident slot's state, as the per-layer schedule
        layers = LM.unstack_layers(self.cfg, self.lead.params)
        per_layer = {l: LM.layer_param_bytes(layers[l][1])
                     for l in range(*moved)}
        w_bytes = sum(per_layer.values())
        kv_bytes = 0
        for _, _, _, merged in snap:
            mv = LM.split_state_spans(self.cfg, merged, [moved],
                                      base=union)[0]
            for l, nbytes in KC.layer_transfer_schedule(
                    mv, base_layer=moved[0]):
                per_layer[l] += nbytes
                kv_bytes += nbytes
        schedule = sorted(per_layer.items())

        lo.rebase_span(new_pair[0])
        hi.rebase_span(new_pair[1])
        for s, req, tok, merged in snap:
            new_parts = LM.split_state_spans(self.cfg, merged, new_pair,
                                             base=union)
            lo.adopt(req, new_parts[0], tok, slot=s)
            hi.adopt(req, new_parts[1], tok, slot=s)
        return {"layers": n, "weight_bytes": int(w_bytes),
                "kv_bytes": int(kv_bytes), "schedule": schedule}
