"""Live serving engines of the port, on the paged KV runtime.

``PrefillEngine`` — batched prefill with Global-KV-Store integration:
longest-prefix match, page fetch and paged incremental prefill of the
suffix only, and publication of freshly produced full blocks back into the
store.  Requests are bucketed by (padded suffix length, prefix hit) and
one bucket runs per wave; suffixes and row counts pad to power-of-two
buckets.  Fresh waves run over a dense wave cache (kernel B2); hit waves
(store hits and chunk resumes) run over a paged wave cache whose prefix
pages kernel B3 reads in place.  Every state leaves a wave in the paged
wire format (``models.kvcache``).

``DecodeEngine`` — slot-based continuous batching over a refcounted paged
block pool: per-slot block tables, page-fused decode (kernel B1),
hand-off by page copies (``insert``/``adopt``), copy-on-write forks of
shared pages, and zero-copy binds of store-resident prefix pages.

Both mirror the JAX package's ``serving/engine.py`` (full-stack engines,
``speculation="off"``) and report ``core.scheduling.LoadReport``s for the
routers.  This slice serves pageable, prefix-cacheable attention stacks
only; other stacks raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as D
from ..core import analytical as A
from ..core.kvstore import GlobalKVStore, chain_hashes
from ..core.scheduling import LoadReport
from ..models import kvcache as KC
from ..models import transformer as T
from ..models.config import ModelConfig
from .request import Phase, Request


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_len: int = 512
    max_batch: int = 8
    block_size: int = 16          # must match the store's block size
    # page-fused decode through kernel B1 (None/True); False forces the
    # gather-then-attend plain path, kept as the A/B reference
    decode_kernel: Optional[bool] = None
    # when set, store fetches are billed as the §4.2 layer-wise overlapped
    # transmission against this hardware's per-layer prefill compute
    hw: Optional[A.HardwareProfile] = None
    efficiency: float = 0.5       # prefill MFU for the analytical billings
    # speculative decoding comes with a later slice; only "off" runs here
    speculation: str = "off"


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def serving_page_len(cfg: ModelConfig, max_len: int) -> Optional[int]:
    """The page space: the longest attention cache at this cache size."""
    lens = [T._cache_len(cfg, kind, max_len) for kind in set(cfg.blocks())]
    return max(lens) if lens else None


def check_servable(cfg: ModelConfig, ecfg: EngineConfig) -> int:
    """The page length of a stack this slice serves; raises
    ``NotImplementedError`` otherwise (no dense fallback)."""
    T.check_supported(cfg)
    if ecfg.speculation != "off":
        raise NotImplementedError("speculative decoding is not ported yet "
                                  "(ROADMAP A7)")
    plen = serving_page_len(cfg, ecfg.max_len)
    if not KC.prefix_cacheable(cfg) or plen is None \
            or plen % ecfg.block_size:
        raise NotImplementedError(
            f"{cfg.name}: the port serves pageable global-attention stacks "
            f"(cache length a multiple of block_size {ecfg.block_size}); "
            "windowed and other stacks come with a later slice (ROADMAP A10)")
    return plen


def engine_device(params, device: D.DeviceLike) -> torch.device:
    """The engine's device (default the CUDA card); the parameters must
    already live there — nothing is moved behind the caller's back."""
    dev = D.resolve(device)
    have = params["embed"].device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"parameters live on {have}, engine device is "
                         f"{dev}")
    return have


class PrefillEngine:
    """One prefill instance (full stack)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 store: Optional[GlobalKVStore] = None,
                 name: str = "prefill0", device: D.DeviceLike = None):
        self._page_len = check_servable(cfg, ecfg)
        self.device = engine_device(params, device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.dtype = params["embed"].dtype
        self.store = store
        self.name = name
        self.queue: Deque[Request] = deque()   # routed, not yet prefilled
        self.tokens_prefilled = 0         # suffix tokens actually computed
        self.n_prefilled = 0
        # leading-block hash -> cached tokens (prefix-aware routing signal)
        self._leading: Dict[bytes, int] = {}
        # padded writes must never wrap the cache (linear: the page space)
        self._pad_cap = self._page_len
        self._t_layer_fetch = (
            A.prefill_time(cfg, ecfg.block_size, ecfg.hw)
            / max(cfg.n_layers, 1) if ecfg.hw is not None else None)
        self.fetch_latency_s = 0.0

    # -- queue / load ----------------------------------------------------
    def enqueue(self, req: Request) -> None:
        req.advance(Phase.ROUTED)
        req.prefill_instance = self.name
        self.queue.append(req)

    def load_report(self) -> LoadReport:
        """Queued prompt tokens against one engine's worth of work; with a
        hardware profile, the analytical time to drain the queue."""
        budget = max(self.ecfg.max_batch * self.ecfg.max_len, 1)
        queued = sum(r.prompt_len for r in self.queue)
        delay = (sum(A.prefill_time(self.cfg, r.prompt_len, self.ecfg.hw,
                                    efficiency=self.ecfg.efficiency)
                     for r in self.queue)
                 if self.ecfg.hw is not None else 0.0)
        return LoadReport(compute_frac=min(queued / budget, 1.0),
                          memory_frac=0.0, queue_len=len(self.queue),
                          queue_delay_s=delay,
                          cached_prefix_tokens=dict(self._leading),
                          layer_span=(0, self.cfg.n_layers))

    # -- store -------------------------------------------------------------
    def _match(self, tokens: np.ndarray,
               keys: List[bytes]) -> Tuple[int, List[Any]]:
        """Longest block-aligned cached prefix + its fetched payloads."""
        if self.store is None or len(tokens) < 2:
            return 0, []
        matched, hit_keys = self.store.match(tokens, keys=keys)
        matched = min(matched, len(tokens) - 1)  # always prefill >= 1 token
        matched -= matched % self.ecfg.block_size
        if matched <= 0:
            return 0, []
        hit_keys = hit_keys[: matched // self.ecfg.block_size]
        payloads, t_fetch = self.store.fetch(
            hit_keys, t_layer_compute=self._t_layer_fetch)
        self.fetch_latency_s += t_fetch
        return matched, payloads

    def _match_len(self, tokens: np.ndarray, keys: List[bytes]) -> int:
        """Tentative match length for batch planning: no stats, no fetch."""
        if self.store is None or len(tokens) < 2:
            return 0
        matched, _ = self.store.match(tokens, record_stats=False, keys=keys)
        matched = min(matched, len(tokens) - 1)
        return max(matched - matched % self.ecfg.block_size, 0)

    def _publish(self, tokens: np.ndarray, st: Dict[str, Any],
                 matched: int, keys: List[bytes]) -> None:
        """Insert freshly computed full blocks (pages of the paged state)
        into the global store."""
        bs = self.ecfg.block_size
        if not keys:
            return
        n_full = len(keys) * bs
        self._leading[keys[0]] = max(self._leading.get(keys[0], 0), n_full)
        if self.store is None:
            return
        payloads = [KC.paged_state_block(st, j, bs)
                    for j in range(matched // bs, n_full // bs)]
        if payloads:
            nbytes = KC.state_num_bytes(payloads[0])
            self.store.insert(tokens[:n_full],
                              [None] * (matched // bs) + payloads, nbytes,
                              keys=keys)

    def _bucket_len(self, slen: int, matched: int) -> int:
        """Pad a suffix length to its power-of-two bucket, capped at the
        row's remaining cache capacity."""
        padded = min(_pow2_ceil(slen), self._pad_cap - matched)
        return padded if padded >= slen else slen

    # -- prefill -----------------------------------------------------------
    def prefill_waves(self, reqs: List[Request],
                      chunk_tokens: Optional[int] = None):
        """Generator form of the prefill wave loop: one forward per
        ``next()``.  Same wave semantics as the JAX engine: bucket by
        (padded suffix length, prefix hit), defer duplicate uncached
        prefixes, cap at ``max_batch`` rows, pad rows to a power of two;
        with ``chunk_tokens`` a row computes at most that many prompt
        tokens per wave and resumes through the paged incremental path.

        Yields ``{"rows", "padded_len", "tokens", "done": [(index into
        reqs, paged request state, last-token logits)]}``."""
        chunk = max(int(chunk_tokens), 1) if chunk_tokens else None
        for req in reqs:
            req.advance(Phase.PREFILL)
        bs = self.ecfg.block_size
        nb_slot = self._page_len // bs
        toks = [np.asarray(r.prompt, np.int32) for r in reqs]
        keys_of = [chain_hashes(t, bs) if self.store is not None else []
                   for t in toks]
        partials: Dict[int, Dict[str, Any]] = {}  # chunked rows mid-prompt
        progress: Dict[int, int] = {}             # tokens resident in partial
        store_matched: Dict[int, int] = {}
        published: Dict[int, int] = {}            # block-aligned publish mark
        remaining = list(range(len(reqs)))
        while remaining:
            tlen = {i: progress[i] if i in partials
                    else self._match_len(toks[i], keys_of[i])
                    for i in remaining}
            buckets: Dict[Tuple[int, bool], List[int]] = {}
            for i in remaining:
                slen = len(toks[i]) - tlen[i]
                if chunk is not None and slen > chunk:
                    # mid-prompt chunk: exact length, never padded (pad
                    # junk would land where the next resume still reads)
                    buckets.setdefault((chunk, tlen[i] > 0), []).append(i)
                    continue
                buckets.setdefault((self._bucket_len(slen, tlen[i]),
                                    tlen[i] > 0), []).append(i)
            (blen, hit), idxs = max(buckets.items(),
                                    key=lambda kv: len(kv[1]))
            seen_leads, chosen = set(), []
            for i in idxs:
                lead = keys_of[i][0] if keys_of[i] else None
                if tlen[i] == 0 and lead is not None and lead in seen_leads:
                    continue
                if lead is not None:
                    seen_leads.add(lead)
                chosen.append(i)
            chosen = chosen[: max(self.ecfg.max_batch, 1)]
            n_rows = min(_pow2_ceil(len(chosen)), max(self.ecfg.max_batch, 1))
            matched_of: Dict[int, int] = {}
            tables = None
            if hit:
                cache = T.init_paged_cache(self.cfg, n_rows,
                                           self.ecfg.max_len, bs,
                                           dtype=self.dtype,
                                           device=self.device)
                # host mirror of the wave's tables: each row owns a
                # contiguous run of wave-local pages (prefix pages first,
                # then fresh pages out to the padded write horizon)
                tables = np.full((n_rows, nb_slot), -1, np.int32)
                for row, i in enumerate(chosen):
                    part = None
                    if i in partials:
                        matched_of[i] = progress[i]
                        part = partials.pop(i)
                    else:
                        matched, payloads = self._match(toks[i], keys_of[i])
                        matched_of[i] = store_matched[i] = matched
                        if matched > 0:
                            reqs[i].cached_tokens = matched
                            part = KC.pages_from_payloads(payloads, matched)
                    start = 1 + row * nb_slot
                    if part is not None:
                        n_have = int(part["n_blocks"])
                        KC.insert_paged_state(
                            cache, row, part,
                            list(range(start, start + n_have)), bs)
                    n_need = min(-(-(matched_of[i] + blen) // bs), nb_slot)
                    tables[row, :n_need] = np.arange(start, start + n_need)
                cache["block_tables"] = torch.as_tensor(tables,
                                                        device=self.device)
            else:
                cache = T.init_cache(self.cfg, n_rows, self.ecfg.max_len,
                                     dtype=self.dtype, device=self.device)
                for i in chosen:
                    # records the lookup; a miss bucket matches nothing
                    matched_of[i] = store_matched[i] = \
                        self._match(toks[i], keys_of[i])[0]
            suffix = np.zeros((n_rows, blen), np.int32)
            slens = np.ones((n_rows,), np.int32)   # dummy rows read pos 0
            for row, i in enumerate(chosen):
                s_i = toks[i][matched_of[i]:]
                if chunk is not None:
                    s_i = s_i[:chunk]
                suffix[row, : len(s_i)] = s_i
                slens[row] = len(s_i)
            logits, cache, _ = T.apply(
                self.cfg, self.params,
                torch.as_tensor(suffix, dtype=torch.long, device=self.device),
                cache=cache, mode="prefill", prefix_aware=hit,
                logits_slice="last",
                logits_at=torch.as_tensor(slens - 1, device=self.device))
            done_wave: List[Tuple[int, Dict[str, Any], torch.Tensor]] = []
            wave_tokens = 0
            for row, i in enumerate(chosen):
                new_len = matched_of[i] + int(slens[row])
                if hit:
                    st = KC.extract_paged_state(
                        cache, row, bs,
                        table_row=tables[row][: -(-new_len // bs)],
                        length=new_len)
                else:
                    st = KC.extract_request_state(cache, row)
                    st = KC.dense_state_to_paged(st, bs, length=new_len)
                self.tokens_prefilled += int(slens[row])
                wave_tokens += int(slens[row])
                # publish completed full blocks at every chunk boundary
                pub_from = published.get(i, store_matched.get(i, 0))
                keys_part = keys_of[i][: new_len // bs]
                if len(keys_part) * bs > pub_from:
                    self._publish(toks[i], st, pub_from, keys_part)
                    published[i] = len(keys_part) * bs
                if new_len < len(toks[i]):
                    partials[i] = st            # park mid-prompt, paged
                    progress[i] = new_len
                    continue
                self.n_prefilled += 1
                done_wave.append((i, st, logits[row]))
            done = {i for i, _, _ in done_wave}
            remaining = [i for i in remaining if i not in done]
            yield {"rows": n_rows, "padded_len": blen,
                   "tokens": wave_tokens, "done": done_wave}

    def run_batch(self, reqs: List[Request],
                  chunk_tokens: Optional[int] = None
                  ) -> List[Tuple[Dict[str, Any], torch.Tensor]]:
        """Prefill several requests (drains ``prefill_waves``).  Returns
        ``[(paged request_state, last_logits_row)]`` aligned with
        ``reqs``."""
        out: List[Any] = [None] * len(reqs)
        for wave in self.prefill_waves(reqs, chunk_tokens=chunk_tokens):
            for i, st, lg in wave["done"]:
                out[i] = (st, lg)
        return out

    def run(self, req: Request) -> Tuple[Dict[str, Any], torch.Tensor]:
        """Prefill one request.  Returns (request_state, last_logits)."""
        return self.run_batch([req])[0]

    def run_queued(self, max_reqs: int,
                   chunk_tokens: Optional[int] = None
                   ) -> List[Tuple[Request, Dict[str, Any], torch.Tensor]]:
        """Prefill up to ``max_reqs`` from the head of the routed queue."""
        n = min(max_reqs, len(self.queue))
        if n <= 0:
            return []
        batch = [self.queue.popleft() for _ in range(n)]
        results = self.run_batch(batch, chunk_tokens=chunk_tokens)
        return [(r, st, lg) for r, (st, lg) in zip(batch, results)]


class DecodeEngine:
    """One decode instance: slot-based continuous batching over a
    refcounted paged block pool (full stack)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 name: str = "decode0", device: D.DeviceLike = None):
        self.page_len = check_servable(cfg, ecfg)
        self.device = engine_device(params, device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.name = name
        self.slots: List[Optional[Request]] = [None] * ecfg.max_batch
        self.next_token = np.zeros((ecfg.max_batch,), np.int64)
        # host mirror of active rows' cache lengths (no device syncs on
        # the control paths)
        self._slot_len = np.zeros((ecfg.max_batch,), np.int64)
        self.tokens_decoded = 0
        self.decode_iters = 0
        self._store: Optional[GlobalKVStore] = None
        self.cow_forks = 0        # shared pages forked copy-on-write
        self.pages_shared = 0     # pages bound by reference (no copy)
        self.paged = True
        self.cache = T.init_paged_cache(cfg, ecfg.max_batch, ecfg.max_len,
                                        ecfg.block_size,
                                        dtype=params["embed"].dtype,
                                        device=self.device)
        self._nb_slot = self.page_len // ecfg.block_size
        # host mirrors: block tables and the refcounted pool (page 0 is the
        # scratch page); the device table is refreshed when it goes stale
        self._bt = np.full((ecfg.max_batch, self._nb_slot), -1, np.int32)
        self._bt_dirty = False
        self.pool = KC.BlockPool(1 + ecfg.max_batch * self._nb_slot)
        self._slot_blocks: List[List[int]] = \
            [[] for _ in range(ecfg.max_batch)]
        self.use_kernel = ecfg.decode_kernel is not False

    # -- zero-copy prefix sharing (store-held pages) ---------------------
    @property
    def _free(self) -> List[int]:
        return self.pool.free_list

    def attach_store(self, store: GlobalKVStore) -> None:
        """Let the global store hold refcounted references into this
        engine's block pool (zero-copy prefix sharing)."""
        self._store = store
        store.attach_pool(self.name, self)

    def ref_pages(self, pages: List[int]) -> None:
        self.pool.ref(pages)

    def unref_pages(self, pages: List[int]) -> List[int]:
        return self.pool.unref(pages)

    def materialize(self, page: int) -> Dict[str, Any]:
        """One physical page as a per-block store payload."""
        return KC.page_payload(self.cache, int(page), self.ecfg.block_size)

    def slot_pages(self, slot: int) -> List[int]:
        """Physical pages backing ``slot`` in block order."""
        return list(self._slot_blocks[slot])

    def _ensure_free(self, n: int) -> None:
        """Guarantee ``n`` free pages, demoting LRU store-held pages out of
        the pool first."""
        short = n - len(self.pool.free_list)
        if short > 0 and self._store is not None:
            self._store.reclaim_pool(self.name, short)
        assert len(self.pool.free_list) >= n, "decode block pool exhausted"

    # ------------------------------------------------------------------
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def free_slots(self) -> int:
        return self.ecfg.max_batch - self.active

    @property
    def kv_tokens(self) -> int:
        return int(self._slot_len.sum())

    def load_report(self) -> LoadReport:
        cap = max(self.ecfg.max_batch, 1)
        mem = self.kv_tokens / max(self.ecfg.max_batch * self.ecfg.max_len, 1)
        return LoadReport(compute_frac=self.active / cap,
                          memory_frac=min(mem, 1.0), queue_len=self.active,
                          layer_span=(0, self.cfg.n_layers))

    # -- slot transfer ---------------------------------------------------
    def _release_blocks(self, slot: int) -> None:
        # pages free only at refcount zero: a page the store (or a sharing
        # sibling) still holds stays resident
        self.pool.unref(list(reversed(self._slot_blocks[slot])))
        self._slot_blocks[slot] = []
        self._bt[slot, :] = -1
        # a freed page can be reallocated: resync the device row before
        # the next step writes through it
        self._bt_dirty = True

    def adopt(self, req: Request, state: Dict[str, Any],
              next_token: int, slot: Optional[int] = None,
              shared_pages: Optional[List[int]] = None) -> int:
        """Place an in-flight request's paged state into a free slot: page
        copies into fresh blocks, plus ``shared_pages`` (pages of this pool
        holding the request's prefix) bound by reference in front; the
        state must already be head-split past them."""
        if slot is None:
            slot = self.free_slot()
        assert slot is not None and self.slots[slot] is None, \
            "decode engine full"
        shared = [int(p) for p in (shared_pages or ())]
        if shared:
            self.pool.ref(shared)
            self.pages_shared += len(shared)
        if "n_blocks" not in state:
            state = KC.dense_state_to_paged(state, self.ecfg.block_size)
        n = int(state["n_blocks"])
        self._ensure_free(n)
        phys = self.pool.alloc(n)
        KC.insert_paged_state(self.cache, slot, state, phys,
                              self.ecfg.block_size)
        row = shared + phys
        self._bt[slot, :] = -1
        self._bt[slot, :len(row)] = row
        self._slot_blocks[slot] = list(row)
        if shared:
            # the insert wrote a suffix-only table row; put the bound
            # prefix in front before anything reads through it
            self.cache["block_tables"][slot] = torch.as_tensor(
                self._bt[slot], device=self.device)
        self.slots[slot] = req
        self.next_token[slot] = int(next_token)
        self._slot_len[slot] = int(state["length"])
        req.decode_instance = self.name
        return slot

    def insert(self, req: Request, state: Dict[str, Any], first_token: int,
               shared_pages: Optional[List[int]] = None) -> int:
        """KV transfer: place a prefilled request into a decode slot."""
        slot = self.adopt(req, state, int(first_token),
                          shared_pages=shared_pages)
        req.generated.append(int(first_token))
        req.advance(Phase.DECODE)
        return slot

    def extract_slot(self, slot: int
                     ) -> Tuple[Request, Dict[str, Any], int]:
        """Pull an active slot's paged state out (only its pages)."""
        req = self.slots[slot]
        assert req is not None, f"slot {slot} empty"
        state = KC.extract_paged_state(
            self.cache, slot, self.ecfg.block_size,
            table_row=self._bt[slot], length=int(self._slot_len[slot]))
        self._release_blocks(slot)
        tok = int(self.next_token[slot])
        self.slots[slot] = None
        self._slot_len[slot] = 0
        return req, state, tok

    def drain(self) -> List[Tuple[Request, Dict[str, Any], int]]:
        """Extract every active slot."""
        return [self.extract_slot(i) for i, s in enumerate(self.slots)
                if s is not None]

    def release_slot(self, slot: int) -> Request:
        """Free an active slot without gathering its state (abort)."""
        req = self.slots[slot]
        assert req is not None, f"slot {slot} empty"
        self._release_blocks(slot)
        self.slots[slot] = None
        self._slot_len[slot] = 0
        self.next_token[slot] = 0
        return req

    # -- decode ----------------------------------------------------------
    def _prepare_pages(self) -> None:
        """Make every active slot exclusively own the page its next token
        lands in, and the device table fresh: allocate unassigned blocks,
        fork shared ones (refcount > 1) copy-on-write BEFORE the step
        writes into them, write through exclusive ones."""
        fresh: List[int] = []
        cow_src: List[int] = []
        cow_dst: List[int] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            j = (int(self._slot_len[i]) % self.page_len) \
                // self.ecfg.block_size
            pb = int(self._bt[i, j])
            if pb < 0:
                self._ensure_free(1)
                nb = self.pool.alloc(1)[0]
                self._bt[i, j] = nb
                self._slot_blocks[i].append(nb)
                fresh.append(nb)
            elif self.pool.refcount[pb] > 1:
                self._ensure_free(1)
                nb = self.pool.alloc(1)[0]
                self._bt[i, j] = nb
                self._slot_blocks[i][self._slot_blocks[i].index(pb)] = nb
                self.pool.unref([pb])
                cow_src.append(pb)
                cow_dst.append(nb)
                self.cow_forks += 1
        if cow_src:
            KC.copy_pages(self.cache, cow_src, cow_dst,
                          block_size=self.ecfg.block_size)
        if fresh:
            # recycled pages carry the previous owner's positions
            KC.reset_page_positions(self.cache, fresh, self.ecfg.block_size)
        if fresh or cow_src or self._bt_dirty:
            self.cache["block_tables"] = torch.as_tensor(self._bt,
                                                         device=self.device)
            self._bt_dirty = False

    def commit(self, nxt: np.ndarray) -> List[Tuple[Request, int]]:
        """Append sampled tokens, retire finished requests, free their
        pages.  Returns finished (request, slot)."""
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if len(req.generated) >= req.max_new_tokens:
                # budget met at insert time: finish without emitting
                req.advance(Phase.DONE)
                finished.append((req, i))
                self.slots[i] = None
                self._slot_len[i] = 0
                self._release_blocks(i)
                continue
            tok = int(nxt[i])
            req.generated.append(tok)
            self.next_token[i] = tok
            self._slot_len[i] += 1
            self.tokens_decoded += 1
            if (len(req.generated) >= req.max_new_tokens
                    or int(self._slot_len[i]) >= self.ecfg.max_len - 1):
                req.advance(Phase.DONE)
                finished.append((req, i))
                self.slots[i] = None
                self._slot_len[i] = 0
                self._release_blocks(i)
        return finished

    def step(self) -> List[Tuple[Request, int]]:
        """One greedy decode iteration for all active slots."""
        if self.active == 0:
            return []
        self.decode_iters += 1
        self._prepare_pages()
        tokens = torch.as_tensor(self.next_token[:, None], device=self.device)
        logits, self.cache, _ = T.apply(
            self.cfg, self.params, tokens, cache=self.cache, mode="decode",
            logits_slice="last", paged_kernel=self.use_kernel)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        return self.commit(nxt)
