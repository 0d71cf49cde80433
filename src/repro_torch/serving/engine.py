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
shared pages, and zero-copy binds of store-resident prefix pages.  With
``speculation`` set, a step proposes up to ``spec_len`` tokens per slot
(``ngram_propose``, or a draft model with a dense per-slot cache,
``_Draft``), verifies the pending token and its proposals in one
multi-query pass over the pages (kernel B4), commits the longest prefix
equal to greedy plus the verifier's bonus token, and rolls rejected
tokens' fresh pages back through the pool.

Every decode-side forward (the plain step, each verify width, the draft's
micro-step, each span stage's step) is a ``CompiledStep`` over the
engine's static cache: on the card a CUDA graph captured once and
replayed, the port's counterpart of JAX's jitted forward with the cache
donated.  Prefill waves run eagerly; ``PrefillEngine.compile_report``
lists their (rows, padded suffix, hit) shapes, as JAX's does.

Both mirror the JAX package's ``serving/engine.py`` and report
``core.scheduling.LoadReport``s for the routers.  With ``layer_span``
either hosts a contiguous span of the stack (its weights views of the
full parameters): the stages of a ``serving/span.py`` pipeline, which
chains the residual stream through them (``apply(hidden_in,
hidden_out)``) and re-slices them live (``rebase_span``).  This slice
serves pageable global-attention stacks (a gated MLP or a top-k MoE after
each attention; MoE through ``T.apply``'s default no-drop sorted
dispatch, as JAX serves it), with bf16/f32 or int8 KV caches
(``kv_quant``: int8 pages plus f32 scale pages, read by the int8 variants
of kernels B1 and B4); other stacks raise ``NotImplementedError``.  As in
the JAX package, an int8 stack has no prefix store and cannot resume a
prompt chunk by chunk.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import device as D
from ..core import analytical as A
from ..core import layer_migration as LM
from ..core.kvstore import GlobalKVStore, chain_hashes
from ..core.scheduling import LoadReport
from ..kernels import _lib
from ..models import kvcache as KC
from ..models import transformer as T
from ..models.config import ModelConfig
from .request import Phase, Request


SPECULATION_MODES = ("off", "ngram", "draft")


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
    # speculative decoding on the decode step: "off" = one token per
    # iteration; "ngram" = draft-free lookahead (suffix match over the
    # slot's prompt + output); "draft" = a second model proposes
    # (DecodeEngine's ``draft`` argument).  Proposals are verified exactly
    # in one multi-query pass, so streams equal plain greedy decode.
    speculation: str = "off"
    spec_len: int = 4             # max proposed tokens per iteration
    spec_adaptive: bool = True    # adapt per-slot depth to acceptance
    # decode, verify and draft forwards replayed from CUDA graphs captured
    # over the engine's static cache; False runs the same static-buffer
    # step eagerly on the card, for comparison (the CPU has no graphs)
    cuda_graphs: bool = True

    def __post_init__(self):
        if self.speculation not in SPECULATION_MODES:
            raise ValueError(f"speculation must be one of "
                             f"{SPECULATION_MODES}, got "
                             f"{self.speculation!r}")


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def serving_page_len(cfg: ModelConfig, max_len: int) -> Optional[int]:
    """The page space: the longest attention cache at this cache size."""
    lens = [T._cache_len(cfg, kind, max_len) for kind in set(cfg.blocks())]
    return max(lens) if lens else None


def check_servable(cfg: ModelConfig, ecfg: EngineConfig) -> int:
    """The page length of a stack this slice serves (pageable global
    attention, bf16/f32 or int8 KV); raises ``NotImplementedError``
    otherwise (no dense fallback)."""
    T.check_supported(cfg)
    plen = serving_page_len(cfg, ecfg.max_len)
    if not KC.global_attention(cfg) or plen is None \
            or plen % ecfg.block_size:
        raise NotImplementedError(
            f"{cfg.name}: the port serves pageable global-attention stacks "
            f"(cache length a multiple of block_size {ecfg.block_size}); "
            "windowed and other stacks come with a later slice (ROADMAP A6)")
    return plen


StepKey = Tuple[str, int, bool, bool, bool]


class CompiledStep:
    """One decode-side forward over static buffers: the port's counterpart
    of the JAX package's ``_jit_apply`` (a jitted forward with the cache
    donated, ``src/repro/serving/engine.py``).

    It runs ``T.apply(cfg, params, x, cache=cache, mode="decode",
    **apply_kw)`` on a static input ``x`` of one shape and on the engine's
    cache, whose tensors (pools, block tables, lengths) are updated in
    place and never rebound; the step leaves the advanced lengths in the
    cache's own ``lengths``.  ``graphed``: captured once into a CUDA graph
    (its memory from ``pool``) and replayed on every call; otherwise the
    same function runs eagerly over the same buffers (the CPU, or
    ``EngineConfig.cuda_graphs=False``), so there is one decode code path.
    The forward decides on the host from shapes only (the kernel
    wrappers' checks and page splits), and does so once, at capture.
    The output is a static tensor, valid until the next call.

    Capture first runs the forward on a side stream, as PyTorch asks,
    then restores the lengths it advanced; its page writes sit where the
    replay writes again.  ``_lib.LAUNCHES`` counts on the host, so the
    launches of the warm-up and the capture are taken back, and each
    replay adds those the capture recorded.  A forward that cannot be
    captured raises; nothing runs it eagerly instead.

    JAX shares executables across engines (an ``lru_cache`` keyed on the
    config).  A graph is bound to the addresses of one engine's tensors,
    so every engine captures its own, and one that rebuilds its cache (a
    span move) or is built anew (a re-roll) captures afresh."""

    def __init__(self, cfg: ModelConfig, params, cache, shape: Tuple[int, ...],
                 dtype: torch.dtype, *, graphed: bool, pool=None,
                 **apply_kw):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.apply_kw = apply_kw
        self.x = torch.zeros(shape, dtype=dtype,
                             device=cache["lengths"].device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}     # per replay
        self.capture_s = 0.0
        if graphed:
            self._capture(pool)

    def _run(self) -> torch.Tensor:
        out, new, _ = T.apply(self.cfg, self.params, self.x,
                              cache=self.cache, mode="decode",
                              **self.apply_kw)
        self.cache["lengths"].copy_(new["lengths"])
        return out

    def _capture(self, pool) -> None:
        t0 = time.perf_counter()
        counts = dict(_lib.LAUNCHES)
        lengths = self.cache["lengths"].clone()
        side = torch.cuda.Stream(self.x.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream().wait_stream(side)
        self.cache["lengths"].copy_(lengths)
        warm = dict(_lib.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = self._run()
        self.launches = {k: n - warm[k] for k, n in _lib.LAUNCHES.items()
                         if n != warm[k]}
        _lib.LAUNCHES.update(counts)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.x.copy_(x)
        if self.graph is None:
            return self._run()
        self.graph.replay()
        for k, n in self.launches.items():
            _lib.LAUNCHES[k] += n
        return self.out


class StepCache:
    """A decode engine's ``CompiledStep``s, keyed by what changes their
    shape or code path: (mode "decode" / "verify" / "draft", width S,
    hidden_in, hidden_out, int8 pools).  Their graphs share one memory
    pool.  ``reset`` drops them all (the engine rebuilt its cache); the
    totals count every capture of the engine's life."""

    def __init__(self, device: torch.device, cuda_graphs: bool):
        self.graphed = device.type == "cuda" and cuda_graphs
        self.steps: Dict[StepKey, CompiledStep] = {}
        self.pool = None
        self.graphs_captured = 0
        self.capture_s = 0.0

    def get(self, key: StepKey, cfg: ModelConfig, params, cache,
            shape: Tuple[int, ...], dtype: torch.dtype,
            **apply_kw) -> CompiledStep:
        step = self.steps.get(key)
        if step is None:
            if self.graphed and self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            step = self.steps[key] = CompiledStep(
                cfg, params, cache, shape, dtype, graphed=self.graphed,
                pool=self.pool, **apply_kw)
            self.graphs_captured += step.graph is not None
            self.capture_s += step.capture_s
        return step

    def reset(self) -> None:
        self.steps = {}
        self.pool = None

    def report(self) -> Dict[str, Any]:
        """Steps held now, and graphs captured (with their seconds of
        warm-up and capture) over the engine's life."""
        return {"steps": sorted(self.steps), "graphs": self.graphed,
                "graphs_captured": self.graphs_captured,
                "capture_s": self.capture_s}


def _span_view(cfg: ModelConfig, params,
               layer_span: Optional[Tuple[int, int]]):
    """(span, span config, span params): the identity for a full-stack
    engine; otherwise the span's config and views of its layers' weights
    (``layer_migration.span_params``: no weight is copied)."""
    span = (0, cfg.n_layers) if layer_span is None else tuple(layer_span)
    if span == (0, cfg.n_layers):
        return span, cfg, params
    return span, LM.span_config(cfg, *span), LM.span_params(cfg, params,
                                                            *span)


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


def ngram_propose(ctx: List[int], k: int, max_n: int = 3) -> List[int]:
    """Draft-free lookahead proposal: suffix-match the last ``n``-gram of
    ``ctx`` (prompt + generated, pending token last) against its own
    earlier occurrences, longest ``n`` first, most recent match wins, and
    propose the up-to-``k`` tokens that followed it.  Host-side and
    rebuilt from the Request every call, so it needs no wire state."""
    L = len(ctx)
    for n in range(min(max_n, L - 1), 0, -1):
        pat = ctx[L - n:]
        for s in range(L - n - 1, -1, -1):
            if ctx[s:s + n] == pat:
                return ctx[s + n:s + n + k]
    return []


class _Draft:
    """The draft side of two-model speculation: a model with its own dense
    per-slot KV cache, advanced one token at a time to propose the
    continuations the target verifies.  Rollback is free: entries past a
    slot's valid length sit at positions beyond every later query (masked)
    and are overwritten in place, so a rejection only truncates the host
    length mirror."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device: torch.device, compiled: StepCache):
        if (not cfg.uses_kv_cache or cfg.uses_recurrent_state
                or cfg.sliding_window is not None):
            raise ValueError(f"{cfg.name}: the draft model needs "
                             "rollback-safe (full-attention) KV")
        self.device = engine_device(params, device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.cache = T.init_cache(cfg, ecfg.max_batch, ecfg.max_len,
                                  dtype=params["embed"].dtype,
                                  device=self.device)
        # valid resident tokens per slot (a prefix of the committed stream)
        self.len = np.zeros((ecfg.max_batch,), np.int64)
        self.compiled = compiled  # the decode engine's: one graph pool

    def reset_slot(self, slot: int) -> None:
        self.len[slot] = 0

    def prefill_slot(self, slot: int, resident: List[int]) -> None:
        """(Re)build one slot's draft KV from the committed stream through
        the fresh-prefill path (kernel B2 on the card)."""
        n = len(resident)
        if n == 0:
            self.len[slot] = 0
            return
        padded = min(_pow2_ceil(n), self.ecfg.max_len)
        buf = np.zeros((1, padded), np.int64)
        buf[0, :n] = np.asarray(resident, np.int64)
        cache = T.init_cache(self.cfg, 1, self.ecfg.max_len,
                             dtype=self.params["embed"].dtype,
                             device=self.device)
        _, cache, _ = T.apply(
            self.cfg, self.params, torch.as_tensor(buf, device=self.device),
            cache=cache, mode="prefill", logits_slice="last",
            logits_at=torch.as_tensor([n - 1], device=self.device))
        st = KC.extract_request_state(cache, 0)
        st["length"] = n
        KC.insert_request_state(self.cache, slot, st)
        self.len[slot] = n

    def run(self, schedules: Dict[int, List[int]], n_out: int,
            greedy_from: Dict[int, int]
            ) -> Tuple[Dict[int, List[int]], int]:
        """Batched draft micro-steps.  ``schedules[i]`` is slot i's forced
        input (catch-up tokens, then the pending token); once exhausted,
        the slot's own greedy output feeds back in.  Returns (per-slot
        proposals: the first ``n_out`` greedy outputs from step
        ``greedy_from[i]`` on, micro-steps run)."""
        if not schedules:
            return {}, 0
        bsz = self.ecfg.max_batch
        n_steps = max(greedy_from[i] + n_out for i in schedules)
        self.cache["lengths"].copy_(torch.from_numpy(
            self.len.astype(np.int32)))
        step = self.compiled.get(
            ("draft", 1, False, False, self.cfg.kv_quant), self.cfg,
            self.params, self.cache, (bsz, 1), torch.long,
            logits_slice="last")
        col = np.zeros((bsz,), np.int64)
        prev = np.zeros((bsz,), np.int64)
        outs: Dict[int, List[int]] = {i: [] for i in schedules}
        for t in range(n_steps):
            for i, sched in schedules.items():
                col[i] = sched[t] if t < len(sched) else prev[i]
            logits = step(torch.from_numpy(col[:, None]))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for i in schedules:
                prev[i] = nxt[i]
                if t >= greedy_from[i] and len(outs[i]) < n_out:
                    outs[i].append(int(nxt[i]))
        return outs, n_steps


class PrefillEngine:
    """One prefill instance.

    ``layer_span=(a, b)`` makes it a partial-stack instance hosting layers
    [a, b) (weights are views of the full parameters); a chain of span
    engines covering the stack (``serving/span.py``'s ``PrefillPipeline``)
    reproduces the full-stack prefill.  Bucketing and the wire format
    follow the full stack, so chained stages agree and hand-off states
    stay full-stack.  Span engines hold no store (its payloads are
    full-stack)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 store: Optional[GlobalKVStore] = None,
                 name: str = "prefill0", device: D.DeviceLike = None,
                 layer_span: Optional[Tuple[int, int]] = None):
        self._page_len = check_servable(cfg, ecfg)
        self.device = engine_device(params, device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.dtype = params["embed"].dtype
        self.layer_span, self.scfg, self.sparams = \
            _span_view(cfg, params, layer_span)
        # the store holds pages of linear bf16/f32 caches only (JAX drops
        # it the same way for int8 KV), and full-stack pages only
        full = self.layer_span == (0, cfg.n_layers)
        self.store = store if full and KC.prefix_cacheable(cfg) else None
        self.name = name
        # set by PrefillPipeline: the downstream span engines this one
        # chains each wave's residual stream into
        self._followers: List["PrefillEngine"] = []
        self.queue: Deque[Request] = deque()   # routed, not yet prefilled
        self.tokens_prefilled = 0         # suffix tokens actually computed
        self.n_prefilled = 0
        # leading-block hash -> cached tokens (prefix-aware routing signal)
        self._leading: Dict[bytes, int] = {}
        # padded writes must never wrap the cache (linear: the page space)
        self._pad_cap = self._page_len
        # (rows, padded suffix, hit) of every wave forward run: JAX's
        # jit-shape log, the keys of prefill forwards (compile_report)
        self.prefill_shapes: Set[Tuple[int, int, bool]] = set()
        self._t_layer_fetch = (
            A.prefill_time(cfg, ecfg.block_size, ecfg.hw)
            / max(cfg.n_layers, 1) if ecfg.hw is not None else None)
        self.fetch_latency_s = 0.0

    def rebase_span(self, layer_span: Tuple[int, int]) -> None:
        """Re-slice this prefill stage to another contiguous span (a layer
        move).  Prefill holds no resident serving state, so only the span
        views change."""
        self.layer_span, self.scfg, self.sparams = \
            _span_view(self.cfg, self.params, layer_span)

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
                          layer_span=self.layer_span)

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

    def prefill_shape_bound(self) -> int:
        """Upper bound on distinct prefill wave shapes under the padded
        bucket discipline, as JAX's: power-of-two rows x (power-of-two
        suffix lengths + block-aligned capacity caps) x hit/miss."""
        def pow2s(cap: int) -> set:
            vals, v = {cap}, 1
            while v < cap:
                vals.add(v)
                v <<= 1
            return vals
        lens = pow2s(self.ecfg.max_len)
        lens |= {self._pad_cap - j * self.ecfg.block_size
                 for j in range(0, self._pad_cap
                                // max(self.ecfg.block_size, 1))}
        return 2 * len(pow2s(max(self.ecfg.max_batch, 1))) \
            * len({v for v in lens if v >= 1})

    def compile_report(self) -> Dict[str, Any]:
        """Distinct (rows, padded_suffix, hit) wave shapes this engine ran
        (JAX's dict: each is at most one XLA compile there)."""
        return {"shapes": sorted(self.prefill_shapes),
                "n_shapes": len(self.prefill_shapes),
                "bound": self.prefill_shape_bound()}

    # -- prefill -----------------------------------------------------------
    def prefill_waves(self, reqs: List[Request],
                      chunk_tokens: Optional[int] = None):
        """Generator of the prefill wave loop: one forward per ``next()``.
        Same wave semantics as the JAX engine: bucket by (padded suffix
        length, prefix hit), defer duplicate uncached prefixes, cap at
        ``max_batch`` rows, pad rows to a power of two; with
        ``chunk_tokens`` a row computes at most that many prompt tokens
        per wave and resumes through the paged incremental path.

        Yields ``{"rows", "padded_len", "tokens", "done": [(index into
        reqs, paged request state, last-token logits)]}``.  An int8-KV
        stack cannot resume a prompt (the JAX engine fails at its ``int8
        cache + prefix store not combined`` assert): a prompt longer than
        ``chunk_tokens`` raises ``ValueError`` here, before any work.

        With chained followers (a span pipeline) every wave's residual
        stream flows through each span in turn over dense per-span wave
        caches, chunk resumes included (plain ``attend`` over the cached
        prefix, as in JAX), and the per-span states merge back into the
        full-stack wire format."""
        if self.layer_span[0] != 0:
            raise ValueError("mid-stack span engines run only as "
                             "PrefillPipeline followers")
        chunk = max(int(chunk_tokens), 1) if chunk_tokens else None
        if self.cfg.kv_quant and chunk is not None:
            long = [r.rid for r in reqs if r.prompt_len > chunk]
            if long:
                raise ValueError(
                    f"{self.cfg.name}: int8 KV cannot resume prefill chunk "
                    f"by chunk (JAX asserts 'int8 cache + prefix store not "
                    f"combined'); requests {long} have prompts longer than "
                    f"chunk_tokens={chunk}")
        return self._waves(reqs, chunk)

    def _waves(self, reqs: List[Request], chunk: Optional[int]):
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
            chain = [self] + self._followers
            bounds = [e.layer_span for e in chain]
            matched_of: Dict[int, int] = {}
            tables = None
            # hit waves of a single-span engine run paged (kernel B3 reads
            # the prefix in place); a chain resumes over dense caches
            use_paged = hit and len(chain) == 1
            if use_paged:
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
                caches = [cache]
            else:
                caches = [T.init_cache(e.scfg, n_rows, self.ecfg.max_len,
                                       dtype=self.dtype, device=self.device)
                          for e in chain]
                for row, i in enumerate(chosen):
                    if i in partials:
                        # chained resume: the parked full-stack state,
                        # dense, split at the chain's cuts
                        matched_of[i] = progress[i]
                        dense = KC.paged_state_to_dense(
                            partials.pop(i), bs, self._page_len)
                        for c, part in zip(caches, LM.split_state_spans(
                                self.cfg, dense, bounds)):
                            KC.insert_request_state(c, row, part)
                        continue
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
            self.prefill_shapes.add((n_rows, blen, hit))
            x = torch.as_tensor(suffix, dtype=torch.long, device=self.device)
            logits_at = torch.as_tensor(slens - 1, device=self.device)
            for k, e in enumerate(chain):
                # stage k takes the previous span's residual stream and,
                # except the last, hands one on
                x, caches[k], _ = T.apply(
                    e.scfg, e.sparams, x, cache=caches[k], mode="prefill",
                    prefix_aware=hit, logits_slice="last",
                    logits_at=logits_at, hidden_in=k > 0,
                    hidden_out=k < len(chain) - 1)
            logits = x
            done_wave: List[Tuple[int, Dict[str, Any], torch.Tensor]] = []
            wave_tokens = 0
            for row, i in enumerate(chosen):
                new_len = matched_of[i] + int(slens[row])
                if use_paged:
                    st = KC.extract_paged_state(
                        caches[0], row, bs,
                        table_row=tables[row][: -(-new_len // bs)],
                        length=new_len)
                else:
                    st = (KC.extract_request_state(caches[0], row)
                          if len(chain) == 1 else LM.merge_state_spans(
                              self.cfg, [KC.extract_request_state(c, row)
                                         for c in caches], bounds))
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
    refcounted paged block pool.  ``draft=(cfg, params)`` is the draft
    model of ``speculation="draft"``.

    ``layer_span=(a, b)`` makes it a partial-stack stage hosting layers
    [a, b): its weights are views of the full parameters, its pool covers
    only the span, and a ``serving/span.py`` ``DecodePipeline`` chains
    stages so the batch's residual stream runs the whole stack each
    step.  ``rebase_span`` re-slices an emptied stage (a layer move)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 name: str = "decode0", device: D.DeviceLike = None,
                 draft: Optional[Tuple[ModelConfig, Any]] = None,
                 layer_span: Optional[Tuple[int, int]] = None):
        check_servable(cfg, ecfg)
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
        self.decode_iters = 0     # decode/verify forwards run
        self.spec_proposed = 0    # speculative tokens scored for acceptance
        self.spec_accepted = 0    # of those, committed (bonus not counted)
        self._store: Optional[GlobalKVStore] = None
        self.cow_forks = 0        # shared pages forked copy-on-write
        self.pages_shared = 0     # pages bound by reference (no copy)
        self.paged = True
        self.use_kernel = ecfg.decode_kernel is not False
        # speculation: the mode from the config, a runtime switch the
        # orchestrator flips per iteration, and per-slot adaptive depth
        # from the measured acceptance (the gate, ``_spec_ok``, is set
        # per span)
        self.spec_on = ecfg.speculation != "off"
        self._spec_k = np.full((ecfg.max_batch,), max(ecfg.spec_len, 1),
                               np.int64)
        self._spec_ema = np.ones((ecfg.max_batch,), np.float64)
        # the compiled decode, verify and draft steps (CUDA graphs on the
        # card), dropped whenever the cache is rebuilt; ``report()`` gives
        # the graphs captured and their capture time
        self.compiled = StepCache(self.device, ecfg.cuda_graphs)
        self._draft: Optional[_Draft] = None
        if ecfg.speculation == "draft":
            if draft is None:
                raise ValueError("speculation='draft' needs "
                                 "draft=(draft_cfg, draft_params)")
            self._draft = _Draft(draft[0], draft[1], ecfg, self.device,
                                 self.compiled)
        self._set_span(layer_span)

    def _set_span(self, layer_span: Optional[Tuple[int, int]]) -> None:
        """(Re-)derive the span's views and a blank pool for it; the
        compiled steps were bound to the old ones and go."""
        ecfg = self.ecfg
        self.compiled.reset()
        self.layer_span, self.scfg, self.sparams = \
            _span_view(self.cfg, self.params, layer_span)
        self.page_len = check_servable(self.scfg, ecfg)
        self.cache = T.init_paged_cache(self.scfg, ecfg.max_batch,
                                        ecfg.max_len, ecfg.block_size,
                                        dtype=self.params["embed"].dtype,
                                        device=self.device)
        self._nb_slot = self.page_len // ecfg.block_size
        # host mirrors: block tables and the refcounted pool (page 0 is the
        # scratch page); the device table is refreshed when it goes stale
        self._bt = np.full((ecfg.max_batch, self._nb_slot), -1, np.int32)
        self._bt_dirty = False
        self.pool = KC.BlockPool(1 + ecfg.max_batch * self._nb_slot)
        self._slot_blocks: List[List[int]] = \
            [[] for _ in range(ecfg.max_batch)]
        # speculation needs rollback-safe KV (full attention, no window,
        # no recurrent or cross state), which every stack check_servable
        # admits, on a full-stack engine: span pipelines decode plain, as
        # in JAX
        self._spec_ok = (ecfg.speculation != "off"
                         and self.layer_span == (0, self.cfg.n_layers))

    def rebase_span(self, layer_span: Tuple[int, int]) -> None:
        """Re-slice this stage to another contiguous span (a layer move).
        The serving state does not survive: the ``DecodePipeline`` takes
        every slot out first and re-adopts the split states after.  The
        compiled steps are captured afresh."""
        if self.active:
            raise RuntimeError("take the slots out before re-slicing the "
                               "span")
        self._set_span(layer_span)

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

    @property
    def span_frac(self) -> float:
        """This stage's share of the stack (1.0 for a full-stack engine)."""
        a, b = self.layer_span
        return (b - a) / max(self.cfg.n_layers, 1)

    def load_report(self) -> LoadReport:
        """Occupancy as C/C_max and resident KV against the full cache as
        M/M_max; a span stage scales both by its share of the stack
        (per-layer compute and KV are additive in the hosted layers), so
        the Algorithm 1 controller sees the heavier stage as hotter."""
        cap = max(self.ecfg.max_batch, 1)
        mem = self.kv_tokens / max(self.ecfg.max_batch * self.ecfg.max_len, 1)
        return LoadReport(compute_frac=self.active / cap * self.span_frac,
                          memory_frac=min(mem, 1.0) * self.span_frac,
                          queue_len=self.active, layer_span=self.layer_span)

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
        # speculation starts optimistic; the draft cache rebuilds lazily
        # from the committed stream on the first verify iteration
        self._spec_ema[slot] = 1.0
        self._spec_k[slot] = max(self.ecfg.spec_len, 1)
        if self._draft is not None:
            self._draft.reset_slot(slot)
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
        if self._draft is not None:
            self._draft.reset_slot(slot)
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
        if self._draft is not None:
            self._draft.reset_slot(slot)
        return req

    # -- decode ----------------------------------------------------------
    def _prepare_pages(self, n_tokens: int = 1
                       ) -> Dict[int, List[Tuple[int, int]]]:
        """Make every active slot exclusively own the pages its next
        ``n_tokens`` tokens land in, and the device table fresh: allocate
        unassigned blocks, fork shared ones (refcount > 1) copy-on-write
        BEFORE the step writes into them, write through exclusive ones.
        Returns the freshly allocated blocks per slot,
        ``{slot: [(table index, block)]}``: the speculative step rolls back
        those no committed token reached."""
        fresh: List[int] = []
        fresh_by: Dict[int, List[Tuple[int, int]]] = {}
        cow_src: List[int] = []
        cow_dst: List[int] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            for t in range(n_tokens):
                j = ((int(self._slot_len[i]) + t) % self.page_len) \
                    // self.ecfg.block_size
                pb = int(self._bt[i, j])
                if pb < 0:
                    self._ensure_free(1)
                    nb = self.pool.alloc(1)[0]
                    self._bt[i, j] = nb
                    self._slot_blocks[i].append(nb)
                    fresh.append(nb)
                    fresh_by.setdefault(i, []).append((j, nb))
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
            # in place: the compiled steps read this very table
            self.cache["block_tables"].copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False
        return fresh_by

    def _step_for(self, mode: str, s: int, x_shape: Tuple[int, ...],
                  x_dtype: torch.dtype, *, hidden_in: bool = False,
                  hidden_out: bool = False,
                  logits_slice: str = "last") -> CompiledStep:
        return self.compiled.get(
            (mode, s, hidden_in, hidden_out, self.cfg.kv_quant), self.scfg,
            self.sparams, self.cache, x_shape, x_dtype,
            logits_slice=logits_slice, paged_kernel=self.use_kernel,
            hidden_in=hidden_in, hidden_out=hidden_out)

    def _forward_step(self, x: torch.Tensor, *, hidden_in: bool = False,
                      hidden_out: bool = False) -> torch.Tensor:
        """One decode forward over this stage's span (its compiled step).
        ``x`` is the (max_batch, 1) token column (first stage) or the
        upstream stage's (max_batch, 1, d_model) residual stream, on any
        device; returns last-token logits, or with ``hidden_out`` the
        residual stream for the next stage."""
        bsz = self.ecfg.max_batch
        if hidden_in:
            shape = (bsz, 1, self.cfg.d_model)
            dtype = self.params["embed"].dtype
        else:
            shape, dtype = (bsz, 1), torch.long
        return self._step_for("decode", 1, shape, dtype, hidden_in=hidden_in,
                              hidden_out=hidden_out)(x)

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

    def follow_commit(self, nxt: np.ndarray,
                      finished_slots: Set[int]) -> None:
        """Mirror a pipeline lead's ``commit`` on a follower stage: the
        same per-slot advance and retirement, no Request mutation (the
        lead owns request lifecycles and token streams)."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if i in finished_slots:
                self.slots[i] = None
                self._slot_len[i] = 0
                self._release_blocks(i)
                continue
            self.next_token[i] = int(nxt[i])
            self._slot_len[i] += 1

    def step(self) -> List[Tuple[Request, int]]:
        """One greedy decode iteration for all active slots.  With
        speculation on (and the stack rollback-safe) it verifies up to
        ``spec_len`` proposals per slot in one multi-query pass and commits
        between 1 and spec_len + 1 tokens per slot, the same stream plain
        greedy decode gives."""
        if self.active == 0:
            return []
        if self.spec_on and self._spec_ok:
            out = self._spec_step()
            if out is not None:
                return out
        self.decode_iters += 1
        self._prepare_pages()
        logits = self._forward_step(torch.from_numpy(self.next_token[:, None]))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        return self.commit(nxt)

    # -- speculative decoding -------------------------------------------
    def _commit_slot(self, i: int, toks: List[int]) -> bool:
        """Append committed tokens under the plain step's finish rules, one
        at a time, stopping at the budget or capacity boundary (surplus
        speculation is dropped, never emitted).  True when finished."""
        req = self.slots[i]
        for tok in toks:
            req.generated.append(int(tok))
            self.next_token[i] = int(tok)
            self._slot_len[i] += 1
            self.tokens_decoded += 1
            if (len(req.generated) >= req.max_new_tokens
                    or int(self._slot_len[i]) >= self.ecfg.max_len - 1):
                return True
        return False

    def _rollback_pages(self, slot: int,
                        fresh_blocks: List[Tuple[int, int]]) -> None:
        """Return this step's fresh blocks that no committed token reached
        to the pool.  They are exclusively owned (refcount 1), so shared
        and forked prefix pages are never touched; with speculation gated
        to full-attention stacks the page space never wraps, so a block's
        table index times block_size is its first position.  Rejected
        tokens left in kept blocks sit past every later query's position
        (masked) until overwritten."""
        bs = self.ecfg.block_size
        new_len = int(self._slot_len[slot])
        for j, blk in fresh_blocks:
            if j * bs >= new_len:
                self._bt[slot, j] = -1
                self._slot_blocks[slot].remove(blk)
                self.pool.unref([blk])
                self._bt_dirty = True

    def _retire_slot(self, i: int) -> None:
        self.slots[i] = None
        self._slot_len[i] = 0
        self._release_blocks(i)
        if self._draft is not None:
            self._draft.reset_slot(i)

    def _pin_lengths(self) -> None:
        """Device lengths from the committed host mirror (a verify pass
        advances them by its full width, committed or not)."""
        self.cache["lengths"].copy_(torch.from_numpy(
            self._slot_len.astype(np.int32)))

    def _spec_step(self) -> Optional[List[Tuple[Request, int]]]:
        """One speculative iteration: propose per slot, score the pending
        token plus all proposals in one verify pass, commit the longest
        prefix equal to greedy plus the bonus token, roll rejected tokens'
        pages back.  Returns None when no slot can usefully speculate (the
        caller takes a plain step; the stream is the same either way)."""
        ecfg = self.ecfg
        bsz = ecfg.max_batch
        # every row is written s_len tokens deep, so the width is capped
        # by the tightest slot's remaining capacity (no wrap)
        room = min(ecfg.max_len - int(self._slot_len[i])
                   for i, r in enumerate(self.slots) if r is not None)
        s_len = min(ecfg.spec_len + 1, room)
        if s_len < 2:
            return None
        kis: Dict[int, int] = {}
        streams: Dict[int, List[int]] = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            ki = min(s_len - 1, req.max_new_tokens - len(req.generated) - 1)
            if ecfg.spec_adaptive:
                ki = min(ki, int(self._spec_k[i]))
            if ki <= 0:
                continue
            kis[i] = ki
            streams[i] = [int(t) for t in req.prompt] \
                + [int(t) for t in req.generated]
        props: Dict[int, List[int]] = {}
        g_from: Dict[int, int] = {}
        n_steps = 0
        if self._draft is not None:
            scheds: Dict[int, List[int]] = {}
            for i, stream in streams.items():
                need = len(stream) - 1
                deficit = need - int(self._draft.len[i])
                if (deficit < 0 or deficit > 2 * ecfg.spec_len
                        or self._draft.len[i] == 0):
                    # too far behind (plain interludes, adopt): rebuild
                    # from the committed stream
                    self._draft.prefill_slot(i, stream[:-1])
                    deficit = 0
                scheds[i] = stream[need - deficit:]   # catch-up + pending
                g_from[i] = deficit
            outs, n_steps = self._draft.run(scheds, s_len - 1, g_from)
            props = {i: p[:kis[i]] for i, p in outs.items() if p[:kis[i]]}
        else:
            for i, stream in streams.items():
                p = ngram_propose(stream, kis[i])
                if p:
                    props[i] = p
        if not props:
            return None
        toks = np.zeros((bsz, s_len), np.int64)
        toks[:, 0] = self.next_token
        for i, p in props.items():
            toks[i, 1:1 + len(p)] = p
        fresh_by = self._prepare_pages(s_len)
        self._pin_lengths()
        self.decode_iters += 1
        logits = self._step_for("verify", s_len, (bsz, s_len), torch.long,
                                logits_slice="all")(torch.from_numpy(toks))
        g = torch.argmax(logits, dim=-1).cpu().numpy()      # (B, s_len)
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if len(req.generated) >= req.max_new_tokens:
                # budget met at insert time: finish without emitting
                req.advance(Phase.DONE)
                finished.append((req, i))
                self._retire_slot(i)
                continue
            p = props.get(i, [])
            ki = len(p)
            # the longest proposal prefix equal to greedy; g[i, a] is the
            # verifier's own next token after it (the bonus)
            a = 0
            while a < ki and int(toks[i, 1 + a]) == int(g[i, a]):
                a += 1
            self.spec_proposed += ki
            self.spec_accepted += a
            req.spec_proposed += ki
            req.spec_accepted += a
            if ki and ecfg.spec_adaptive:
                self._spec_ema[i] = 0.5 * self._spec_ema[i] + 0.5 * (a / ki)
                self._spec_k[i] = 1 + int(round(
                    self._spec_ema[i] * (ecfg.spec_len - 1)))
            if self._commit_slot(i, [int(t) for t in g[i, :a + 1]]):
                req.advance(Phase.DONE)
                finished.append((req, i))
                self._retire_slot(i)
                continue
            self._rollback_pages(i, fresh_by.get(i, []))
            if self._draft is not None and i in streams:
                # the draft's resident prefix that matches the committed
                # stream: what it was fed plus the accepted proposals it
                # consumed while drafting
                fed = n_steps - g_from[i] - 1
                self._draft.len[i] = len(streams[i]) + min(a, max(fed, 0))
        self._pin_lengths()
        return finished
