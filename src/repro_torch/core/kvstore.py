"""Global KV Cache Store (§4.2).

A cluster-wide, block-granular prefix KV cache shared by every prefill
instance.  Routing therefore never needs to consider cache placement
(Algorithm 2), which is the paper's central decoupling.

Design
------
* **Block granularity**: token streams are chunked into ``block_size``-token
  blocks; a block's identity is the hash chain ``h_i = H(h_{i-1}, tokens_i)``
  so a block hit implies the whole prefix matches (content addressing, same
  scheme as vLLM/Mooncake).
* **Radix-style longest-prefix lookup**: ``match(tokens)`` walks the hash
  chain until the first miss — O(#blocks) with one dict probe per block.
* **Tiers**: HBM / HOST / SSD with byte capacities and bandwidths.  Payloads
  are request-state trees of torch tensors (per-block KV slices) for serving
  tests; capacity accounting and transfer-latency estimates use the paper's
  Eq. 13.  LRU eviction demotes HBM→HOST→SSD→drop.
* **Layer-wise overlapped fetch** is modelled by ``core.pipeline`` — the
  store exposes per-layer transfer times so the engine can charge only the
  non-overlapped residual (Eq. 12–17).
* **Zero-copy residency**: an entry may point at a *physical page* of a
  registered decode block pool instead of carrying a payload copy
  (``register_pages``).  The store then holds one refcount on the page
  (``models.kvcache.BlockPool``); decode slots bind the same page by
  reference (``resident_prefix``) so a hot prefix costs HBM once.  The
  host/ssd tiers stay *backing* levels: under pool pressure
  (``reclaim_pool``) or instance teardown (``detach_pool``) the LRU
  pool-resident entries are demoted — the page is copied out of HBM
  (billed at the backing tier's bandwidth) and freed at refcount zero —
  and promotion on a later hit is billed through the overlapped fetch
  path exactly as payload fetches are today.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _hash_block(prev: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(np.ascontiguousarray(tokens.astype(np.int32)).tobytes())
    return h.digest()


def chain_hashes(tokens: Sequence[int], block_size: int) -> List[bytes]:
    toks = np.asarray(tokens, np.int32)
    out, prev = [], b"root"
    for i in range(0, len(toks) - len(toks) % block_size, block_size):
        prev = _hash_block(prev, toks[i:i + block_size])
        out.append(prev)
    return out


def leading_block_key(tokens: Sequence[int],
                      block_size: int) -> Optional[bytes]:
    """Hash of the first full block, or None — the locality signal shared
    by the prefix-aware router and the engines' published-prefix records."""
    if len(tokens) < block_size:
        return None
    return chain_hashes(tokens[:block_size], block_size)[0]


@dataclasses.dataclass
class TierSpec:
    name: str
    capacity_bytes: int
    bandwidth_gbps: float           # to/from GPU, GB/s


DEFAULT_TIERS = (
    TierSpec("hbm", 4 << 30, 819.0),         # on-device residency
    TierSpec("host", 64 << 30, 25.0),        # PCIe/DMA (200 Gbps, Eq. 17)
    TierSpec("ssd", 512 << 30, 3.0),
)


@dataclasses.dataclass
class StoreStats:
    lookups: int = 0
    hit_blocks: int = 0
    miss_blocks: int = 0
    inserts: int = 0
    evictions: int = 0
    bytes_fetched: int = 0
    # zero-copy sharing accounting
    registered_blocks: int = 0     # payload entries converted to page refs
    bound_blocks: int = 0          # pages handed out for by-reference binds
    demotions: int = 0             # pages copied out of HBM to backing tiers
    bytes_demoted: int = 0
    # decode-preemption traffic (fair-share swap policy): victims' KV
    # pages demoted to the first backing tier and promoted back on resume
    swaps_out: int = 0
    swaps_in: int = 0
    bytes_swapped: int = 0

    @property
    def hit_rate(self) -> float:
        tot = self.hit_blocks + self.miss_blocks
        return self.hit_blocks / tot if tot else 0.0


class _Entry:
    __slots__ = ("payload", "nbytes", "tier", "n_tokens", "sched",
                 "pool", "page")

    def __init__(self, payload: Any, nbytes: int, tier: int, n_tokens: int):
        self.payload = payload
        self.nbytes = nbytes
        self.tier = tier
        self.n_tokens = n_tokens
        self.sched = None      # memoized per-layer byte schedule (or ())
        self.pool = None       # pool id when page-resident (zero-copy)
        self.page = None       # physical page index in that pool


class GlobalKVStore:
    """Cluster-wide prefix KV cache with tiered capacity + LRU eviction."""

    def __init__(self, block_size: int = 16,
                 tiers: Sequence[TierSpec] = DEFAULT_TIERS):
        self.block_size = block_size
        self.tiers = list(tiers)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._tier_used = [0 for _ in self.tiers]
        self._pools: Dict[str, Any] = {}   # pool id -> registered pool
        self.stats = StoreStats()
        self.demote_latency_s = 0.0        # modelled HBM->backing copies
        self.swap_latency_s = 0.0          # modelled preemption swap traffic

    # -- lookup ----------------------------------------------------------
    def match(self, tokens: Sequence[int], record_stats: bool = True,
              keys: Optional[List[bytes]] = None,
              touch: Optional[bool] = None) -> Tuple[int, List[bytes]]:
        """Longest cached prefix of ``tokens``.

        Returns (n_matched_tokens, matched_block_keys).  Pass
        ``record_stats=False`` for tentative probes (e.g. batch planning)
        so repeated lookups for one request don't distort hit-rate stats;
        ``touch`` controls the LRU recency bump and defaults to
        ``record_stats`` — a tentative probe must not perturb eviction
        order either.  Pass precomputed ``keys`` to skip re-hashing the
        prompt."""
        if keys is None:
            keys = chain_hashes(tokens, self.block_size)
        touch = record_stats if touch is None else touch
        matched: List[bytes] = []
        for k in keys:
            if k in self._entries:
                matched.append(k)
                if touch:
                    self._entries.move_to_end(k)    # LRU touch
            else:
                break
        if record_stats:
            self.stats.lookups += 1
            self.stats.hit_blocks += len(matched)
            self.stats.miss_blocks += len(keys) - len(matched)
        return len(matched) * self.block_size, matched

    def fetch(self, keys: Sequence[bytes],
              t_layer_compute: Optional[float] = None
              ) -> Tuple[List[Any], float]:
        """Payloads for ``keys`` + modelled fetch latency (s) given each
        block's current tier (Eq. 13: S_kv·L/B per tier).

        With ``t_layer_compute`` the fetch is charged as the §4.2
        layer-wise overlapped transmission instead: each block's bytes are
        split over its payload's ordered per-layer schedule
        (``models.kvcache.layer_transfer_schedule``) and only the
        non-overlapped residual — the pipeline makespan minus the compute
        that runs regardless (Eq. 12–17) — is billed, so a fetch hidden
        under per-layer compute costs ~nothing."""
        payloads, latency = [], 0.0
        per_layer: Dict[int, float] = {}
        for k in keys:
            e = self._entries[k]
            if e.pool is not None:
                # page-resident: materialize a copy out of the live pool
                # (HBM-tier read; the page itself stays shared in place)
                payloads.append(self._pools[e.pool].materialize(e.page))
            else:
                payloads.append(e.payload)
            bw = self.tiers[e.tier].bandwidth_gbps * 1e9
            sched = (self._layer_schedule(e, payloads[-1])
                     if t_layer_compute is not None else None)
            if sched:
                # seconds per layer: the block's accounted bytes, split
                # over the per-layer schedule at this block's tier bw
                tot = sum(b for _, b in sched) or 1
                for layer, nb in sched:
                    per_layer[layer] = per_layer.get(layer, 0.0) \
                        + e.nbytes * (nb / tot) / bw
            else:
                latency += e.nbytes / bw
            self.stats.bytes_fetched += e.nbytes
            if e.tier != 0 and e.pool is None:       # promote to HBM tier
                self._move_tier(k, e, 0)
        if per_layer:
            from ..core.analytical import overlapped_schedule_time
            seconds = [per_layer[i] for i in sorted(per_layer)]
            # residual stall: makespan minus the compute baseline (the
            # schedule is already in seconds: unit bandwidth)
            t = t_layer_compute or 0.0
            latency += max(0.0, overlapped_schedule_time(
                seconds, 1.0, t, t_sync=0.0) - len(seconds) * t)
        return payloads, latency

    @staticmethod
    def _layer_schedule(e: _Entry, payload: Any):
        """Memoized ordered per-layer byte schedule of an entry's payload;
        () for opaque (non request-state) payloads.  ``payload`` is passed
        in because page-resident entries materialize theirs per fetch (the
        schedule shape is stable, so memoizing on the entry stays valid)."""
        if e.sched is None:
            sched = ()
            if isinstance(payload, dict) and "groups" in payload:
                # imported here: models.kvcache needs torch, the store
                # itself does not.  No blanket except: a failure must not
                # silently bill the fetch at zero latency.
                from ..models.kvcache import layer_transfer_schedule
                sched = tuple(layer_transfer_schedule(payload))
            e.sched = sched
        return e.sched

    # -- insert ----------------------------------------------------------
    def insert(self, tokens: Sequence[int], payloads: Sequence[Any],
               nbytes_per_block: int,
               keys: Optional[List[bytes]] = None) -> List[bytes]:
        """Insert per-block payloads for the (full-block) prefix of tokens."""
        if keys is None:
            keys = chain_hashes(tokens, self.block_size)
        n = min(len(keys), len(payloads))
        out = []
        for k, p in zip(keys[:n], payloads[:n]):
            if k in self._entries:
                self._entries.move_to_end(k)
                out.append(k)
                continue
            if not self._make_room(0, nbytes_per_block):
                # nothing left to evict (block bigger than the tier, or
                # the survivors are pinned): caching is best-effort, so
                # drop the block instead of over-filling the tier — and
                # stop here, later blocks of this chain would be
                # unreachable behind the gap anyway
                break
            self._entries[k] = _Entry(p, nbytes_per_block, 0, self.block_size)
            self._tier_used[0] += nbytes_per_block
            self.stats.inserts += 1
            out.append(k)
        return out

    # -- zero-copy page residency (refcounted pool sharing) ---------------
    def attach_pool(self, pool_id: str, pool: Any) -> None:
        """Register a block pool the store may hold page references into.
        ``pool`` must expose ``ref_pages(pages)``, ``unref_pages(pages) ->
        freed`` and ``materialize(page) -> payload`` (the decode engines
        do)."""
        self._pools[pool_id] = pool

    def register_pages(self, keys: Sequence[bytes], pool_id: str,
                       pages: Sequence[int]) -> int:
        """Re-point existing payload entries at live pool pages (refcount
        ++ per page; the payload copy is dropped and its HBM-tier bytes
        freed).  First registration wins — an entry already page-resident
        (this pool or another) is left alone, so at most one pool ever
        backs a key.  Returns the number of entries converted."""
        pool = self._pools[pool_id]
        n = 0
        for k, p in zip(keys, pages):
            e = self._entries.get(k)
            if e is None or e.pool is not None:
                continue
            pool.ref_pages([int(p)])
            self._tier_used[e.tier] -= e.nbytes
            e.payload = None
            e.sched = None
            e.tier = 0
            e.pool = pool_id
            e.page = int(p)
            self.stats.registered_blocks += 1
            n += 1
        return n

    def resident_prefix(self, keys: Sequence[bytes],
                        pool_id: str) -> List[int]:
        """Physical pages of the longest prefix of ``keys`` resident in
        ``pool_id`` — the zero-copy bind lookup (no bytes move; the caller
        refs the pages when it binds them).  Touches matched entries'
        recency like a real hit."""
        pages: List[int] = []
        for k in keys:
            e = self._entries.get(k)
            if e is None or e.pool != pool_id:
                break
            pages.append(e.page)
            self._entries.move_to_end(k)
        self.stats.bound_blocks += len(pages)
        return pages

    def pool_pages(self, pool_id: str) -> Dict[bytes, int]:
        """key -> page for every entry resident in ``pool_id`` (leak
        checks: these are exactly the store's refcount holds)."""
        return {k: e.page for k, e in self._entries.items()
                if e.pool == pool_id}

    def _demote_resident(self, key: bytes, e: _Entry) -> bool:
        """Copy a page-resident entry out of HBM into the first backing
        tier (payload form) and drop the store's page hold — the page
        frees at refcount zero.  Returns True when the pool page was
        actually freed (it may survive under slot holds)."""
        pool = self._pools[e.pool]
        payload = pool.materialize(e.page)
        freed = pool.unref_pages([e.page])
        e.pool = None
        e.page = None
        e.payload = payload
        e.sched = None
        self.stats.demotions += 1
        self.stats.bytes_demoted += e.nbytes
        if len(self.tiers) > 1 and self._make_room(1, e.nbytes, skip=key):
            e.tier = 1
            self._tier_used[1] += e.nbytes
            self.demote_latency_s += e.nbytes / (
                self.tiers[1].bandwidth_gbps * 1e9)
        else:
            # no backing tier (or no room even after its evictions): the
            # demotion is an eviction — never over-fill a tier
            del self._entries[key]
            self.stats.evictions += 1
        return bool(freed)

    def reclaim_pool(self, pool_id: str, n_pages: int) -> int:
        """Free up to ``n_pages`` pages of ``pool_id`` by demoting the
        LRU page-resident entries to the backing tiers (the pool-pressure
        path: a decode allocation that cannot find free pages evicts the
        store's holds first).  Returns pages actually freed — an entry
        whose page other slots still hold frees nothing yet."""
        freed = 0
        for k in list(self._entries):                # LRU order
            if freed >= n_pages:
                break
            e = self._entries.get(k)
            if e is not None and e.pool == pool_id:
                freed += bool(self._demote_resident(k, e))
        return freed

    def detach_pool(self, pool_id: str) -> int:
        """Demote every entry resident in ``pool_id`` and forget the pool
        (instance teardown / role re-roll: the pool's pages are about to
        be destroyed, so the store must stop referencing them).  Returns
        the number of entries demoted."""
        if pool_id not in self._pools:
            return 0
        n = 0
        for k in list(self._entries):
            e = self._entries.get(k)
            if e is not None and e.pool == pool_id:
                self._demote_resident(k, e)
                n += 1
        del self._pools[pool_id]
        return n

    # -- preemption swap billing (fair-share decode preemption) -----------
    def _swap_bandwidth(self) -> float:
        """Bytes/s of the HBM<->backing boundary a preemption swap
        crosses: the first backing tier's bandwidth (HBM-only stores fall
        back to tier 0)."""
        spec = self.tiers[1] if len(self.tiers) > 1 else self.tiers[0]
        return spec.bandwidth_gbps * 1e9

    def swap_out(self, nbytes: int) -> float:
        """Bill a preempted request's gathered KV state demoted to the
        host tier; returns the modelled transfer seconds (the victim's
        resume cannot start before its pages are out)."""
        t = nbytes / self._swap_bandwidth()
        self.stats.swaps_out += 1
        self.stats.bytes_swapped += nbytes
        self.swap_latency_s += t
        return t

    def swap_in(self, nbytes: int) -> float:
        """Bill the promotion back to HBM when a swapped victim resumes;
        returns the modelled transfer seconds (delays the resume kick)."""
        t = nbytes / self._swap_bandwidth()
        self.stats.swaps_in += 1
        self.swap_latency_s += t
        return t

    # -- internals -------------------------------------------------------
    def _move_tier(self, key: bytes, e: _Entry, tier: int) -> bool:
        """Re-tier an entry; False (entry stays put) when the target tier
        cannot make room even after its own evictions."""
        self._tier_used[e.tier] -= e.nbytes
        if not self._make_room(tier, e.nbytes, skip=key):
            self._tier_used[e.tier] += e.nbytes
            return False
        e.tier = tier
        self._tier_used[tier] += e.nbytes
        return True

    def _make_room(self, tier: int, nbytes: int,
                   skip: Optional[bytes] = None) -> bool:
        """Demote LRU entries of ``tier`` until ``nbytes`` fit, cascading
        down-tier.  Page-resident entries occupy the POOL's HBM, not the
        store's tier budget, so they are never byte victims — but before
        declaring tier 0 out of room they ARE demoted (LRU first), so a
        tier whose surviving entries are all pool-resident sheds its page
        holds instead of letting callers silently over-fill.  Returns
        False when the bytes still don't fit; callers must not add them
        (``used_bytes(tier) <= capacity_bytes`` is an invariant)."""
        while self._tier_used[tier] + nbytes > self.tiers[tier].capacity_bytes:
            victim = None
            for k, e in self._entries.items():       # LRU order = insertion
                if e.tier == tier and k != skip and e.pool is None:
                    victim = (k, e)
                    break
            if victim is None:
                resident = None
                if tier == 0:
                    for k, e in self._entries.items():
                        if e.pool is not None and k != skip:
                            resident = (k, e)
                            break
                if resident is None:
                    return False
                self._demote_resident(*resident)
                continue
            vk, ve = victim
            if tier + 1 < len(self.tiers) and self._move_tier(vk, ve,
                                                              tier + 1):
                continue
            self._tier_used[ve.tier] -= ve.nbytes
            del self._entries[vk]
            self.stats.evictions += 1
        return True

    # -- introspection ----------------------------------------------------
    def __len__(self):
        return len(self._entries)

    def used_bytes(self, tier: Optional[int] = None) -> int:
        if tier is None:
            return sum(self._tier_used)
        return self._tier_used[tier]
