"""Per-request cache state manipulation — the port of the JAX package's
``models/kvcache.py``, on torch tensors.

* ``BlockPool`` — host-side refcounted page accounting (free at refcount
  zero; page 0 is the reserved scratch page).
* ``extract_paged_state`` / ``insert_paged_state`` — move one request
  between pools by copying only its pages: the prefill→decode hand-off
  (their cores ``gather_pages`` / ``scatter_pages`` take the physical page
  ids as a tensor).
* ``dense_to_paged`` / ``paged_to_dense`` — a whole batched cache between
  the dense and the pool layout, exactly.
* ``copy_pages`` — the copy-on-write fork inside one pool;
  ``reset_page_positions`` — invalidate recycled pages' positions.
* ``dense_state_to_paged`` / ``paged_state_to_dense`` /
  ``split_paged_state`` / ``page_payload`` / ``pages_from_payloads`` /
  ``paged_state_block`` — the hand-off wire format and the store's
  per-block payloads.
* ``extract_request_state`` / ``insert_request_state`` /
  ``blank_request_state`` — one row of a dense batched cache (the
  dense-row engines' hand-off).
* ``slice_prefix_kv`` / ``merge_prefix_kv`` — a token range of a dense
  request state: the store's per-block payloads on dense rows.
* ``layer_transfer_schedule`` — the ordered per-layer byte schedule of a
  hand-off payload (the store and the orchestrator bill it).

Layouts are the JAX ones leaf for leaf, so wire states convert through
numpy in both directions.  A cross-attention layer's ``"cross": {"k",
"v"}`` cache is a nested dict that stays slot-dense and whole, as JAX
keeps it: every helper indexes, copies and writes it per row beside the
recurrent states, and the store's per-block payloads carry it as it is.
Unlike JAX, functions that write a cache write it in place (and return
it); functions that produce a state return tensors that own their
memory, never views into a pool.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import BlockKind, ModelConfig

Cache = Dict[str, Any]
RequestState = Dict[str, Any]

# Attention-state leaves that live in the block pool.
PAGED_KEYS = ("k", "v", "pos", "k_scale", "v_scale")
# trailing (non-batch, non-seq) dims of each pageable leaf kind
_LEAF_TAIL = {"k": 2, "v": 2, "pos": 0, "k_scale": 1, "v_scale": 1}


def _leaf_fill(key: str):
    return -1 if key == "pos" else 0


def _map_groups(fn, tree: Dict[str, Any]) -> Tuple[tuple, tuple]:
    """(groups, rem) with ``fn(group_dict, batch_axis)`` applied; stacked
    groups carry a leading repeat axis (batch axis 1), remainder layers
    none (batch axis 0)."""
    return (tuple(fn(g, 1) for g in tree["groups"]),
            tuple(fn(g, 0) for g in tree["rem"]))


def _idx(axis: int, index) -> Tuple:
    return (slice(None),) * axis + (index,)


def _is_pool_leaf(key: str, a: Any, batch_axis: int, batch: int,
                  block_size: int) -> bool:
    """A pool-layout leaf (lead..., n_pages, block_size, tail...).  The
    pool always holds the scratch page, so n_pages != batch."""
    return (key in PAGED_KEYS and torch.is_tensor(a)
            and a.ndim == batch_axis + 2 + _LEAF_TAIL[key]
            and a.shape[batch_axis + 1] == block_size
            and a.shape[batch_axis] != batch)


def _is_page_leaf(key: str, a: Any, seq_axis: int, n: int,
                  block_size: int) -> bool:
    """A wire-state page leaf (lead..., n_blocks, block_size, tail...)."""
    return (key in PAGED_KEYS and torch.is_tensor(a)
            and a.ndim == seq_axis + 2 + _LEAF_TAIL[key]
            and a.shape[seq_axis] == n
            and a.shape[seq_axis + 1] == block_size)


def _tmap(fn, a):
    """``fn`` on a leaf, or on every leaf of a nested dict (a cross
    cache)."""
    return {k: _tmap(fn, v) for k, v in a.items()} \
        if isinstance(a, dict) else fn(a)


def _put(dst, src, index) -> None:
    """``dst[index] = src`` leaf by leaf (nested dicts too), in place."""
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], index)
    else:
        dst[index] = src.to(dst.device)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in _leaves(tree))


# ---------------------------------------------------------------------------
# Dense rows
# ---------------------------------------------------------------------------

def extract_request_state(cache: Cache, row: int) -> RequestState:
    """Copy of batch row ``row``'s state; groups keep their repeat dim."""
    groups, rem = _map_groups(
        lambda g, ax: {k: _tmap(lambda x: x[_idx(ax, row)].clone(), a)
                       for k, a in g.items()}, cache)
    return {"length": cache["lengths"][row].clone(), "groups": groups,
            "rem": rem}


def insert_request_state(cache: Cache, row: int,
                         st: RequestState) -> Cache:
    """Write ``st`` into batch row ``row`` (in place)."""
    cache["lengths"][row] = int(st["length"])
    for cs, ss, ax in ((cache["groups"], st["groups"], 1),
                       (cache["rem"], st["rem"], 0)):
        for c, s in zip(cs, ss):
            _put(c, s, _idx(ax, row))
    return cache


def blank_request_state(cache: Cache) -> RequestState:
    """An empty request state of the cache's structure: positions -1,
    everything else zero, length 0 — as JAX's.  Zero is not an xLSTM
    row's fresh state (its stabilizer ``m`` starts at -1e30,
    ``transformer._xlstm_state``): prefill never starts from a blanked
    row, it prefills into a fresh ``T.init_cache``."""
    st = extract_request_state(cache, 0)

    def reset(g, ax):
        return {k: _tmap(lambda a: (a.fill_(-1) if a.dtype == torch.int32
                                    and a.ndim >= 1 else a.zero_()), a)
                for k, a in g.items()}

    groups, rem = _map_groups(reset, st)
    return {"length": torch.zeros((), dtype=torch.int32), "groups": groups,
            "rem": rem}


def slice_prefix_kv(st: RequestState, start: int, end: int) -> RequestState:
    """Token range [start, end) of every attention KV of a dense request
    state (a store payload).  Only meaningful for prefix-cacheable stacks,
    whose linear caches hold token i in slot i.  The slices are copies."""
    def cut(g, ax):
        out = {}
        for k, a in g.items():
            if k in ("k", "v"):
                out[k] = a[..., start:end, :, :].clone()
            elif k == "pos":
                out[k] = a[..., start:end].clone()
            else:
                out[k] = a
        return out

    groups, rem = _map_groups(cut, st)
    return {"length": torch.tensor(end - start, dtype=torch.int32),
            "groups": groups, "rem": rem}


def merge_prefix_kv(dst: RequestState, src: RequestState,
                    offset: int) -> RequestState:
    """Write ``src``'s token range into ``dst`` from slot ``offset`` on
    (in place; the returned state's length is offset + src's)."""
    for d, sg in zip(tuple(dst["groups"]) + tuple(dst["rem"]),
                     tuple(src["groups"]) + tuple(src["rem"])):
        n = sg["pos"].shape[-1]
        for k in ("k", "v"):
            d[k][..., offset:offset + n, :, :] = sg[k].to(d[k].device)
        d["pos"][..., offset:offset + n] = sg["pos"].to(d["pos"].device)
    return {"length": torch.tensor(offset + int(src["length"]),
                                   dtype=torch.int32),
            "groups": dst["groups"], "rem": dst["rem"]}


def global_attention(cfg: ModelConfig) -> bool:
    """Pure global-attention stacks: every cache is linear over the whole
    page space (no window, no recurrent state)."""
    return (cfg.uses_kv_cache
            and cfg.sliding_window is None
            and all(b == BlockKind.ATTENTION for b in cfg.blocks()))


def prefix_cacheable(cfg: ModelConfig) -> bool:
    """The prefix store applies to stacks whose attention caches are
    linear (pure global attention, no int8 KV)."""
    return global_attention(cfg) and not cfg.kv_quant


def state_num_bytes(st: RequestState) -> int:
    """Total bytes of a request state (hand-off cost accounting)."""
    return _nbytes(st)


def page_len(tree: Dict[str, Any]) -> Optional[int]:
    """The longest attention-cache length (the page space) of a dense
    cache or request state."""
    best = 0
    for g in tuple(tree["groups"]) + tuple(tree["rem"]):
        if "pos" in g:
            best = max(best, int(g["pos"].shape[-1]))
    return best or None


# ---------------------------------------------------------------------------
# Paged pools
# ---------------------------------------------------------------------------

def _pool_batch(pcache: Cache) -> int:
    return int(pcache["block_tables"].shape[0])


def _is_dense_paged_leaf(key: str, a: Any, batch_axis: int,
                         plen: int) -> bool:
    """A dense-layout cache leaf that belongs in the block pool:
    (lead..., B, plen, tail...)."""
    return (key in PAGED_KEYS and torch.is_tensor(a)
            and a.ndim == batch_axis + 2 + _LEAF_TAIL[key]
            and a.shape[batch_axis + 1] == plen)


def dense_to_paged(cache: Cache, block_size: int) -> Cache:
    """Exact conversion of a dense batched cache into a block pool plus
    block tables: every logical block of every row gets its own page
    (row r's block j is page 1 + r * nb + j; page 0 is the scratch page),
    so ``paged_to_dense`` round-trips it bit for bit.  Returns new
    tensors."""
    batch = int(cache["lengths"].shape[0])
    plen = page_len(cache)
    if plen is None:
        raise ValueError("cache has no attention KV to page")
    if plen % block_size:
        raise ValueError(f"page length {plen} not a multiple of "
                         f"block_size {block_size}")
    nb = plen // block_size
    dev = cache["lengths"].device
    tables = (torch.arange(batch * nb, dtype=torch.int32, device=dev)
              .reshape(batch, nb) + 1)

    def conv(g, ax):
        out = {}
        for k, a in g.items():
            if _is_dense_paged_leaf(k, a, ax, plen):
                lead, tail = a.shape[:ax], a.shape[ax + 2:]
                pages = a.reshape(lead + (batch * nb, block_size) + tail)
                scratch = torch.full(lead + (1, block_size) + tail,
                                     _leaf_fill(k), dtype=a.dtype,
                                     device=a.device)
                out[k] = torch.cat([scratch, pages], dim=ax)
            else:
                out[k] = _tmap(torch.clone, a)
        return out

    groups, rem = _map_groups(conv, cache)
    return {"lengths": cache["lengths"].clone(), "block_tables": tables,
            "groups": groups, "rem": rem}


def paged_to_dense(pcache: Cache, block_size: int) -> Cache:
    """Exact inverse of ``dense_to_paged``: each row's pages gathered
    through its table, unassigned blocks (-1) as blanks (zeros, pos = -1).
    Returns new tensors."""
    tables = pcache["block_tables"]
    batch, nb = tables.shape
    plen = nb * block_size
    safe = tables.clamp_min(0).long()
    live = tables >= 0

    def conv(g, ax):
        out = {}
        for k, a in g.items():
            if _is_pool_leaf(k, a, ax, batch, block_size):
                got = a[_idx(ax, safe)]               # (..., B, nb, bs, tail)
                lshape = ((1,) * ax + (batch, nb)
                          + (1,) * (got.ndim - ax - 2))
                got = torch.where(live.reshape(lshape), got,
                                  torch.full((), _leaf_fill(k),
                                             dtype=a.dtype, device=a.device))
                out[k] = got.reshape(got.shape[:ax] + (batch, plen)
                                     + got.shape[ax + 3:])
            else:
                out[k] = _tmap(torch.clone, a)
        return out

    groups, rem = _map_groups(conv, pcache)
    return {"lengths": pcache["lengths"].clone(), "groups": groups,
            "rem": rem}


def gather_pages(pcache: Cache, idx: torch.Tensor, slot: int, length, *,
                 block_size: int) -> RequestState:
    """The pages at physical ids ``idx`` (n,) plus ``slot``'s slot-dense
    leaves, as a request state of copies (no ``n_blocks``): the core of
    ``extract_paged_state``.  Cost ∝ n pages, never the pool."""
    batch = _pool_batch(pcache)
    idx = idx.to(device=pcache["block_tables"].device, dtype=torch.long)

    def conv(g, ax):
        return {k: (a[_idx(ax, idx)] if _is_pool_leaf(k, a, ax, batch,
                                                     block_size)
                    else _tmap(lambda x: x[_idx(ax, slot)].clone(), a))
                for k, a in g.items()}

    groups, rem = _map_groups(conv, pcache)
    return {"length": torch.as_tensor(int(length), dtype=torch.int32),
            "groups": groups, "rem": rem}


def scatter_pages(pcache: Cache, st: RequestState, idx: torch.Tensor,
                  slot: int, *, block_size: int) -> Cache:
    """Write the state's pages into physical blocks ``idx`` (n,) plus its
    slot-dense leaves, ``slot``'s table row (pages at logical blocks
    0..n-1, the rest -1) and its length, in place: the core of
    ``insert_paged_state``.  Cost ∝ n pages, never the pool."""
    batch = _pool_batch(pcache)
    tables = pcache["block_tables"]
    idx = idx.to(device=tables.device, dtype=torch.long)
    for cs, ss, ax in ((pcache["groups"], st["groups"], 1),
                       (pcache["rem"], st["rem"], 0)):
        for c, s in zip(cs, ss):
            for k, a in c.items():
                at = idx if _is_pool_leaf(k, a, ax, batch, block_size) \
                    else slot
                _put(a, s[k], _idx(ax, at))
    tables[slot] = -1
    tables[slot, :idx.numel()] = idx.to(tables.dtype)
    pcache["lengths"][slot] = int(st["length"])
    return pcache


def extract_paged_state(pcache: Cache, slot: int, block_size: int, *,
                        table_row: Optional[np.ndarray] = None,
                        length=None) -> RequestState:
    """One slot's state out of a paged cache: only its pages are gathered
    (cost ∝ the request's blocks).  ``table_row`` (host mirror) and
    ``length`` default to the device table and lengths."""
    row = np.asarray(table_row if table_row is not None
                     else pcache["block_tables"][slot].cpu().numpy())
    phys = row[row >= 0]
    n = pcache["lengths"][slot] if length is None else length
    st = gather_pages(pcache, torch.as_tensor(phys, dtype=torch.long), slot,
                      n, block_size=block_size)
    st["n_blocks"] = int(len(phys))
    return st


def insert_paged_state(pcache: Cache, slot: int, st: RequestState,
                       phys_blocks: Sequence[int],
                       block_size: int) -> Cache:
    """Write a paged request state into ``slot`` (in place): its pages
    into physical blocks ``phys_blocks``, its table row (pages at logical
    blocks 0..n-1, the rest -1) and its length."""
    n = int(st["n_blocks"])
    assert len(phys_blocks) == n, (len(phys_blocks), n)
    return scatter_pages(pcache, st, torch.as_tensor(list(phys_blocks),
                                                     dtype=torch.long),
                         slot, block_size=block_size)


def reset_page_positions(pcache: Cache, phys_blocks: Sequence[int],
                         block_size: int) -> Cache:
    """Invalidate (pos = -1) the given pages' positions (in place): stale
    positions of a recycled page would alias its new owner's range."""
    batch = _pool_batch(pcache)
    idx = torch.as_tensor(list(phys_blocks), dtype=torch.long,
                          device=pcache["block_tables"].device)

    def conv(g, ax):
        a = g.get("pos")
        if a is not None and _is_pool_leaf("pos", a, ax, batch, block_size):
            a[_idx(ax, idx)] = -1
        return g

    _map_groups(conv, pcache)
    return pcache


def copy_pages(pcache: Cache, src: Sequence[int], dst: Sequence[int], *,
               block_size: int) -> Cache:
    """Copy-on-write fork (in place): duplicate pages ``src`` into
    ``dst`` across every pool leaf; only the destinations are written."""
    batch = _pool_batch(pcache)
    dev = pcache["block_tables"].device
    si = torch.as_tensor(list(src), dtype=torch.long, device=dev)
    di = torch.as_tensor(list(dst), dtype=torch.long, device=dev)

    def conv(g, ax):
        for k, a in g.items():
            if _is_pool_leaf(k, a, ax, batch, block_size):
                a[_idx(ax, di)] = a[_idx(ax, si)]
        return g

    _map_groups(conv, pcache)
    return pcache


class BlockPool:
    """Host-side refcounted page accounting for one paged block pool.

    A page's refcount counts its holders: slot block-table references
    plus Global-KV-Store holds.  ``alloc`` hands out exclusive pages
    (refcount 0 → 1), ``ref`` adds a holder to a live page (the zero-copy
    bind), ``unref`` drops one — a page returns to the free list only when
    the last holder lets go.  Pages below ``n_reserved`` (the scratch page)
    are never allocated or refcounted.
    """

    def __init__(self, n_pages: int, n_reserved: int = 1):
        assert n_pages > n_reserved >= 0
        self.n_pages = n_pages
        self.n_reserved = n_reserved
        self.refcount = np.zeros(n_pages, np.int32)
        # descending so .pop() hands out low pages first
        self.free_list: List[int] = list(range(n_pages - 1,
                                               n_reserved - 1, -1))
        self.peak_used = 0

    @property
    def used(self) -> int:
        """Live (refcount > 0) pages."""
        return self.n_pages - self.n_reserved - len(self.free_list)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` exclusive pages off the free list (refcount 1)."""
        assert len(self.free_list) >= n, "block pool exhausted"
        pages = [self.free_list.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0
            self.refcount[p] = 1
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def ref(self, pages: Sequence[int]) -> None:
        """Add one holder to each (live) page — the zero-copy bind."""
        for p in pages:
            assert self.refcount[p] > 0, f"ref of dead page {p}"
            self.refcount[p] += 1

    def unref(self, pages: Sequence[int]) -> List[int]:
        """Drop one holder from each page; pages that hit refcount zero
        return to the free list and are reported back."""
        freed = []
        for p in pages:
            assert self.refcount[p] > 0, f"unref of free page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free_list.append(p)
                freed.append(p)
        return freed

    def check(self, holders: Optional[Sequence[Sequence[int]]] = None
              ) -> None:
        """Conservation invariant: every page is reserved, free (refcount
        0) or live (refcount > 0), with no duplicates on the free list.
        With ``holders`` also checks each page's refcount equals its
        holder count."""
        free = set(self.free_list)
        assert len(free) == len(self.free_list), "duplicate free pages"
        for p in range(self.n_reserved):
            assert self.refcount[p] == 0 and p not in free
        for p in range(self.n_reserved, self.n_pages):
            assert (self.refcount[p] == 0) == (p in free), \
                f"page {p}: refcount {self.refcount[p]} vs free list"
        assert len(self.free_list) + self.used \
            == self.n_pages - self.n_reserved
        if holders is not None:
            counts = np.zeros(self.n_pages, np.int64)
            for pages in holders:
                for p in pages:
                    counts[p] += 1
            assert np.array_equal(counts, self.refcount.astype(np.int64)), \
                "refcounts do not match holder lists"


# ---------------------------------------------------------------------------
# Wire format and store payloads
# ---------------------------------------------------------------------------

def split_paged_state(st: RequestState, n_head_blocks: int,
                      block_size: int) -> RequestState:
    """Drop the first ``n_head_blocks`` pages of a paged wire state (they
    are bound by reference in the destination pool).  ``length`` stays the
    full request length."""
    n = int(st["n_blocks"])
    assert 0 <= n_head_blocks <= n, (n_head_blocks, n)
    if n_head_blocks == 0:
        return st
    groups, rem = _map_groups(
        lambda g, ax: {k: (a[_idx(ax, slice(n_head_blocks, None))]
                           if _is_page_leaf(k, a, ax, n, block_size) else a)
                       for k, a in g.items()}, st)
    return {"length": st["length"], "n_blocks": n - n_head_blocks,
            "groups": groups, "rem": rem}


def page_payload(pcache: Cache, page: int, block_size: int) -> RequestState:
    """One physical page's KV as a per-block store payload (the shape
    ``paged_state_block`` yields) — the store's copy-out of a page."""
    batch = _pool_batch(pcache)
    groups, rem = _map_groups(
        lambda g, ax: {k: a[_idx(ax, page)].clone() for k, a in g.items()
                       if _is_pool_leaf(k, a, ax, batch, block_size)},
        pcache)
    return {"length": torch.tensor(block_size, dtype=torch.int32),
            "groups": groups, "rem": rem}


def pages_from_payloads(payloads: Sequence[RequestState],
                        length: int) -> RequestState:
    """Stack per-block store payloads into a paged wire state — the
    store-hit entry of the paged incremental prefill."""
    assert payloads, "no payloads to page"

    def conv(gs, ax):
        out = {}
        for k, a in gs[0].items():
            if (k in PAGED_KEYS and torch.is_tensor(a)
                    and a.ndim == ax + 1 + _LEAF_TAIL[k]):
                out[k] = torch.stack([g[k] for g in gs], dim=ax)
            else:
                out[k] = a
        return out

    n_g = len(payloads[0]["groups"])
    n_r = len(payloads[0]["rem"])
    return {"length": torch.tensor(int(length), dtype=torch.int32),
            "n_blocks": len(payloads),
            "groups": tuple(conv([p["groups"][i] for p in payloads], 1)
                            for i in range(n_g)),
            "rem": tuple(conv([p["rem"][i] for p in payloads], 0)
                         for i in range(n_r))}


def paged_state_block(st: RequestState, block: int,
                      block_size: int) -> RequestState:
    """Page ``block`` of a paged wire state as a per-block store payload."""
    n = int(st["n_blocks"])
    assert 0 <= block < n, (block, n)
    groups, rem = _map_groups(
        lambda g, ax: {k: (a[_idx(ax, block)].clone()
                           if _is_page_leaf(k, a, ax, n, block_size) else a)
                       for k, a in g.items()}, st)
    return {"length": torch.tensor(block_size, dtype=torch.int32),
            "groups": groups, "rem": rem}


def dense_state_to_paged(st: RequestState, block_size: int, *,
                         length: Optional[int] = None) -> RequestState:
    """Reshape a dense request state into its used pages; blocks past the
    used prefix are dropped (masked junk the decoder overwrites)."""
    n_tok = int(st["length"] if length is None else length)
    plen = page_len(st)
    if plen is None:
        raise ValueError("request state has no attention KV to page")
    nb_slot = plen // block_size
    n_used = min(max(-(-n_tok // block_size), 0), nb_slot)

    def conv(g, ax):
        out = {}
        for k, a in g.items():
            if (k in PAGED_KEYS and torch.is_tensor(a)
                    and a.ndim == ax + 1 + _LEAF_TAIL[k]
                    and a.shape[ax] == plen):
                pages = a.reshape(a.shape[:ax] + (nb_slot, block_size)
                                  + a.shape[ax + 1:])
                out[k] = pages[_idx(ax, slice(0, n_used))].clone()
            else:
                out[k] = a
        return out

    groups, rem = _map_groups(conv, st)
    return {"length": torch.tensor(n_tok, dtype=torch.int32),
            "n_blocks": n_used, "groups": groups, "rem": rem}


def paged_state_to_dense(ps: RequestState, block_size: int,
                         plen: int) -> RequestState:
    """Inverse of ``dense_state_to_paged``: pad back out to the full page
    space with blanks (zeros, pos = -1)."""
    nb_slot = plen // block_size
    n = int(ps["n_blocks"])

    def conv(g, ax):
        out = {}
        for k, a in g.items():
            if _is_page_leaf(k, a, ax, n, block_size):
                full = torch.full(a.shape[:ax] + (nb_slot,) + a.shape[ax + 1:],
                                  _leaf_fill(k), dtype=a.dtype,
                                  device=a.device)
                full[_idx(ax, slice(0, n))] = a
                out[k] = full.reshape(a.shape[:ax] + (plen,)
                                      + a.shape[ax + 2:])
            else:
                out[k] = a
        return out

    groups, rem = _map_groups(conv, ps)
    return {"length": ps["length"], "groups": groups, "rem": rem}


def layer_transfer_schedule(st: RequestState,
                            base_layer: int = 0) -> List[Tuple[int, int]]:
    """Ordered per-layer (layer_index, nbytes) schedule of a hand-off
    payload in stack execution order (repeats, pattern positions within a
    repeat, remainder layers last)."""
    sched: List[Tuple[int, int]] = []
    groups = tuple(st["groups"])
    n_rep = 0
    if groups:
        arrs = _leaves(groups[0])
        n_rep = int(arrs[0].shape[0]) if arrs else 0
        per_g = [_nbytes(g) // max(n_rep, 1) for g in groups]
        for r in range(n_rep):
            for gi, nbytes in enumerate(per_g):
                sched.append((base_layer + r * len(groups) + gi, nbytes))
    base = base_layer + n_rep * len(groups)
    for i, g in enumerate(st["rem"]):
        sched.append((base + i, _nbytes(g)))
    return sched
