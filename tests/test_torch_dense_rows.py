"""The port's dense-row engine against the JAX package: the dense and
wire-format helpers of ``models/kvcache.py``, and TINY served on dense
rows (``max_len`` 100 with 8-token blocks: the page space is not a
multiple of the block, so both engines serve dense rows, as JAX's do).

On dense rows a one-token decode step runs kernel B5 (its plain version
here), a store hit merges ``slice_prefix_kv`` payloads into the row,
states cross engines and span stages as rows, and verify steps run plain
attention over the rows.

Every input is made with numpy or JAX's ``init`` from a seed and handed to
both sides.  Tolerances: helper outputs equal (pure copies), states and
logits 1e-4 (float32, summed in another order), token streams exactly.
About 55 s on one CPU worker, most of it the JAX greedy reference and
JAX's engines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.core.kvstore import GlobalKVStore as JStore
from repro.models import kvcache as JKC
from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JDecode
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch import configs as port_configs
from repro_torch.core.kvstore import GlobalKVStore
from repro_torch.kernels import ops
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax, tree_from_numpy
from repro_torch.serving import engine as E
from repro_torch.serving.api import Server
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request

PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
ECFG = EngineConfig(max_len=100, max_batch=3, block_size=8)
JECFG = JEngineConfig(max_len=100, max_batch=3, block_size=8)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tp(tiny_params):
    return params_from_jax(PTINY, jax.tree.map(np.asarray, tiny_params),
                           device="cpu")


def _prompts(seed=0, n=3):
    """Prompts behind one 24-token shared prefix (3 blocks)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 128, 24, dtype=np.int32)
    return [np.concatenate([shared, rng.integers(0, 128, 9 + 3 * i,
                                                 dtype=np.int32)])
            for i in range(n)]


def _requests(prompts, max_new=6, cls=Request):
    return [cls(rid=i, arrival=0.0, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(got, want, tol=None):
    """A port tree against a JAX one, leaf for leaf (keys too)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k], tol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w, tol)
        return
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape
    if tol is None or not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# The kvcache helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def filled(tiny_params):
    """A JAX dense cache of 2 rows x 32 slots, prefilled with 19 and 27
    tokens (the rest blank), and the same cache in the port."""
    toks = np.random.default_rng(4).integers(0, 128, (2, 27))
    cache = JT.init_cache(TINY, 2, 32)
    _, cache, _ = JT.prefill(TINY, tiny_params, jnp.asarray(toks), cache)
    pos = np.asarray(cache["groups"][0]["pos"]).copy()
    pos[:, 0, 19:] = -1                 # row 0 holds 19 tokens
    cache["groups"][0]["pos"] = jnp.asarray(pos)
    cache["lengths"] = jnp.asarray([19, 27], jnp.int32)
    return cache, tree_from_numpy(_np(cache), device="cpu")


def test_blank_and_prefix_slices_equal_jax(filled):
    """``blank_request_state``, ``slice_prefix_kv`` (a store block) and
    ``merge_prefix_kv`` (the blocks back into a blank row)."""
    jcache, cache = filled
    _assert_tree_equal(KC.blank_request_state(cache),
                       _np(JKC.blank_request_state(jcache)))
    jst = JKC.extract_request_state(jcache, 1)
    st = KC.extract_request_state(cache, 1)
    blocks = [(0, 8), (8, 16), (16, 24)]
    jpl = [JKC.slice_prefix_kv(jst, a, b) for a, b in blocks]
    pl = [KC.slice_prefix_kv(st, a, b) for a, b in blocks]
    for g, w in zip(pl, jpl):
        _assert_tree_equal(g, _np(w))
    jdst, dst = JKC.blank_request_state(jcache), \
        KC.blank_request_state(cache)
    for (a, _), g, w in zip(blocks, pl, jpl):
        jdst = JKC.merge_prefix_kv(jdst, w, a)
        dst = KC.merge_prefix_kv(dst, g, a)
    _assert_tree_equal(dst, _np(jdst))
    assert int(dst["length"]) == 24


def test_dense_paged_conversions_equal_jax(filled):
    """``dense_to_paged`` / ``paged_to_dense`` (a bit-exact round trip),
    ``gather_pages`` and ``scatter_pages`` of one row's pages."""
    jcache, cache = filled
    jp = JKC.dense_to_paged(jcache, 8)
    pc = KC.dense_to_paged(cache, 8)
    _assert_tree_equal(pc, _np(jp))
    back = KC.paged_to_dense(pc, 8)
    _assert_tree_equal(back, _np(JKC.paged_to_dense(jp, 8)))
    _assert_tree_equal(back, _np({k: jcache[k] for k in
                                  ("lengths", "groups", "rem")}))
    idx = np.asarray([5, 6, 7], np.int32)          # row 1's first 3 pages
    jst = JKC.gather_pages(jp, jnp.asarray(idx), 1, 24, block_size=8)
    st = KC.gather_pages(pc, torch.as_tensor(idx), 1, 24, block_size=8)
    _assert_tree_equal(st, _np(jst))
    # scatter row 1's pages into row 0's first pages of a blank pool
    jblank = JKC.dense_to_paged(JT.init_cache(TINY, 2, 32), 8)
    blank = KC.dense_to_paged(T.init_cache(PTINY, 2, 32, device="cpu"), 8)
    tgt = np.asarray([1, 2, 3], np.int32)
    jout = JKC.scatter_pages(jblank, jst, jnp.asarray(tgt), 0, block_size=8)
    out = KC.scatter_pages(blank, st, torch.as_tensor(tgt), 0, block_size=8)
    _assert_tree_equal(out, _np(jout))


# ---------------------------------------------------------------------------
# Serving on dense rows
# ---------------------------------------------------------------------------

def test_dense_rows_are_chosen_and_other_stacks_still_raise(tp):
    pe = PrefillEngine(PTINY, tp, ECFG, device="cpu")
    de = DecodeEngine(PTINY, tp, ECFG, device="cpu")
    assert pe._page_len is None and not de.paged and de.pool is None
    assert "block_tables" not in de.cache
    assert tuple(de.cache["groups"][0]["k"].shape) == (4, 3, 100, 2, 16)
    with pytest.raises(ValueError, match="page sharing"):
        de.attach_store(GlobalKVStore(block_size=8))
    # a 16-token sliding window pages at its ring (16 % 8 == 0), as JAX's
    # _paged_page_len; the xLSTM stack, which holds no attention, serves
    # on dense rows at any max_len (its states are rows)
    swa = DecodeEngine(dataclasses.replace(PTINY, sliding_window=16), tp,
                       ECFG, device="cpu")
    assert swa.paged and swa.page_len == 16
    xl = DecodeEngine(port_configs.get("xlstm-350m").smoke(), tp,
                      dataclasses.replace(ECFG, max_len=96), device="cpu")
    assert not xl.paged and xl.pool is None
    assert "block_tables" not in xl.cache
    assert tuple(xl.cache["groups"][0]["C"].shape) == (1, 3, 4, 64, 64)


@pytest.mark.parametrize("chunk", [None, 10])
def test_server_on_dense_rows_equals_greedy_reference(tp, tiny_params,
                                                      greedy_reference,
                                                      chunk):
    """Route → (chunked) prefill with store hits merged into dense rows →
    dense hand-off → B5 decode: every stream equals the greedy rollout."""
    reqs = _requests(_prompts(), max_new=6)
    orch = Orchestrator(PTINY, tp, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ECFG, chunk_tokens=chunk),
        device="cpu")
    ops.reset_launches()
    calls = []
    orig = ops.decode_attention

    def count(*a, **kw):
        calls.append(a[1].shape)
        return orig(*a, **kw)

    L.ops.decode_attention = count
    try:
        summary = Server(orch).run(reqs)
    finally:
        L.ops.decode_attention = orig
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED
        assert r.generated == greedy_reference(TINY, tiny_params, r.prompt,
                                               6), r.rid
    assert any(r.cached_tokens > 0 for r in reqs)
    assert summary["store_hit_rate"] > 0 and summary["pages_bound"] == 0
    assert not orch.decode_units()[0].paged
    # every decode step's attention went through B5 over whole rows
    assert calls and all(s == (3, 100, 2, 16) for s in calls)


def test_dense_rows_match_jax_engines(tp, tiny_params):
    """JAX's own PrefillEngine + DecodeEngine on dense rows (store hits
    included) and the port's: the same hand-off states, logits and
    streams."""
    jreqs = _requests(_prompts(1), max_new=7, cls=JRequest)
    reqs = _requests(_prompts(1), max_new=7)
    jpe = JPrefill(TINY, tiny_params, JECFG, JStore(block_size=8))
    pe = PrefillEngine(PTINY, tp, ECFG, GlobalKVStore(block_size=8),
                       device="cpu")
    jde = JDecode(TINY, tiny_params, JECFG)
    de = DecodeEngine(PTINY, tp, ECFG, device="cpu")
    assert not jde.paged
    for jr, r in zip(jreqs, reqs):          # one by one: later ones hit
        (jst, jlg), = jpe.run_batch([jr])
        (st, lg), = pe.run_batch([r])
        assert r.cached_tokens == jr.cached_tokens
        assert "n_blocks" not in st and "n_blocks" not in jst
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _assert_tree_equal(st, _np(jst), TOL)
        jde.insert(jr, jst, int(jnp.argmax(jlg)))
        de.insert(r, st, int(torch.argmax(lg)))
    assert reqs[1].cached_tokens == 24
    while jde.active:
        jde.step()
    while de.active:
        de.step()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


def test_dense_slot_extract_and_insert(tp, tiny_params, greedy_reference):
    """A slot moved mid-stream between two dense engines (extract, then
    adopt, as a KV_HEADS rebalance moves it) keeps the greedy rollout,
    the moved one and those it joins."""
    pe = PrefillEngine(PTINY, tp, ECFG, device="cpu")
    e0 = DecodeEngine(PTINY, tp, ECFG, name="d0", device="cpu")
    e1 = DecodeEngine(PTINY, tp, ECFG, name="d1", device="cpu")
    reqs = _requests(_prompts(2), max_new=8)
    for r, eng, (st, lg) in zip(reqs, (e0, e0, e1), pe.run_batch(reqs)):
        eng.insert(r, st, int(torch.argmax(lg)))
    for _ in range(3):
        e0.step()
        e1.step()
    req, st, tok = e0.extract_slot(0)
    assert e0.slots[0] is None and int(st["length"]) == \
        len(req.prompt) + len(req.generated) - 1
    e1.adopt(req, st, tok)
    while e0.active or e1.active:
        e0.step()
        e1.step()
    for r in reqs:
        assert r.generated == greedy_reference(TINY, tiny_params, r.prompt,
                                               8), r.rid


def test_compiled_dense_steps_equal_direct_apply(tp, monkeypatch):
    """Every compiled step of a dense decode engine (plain and n-gram
    verify widths) equals a direct ``T.apply`` on a clone of its cache,
    bit for bit, and the cache's tensors are never rebound."""
    ecfg = dataclasses.replace(ECFG, speculation="ngram", spec_len=3)
    pe = PrefillEngine(PTINY, tp, ecfg, device="cpu")
    de = DecodeEngine(PTINY, tp, ecfg, device="cpu")
    ptrs = [t.data_ptr() for t in KC._leaves(de.cache)]
    orig = E.CompiledStep.__call__
    widths = []

    def call(step, x):
        x = torch.as_tensor(x).clone()
        snap = T._tree_map(lambda a: a.clone(), step.cache)
        out = orig(step, x)
        want, wcache, _ = T.apply(step.cfg, step.params, x, cache=snap,
                                  mode="decode", **step.apply_kw)
        assert torch.equal(out, want)
        assert torch.equal(step.cache["lengths"], wcache["lengths"])
        for got, exp in zip(KC._leaves(step.cache["groups"]),
                            KC._leaves(snap["groups"])):
            assert torch.equal(got, exp)
        assert [t.data_ptr() for t in KC._leaves(de.cache)] == ptrs
        widths.append(x.shape[1])
        return out.clone()

    monkeypatch.setattr(E.CompiledStep, "__call__", call)
    reqs = _requests(_prompts(3), max_new=10)
    for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
        de.insert(r, st, int(torch.argmax(lg)))
    while de.active:
        de.step()
    assert 1 in widths and max(widths) > 1


def test_draft_decode_takes_b5(tp, tiny_params, greedy_reference):
    """The draft model's dense per-slot decode runs through
    ``ops.decode_attention`` (B5) now; draft speculation on a paged
    target keeps the greedy rollout."""
    ecfg = EngineConfig(max_len=96, max_batch=3, block_size=8,
                        speculation="draft", spec_len=3)
    pe = PrefillEngine(PTINY, tp, ecfg, device="cpu")
    de = DecodeEngine(PTINY, tp, ecfg, device="cpu", draft=(PTINY, tp))
    calls = []
    orig = ops.decode_attention

    def count(*a, **kw):
        calls.append(a[1].shape)
        return orig(*a, **kw)

    reqs = _requests(_prompts(4), max_new=8)
    for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
        de.insert(r, st, int(torch.argmax(lg)))
    L.ops.decode_attention = count
    try:
        while de.active:
            de.step()
    finally:
        L.ops.decode_attention = orig
    assert de.spec_accepted > 0
    assert calls and all(s == (3, 96, 2, 16) for s in calls)
    for r in reqs:
        assert r.generated == greedy_reference(TINY, tiny_params, r.prompt,
                                               8), r.rid


def test_span_pipelines_on_dense_rows(tp, tiny_params, greedy_reference):
    """A 2-stage ``PrefillPipeline`` (chunk resumes over dense per-span
    caches) hands dense states to a 2-stage ``DecodePipeline`` on dense
    rows; a span move mid-stream re-splits the residents' rows; the
    streams stay the greedy rollout."""
    from repro_torch.serving.span import DecodePipeline, PrefillPipeline
    pp = PrefillPipeline(PTINY, tp, ECFG, [(0, 2), (2, 4)], device="cpu")
    dp = DecodePipeline(PTINY, tp, ECFG, [(0, 2), (2, 4)], device="cpu")
    assert not any(e.paged for e in dp.engines)
    reqs = _requests(_prompts(5), max_new=8)
    for r, (st, lg) in zip(reqs, pp.run_batch(reqs, chunk_tokens=16)):
        assert "n_blocks" not in st
        dp.insert(r, st, int(torch.argmax(lg)))
    dp.step()
    rec = dp.move_span(0, 1, 1)
    assert rec["layers"] == 1 and rec["kv_bytes"] > 0
    assert dp.bounds == [(0, 1), (1, 4)]
    while dp.active:
        dp.step()
    for r in reqs:
        assert r.generated == greedy_reference(TINY, tiny_params, r.prompt,
                                               8), r.rid
