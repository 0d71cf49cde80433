"""The RG-LRU hybrid (recurrentgemma-9b) and windowed ring serving of the
port against the JAX package (ROADMAP A6.2).

Held to JAX on inputs made from a seed with numpy, weights from the JAX
``init`` through ``params_from_jax``: ``rglru_apply`` (stateless, prefill
with state, decode, chunked, bf16), the ring prefill longer than its
cache and decode steps across the wrap (dense rows and pages), ``T.apply``
in every serving mode on three hybrid shapes (the registry's ``smoke()``;
a 5-layer stack, one (RG-LRU, RG-LRU, local) group plus a remainder of
two RG-LRU layers, with an 8-token window, so rings wrap at short
lengths; one at the arch's 16/1 heads of 256 on a narrow d_model), every
``models/kvcache.py`` conversion of a hybrid state, the hand-off states
of the ``PrefillEngine`` leaf by leaf, and served streams token for token
against ``greedy_reference``: chunked, across span moves, slot
rebalances and swaps, with compiled steps, and for a ``sliding_window``
stack; over int8 KV against JAX's own engines.

Tolerances: float32 logits, caches and states ``1e-4`` (LOGIT_TOL); the
log-depth scan sums the recurrence in another association order than
``lax.associative_scan``, which moves f32 results by a few ulps: held to
``SCAN_TOL`` (1e-5) on its own and within LOGIT_TOL through a stack; bf16
``rglru_apply`` against JAX's bf16 at ``BF16_TOL`` (two bf16 steps,
2^-7 relative, on outputs of order 1); tokens exactly.

About 150 s on one worker (one process, two threads), most of it JAX's
eager greedy rollouts, which compile their ops once per sequence length:
the served cases share one prompt length for that reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.core.kvstore import GlobalKVStore as JStore
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch.core.migration import MigrationAction, MigrationKind
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import (cast_params, params_from_jax,
                                         tree_from_numpy)
from repro_torch.serving.api import Server
from repro_torch.serving import engine as E
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine, check_servable)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request
from repro_torch.serving.span import DecodePipeline
from test_torch_registry import _to_jax, assert_tree_close, variant

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)
ECFG = EngineConfig(max_len=64, max_batch=3, block_size=8)
JECFG = JEngineConfig(max_len=64, max_batch=3, block_size=8)

ARCH = "recurrentgemma-9b"
# tag -> (JAX config, port config)
STACKS = {
    "smoke": variant(ARCH),
    # one (RGLRU, RGLRU, LOCAL) group plus a remainder of two RG-LRU
    # layers, window 8: rings wrap from the 9th token on
    "rg5": variant(ARCH, "rg5", n_layers=5, d_model=64, n_heads=2,
                   n_kv_heads=1, head_dim=32, d_ff=96, vocab_size=128,
                   local_window=8),
    # the arch's attention heads: 16 query heads on one kv head of 256
    "heads": variant(ARCH, "heads", n_layers=3, d_model=64, n_heads=16,
                     n_kv_heads=1, head_dim=256, d_ff=96, vocab_size=128,
                     local_window=16),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def stacks(model_zoo):
    """tag -> (JAX config, port config, JAX params, port params)."""
    out = {}
    for tag, (jc, pc) in STACKS.items():
        jp = model_zoo(jc)
        out[tag] = (jc, pc, jp, params_from_jax(
            pc, jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def _tokens(vocab, seed, *shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _prompts(seed, lengths, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lengths]


def _requests(prompts, max_new=6):
    return [Request(rid=i, arrival=0.0, prompt=p.copy(),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]


# The served prompts of the 5-layer stack, longer than its 8-token window.
# JAX's eager greedy reference compiles its ops once per sequence length,
# so every served case shares these prompts of one length (and the memo
# their streams).
PROMPTS = _prompts(5, (19, 19, 19))


def _assert_exact(reqs, jc, jp, greedy_reference, served=True):
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED or not served, r.rid
        assert r.generated == greedy_reference(jc, jp, r.prompt,
                                               r.max_new_tokens), r.rid


# ---------------------------------------------------------------------------
# rglru_apply
# ---------------------------------------------------------------------------

def _rglru_case(dtype, seed=0, b=2, s=37):
    """(JAX config, port config, JAX block params, port block params,
    x (B, S, d), state) of one RG-LRU block at d = 64, W = 4."""
    jc, pc = STACKS["rg5"]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = JL.init_rglru(jc, jax.random.PRNGKey(seed), jdt)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    d, w = jc.d_model, jc.rglru_conv_width
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    conv = rng.standard_normal((b, w - 1, d)).astype(np.float32)
    return jc, pc, jp, tp, x, (h0, conv), jdt


@pytest.mark.parametrize("mode", ["stateless", "prefill", "decode",
                                  "bf16"])
def test_rglru_apply_vs_jax(mode):
    """The block's output and its new state (``h`` f32, ``conv`` in the
    model dtype, written into the caller's tensors) against JAX's."""
    dtype = "bfloat16" if mode == "bf16" else "float32"
    jc, pc, jp, tp, x, (h0, conv), jdt = _rglru_case(
        dtype, s=1 if mode == "decode" else 37)
    tdt = torch.bfloat16 if mode == "bf16" else torch.float32
    xt = torch.as_tensor(x).to(tdt)
    xj = jnp.asarray(x).astype(jdt)
    tol = BF16_TOL if mode == "bf16" else LOGIT_TOL
    if mode == "stateless":
        y, st = L.rglru_apply(pc, tp, xt, state=None, mode="train")
        jy, jst = JL.rglru_apply(jc, jp, xj, state=None, mode="train")
        assert st is None and jst is None
        np.testing.assert_allclose(_np(y), _np(jy), **tol)
        return
    # copies: the port writes its state in place, and JAX on the CPU may
    # alias a numpy buffer
    state = {"h": torch.tensor(h0), "conv": torch.tensor(conv).to(tdt)}
    h_ptr, c_ptr = state["h"].data_ptr(), state["conv"].data_ptr()
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv).astype(jdt)}
    y, st = L.rglru_apply(pc, tp, xt, state=state,
                          mode="decode" if mode == "decode" else "prefill")
    jy, jst = JL.rglru_apply(jc, jp, xj, state=jstate, mode="prefill")
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    assert st is state and state["h"].data_ptr() == h_ptr \
        and state["conv"].data_ptr() == c_ptr          # in place
    assert state["h"].dtype == torch.float32 and state["conv"].dtype == tdt
    np.testing.assert_allclose(_np(state["h"]), _np(jst["h"]), **tol)
    np.testing.assert_allclose(_np(state["conv"]), _np(jst["conv"]), **tol)


def test_rglru_scan_equals_the_sequential_recurrence():
    """``rglru_scan`` (ceil(log2 S) passes) against the one-step-at-a-time
    recurrence and against ``lax.associative_scan`` (JAX's
    ``_rglru_scan``), at SCAN_TOL; one step is exact."""
    rng = np.random.default_rng(1)
    b, s, d = 2, 45, 16
    a = rng.uniform(0.5, 1.0, (b, s, d)).astype(np.float32)
    bx = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    got = L.rglru_scan(torch.as_tensor(a), torch.as_tensor(bx),
                       torch.as_tensor(h0)).numpy()
    h, seq = h0.astype(np.float64), []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        seq.append(h)
    np.testing.assert_allclose(got, np.stack(seq, 1), **SCAN_TOL)
    want = JL._rglru_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    np.testing.assert_allclose(got, np.asarray(want), **SCAN_TOL)
    one = L.rglru_scan(torch.as_tensor(a[:, :1]), torch.as_tensor(bx[:, :1]),
                       torch.as_tensor(h0))
    assert torch.equal(one, torch.as_tensor(a[:, :1] * h0[:, None]
                                            + bx[:, :1]))


def test_rglru_chunks_equal_one_pass():
    """A prompt run in three chunks, the state carried between them,
    equals one pass (outputs and state) within the scan's tolerance."""
    jc, pc, jp, tp, x, _, _ = _rglru_case("float32", s=37)
    b, d = x.shape[0], x.shape[2]
    zero = {"h": torch.zeros(b, d),
            "conv": torch.zeros(b, pc.rglru_conv_width - 1, d)}
    one = {k: v.clone() for k, v in zero.items()}
    y_one, _ = L.rglru_apply(pc, tp, torch.as_tensor(x), state=one,
                             mode="prefill")
    parts = []
    for lo, hi in ((0, 13), (13, 20), (20, 37)):
        y, _ = L.rglru_apply(pc, tp, torch.as_tensor(x[:, lo:hi]),
                             state=zero, mode="prefill")
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), y_one.numpy(),
                               **SCAN_TOL)
    for k in one:
        np.testing.assert_allclose(zero[k].numpy(), one[k].numpy(),
                                   **SCAN_TOL)


# ---------------------------------------------------------------------------
# Repairs: f32 a_param, the ring prefill, the shortest attention cache
# ---------------------------------------------------------------------------

def test_cast_params_keeps_a_param_f32(stacks):
    """JAX keeps ``a_param`` f32 in a bf16 model; so do ``init``,
    ``params_from_jax(dtype=bf16)`` and ``cast_params``."""
    jc, pc, jp, tp = stacks["rg5"]
    for tree in (cast_params(tp, torch.bfloat16),
                 params_from_jax(pc, jax.tree.map(np.asarray, jp),
                                 device="cpu", dtype=torch.bfloat16),
                 T.init(pc, seed=0, dtype=torch.bfloat16, device="cpu")):
        rec = tree["groups"][0]["rec"]
        assert rec["a_param"].dtype == torch.float32
        assert rec["w_x"].dtype == torch.bfloat16
        assert tree["rem"][0]["rec"]["a_param"].dtype == torch.float32
    jb = JT.init(jc, jax.random.PRNGKey(0), jnp.bfloat16)
    assert jb["groups"][0]["rec"]["a_param"].dtype == jnp.float32
    np.testing.assert_array_equal(
        T.init(pc, seed=0, device="cpu")["groups"][0]["rec"]["a_param"],
        np.asarray(jp["groups"][0]["rec"]["a_param"]))


@pytest.mark.parametrize("prefix_aware", [False, True])
def test_ring_prefill_longer_than_the_cache(prefix_aware):
    """``attention_apply`` prefill of 21 tokens into an 8-slot ring (a
    window of 8): attention over the whole sequence under the window, the
    last 8 keys written at ``pos % 8``, as JAX's tail slice; resumed
    (``prefix_aware``) over a ring that already wrapped."""
    jc, pc = STACKS["rg5"]
    jp = JL.init_attention(jc, jax.random.PRNGKey(3), jnp.float32)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    b, s, clen = 2, 21, 8
    start = 13 if prefix_aware else 0
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                          (b, s)).copy()
    shape = (b, clen, jc.n_kv_heads, jc.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32) if prefix_aware \
        else np.zeros(shape, np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32) if prefix_aware \
        else np.zeros(shape, np.float32)
    # a ring after 13 tokens: slot i holds the last position = i (mod 8)
    p0 = (np.arange(clen) + 8 * ((start - 1 - np.arange(clen)) // 8)
          if prefix_aware else -np.ones(clen)).astype(np.int32)
    p0 = np.broadcast_to(p0, (b, clen)).copy()
    state = {"k": torch.tensor(k0), "v": torch.tensor(v0),
             "pos": torch.tensor(p0)}                 # written in place
    jstate = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "pos": jnp.asarray(p0)}
    kw = dict(mode="prefill", window=8, prefix_aware=prefix_aware)
    y, st = L.attention_apply(pc, tp, torch.as_tensor(x),
                              positions=torch.as_tensor(pos), state=state,
                              **kw)
    jy, jst, _ = JL.attention_apply(jc, jp, jnp.asarray(x),
                                    positions=jnp.asarray(pos),
                                    state=jstate, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LOGIT_TOL)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(_np(st[k]), _np(jst[k]), **LOGIT_TOL)
    assert sorted(st["pos"][0].tolist()) == list(range(start + s - 8,
                                                       start + s))


def test_pad_cap_is_the_shortest_attention_cache():
    """The prefill engine pads suffixes up to the SHORTEST attention cache
    (JAX's ``_pad_cap``), not the page space, and a stack with recurrent
    state pads nothing: ``_pad``, ``_pad_cap`` and ``_bucket_len`` equal
    JAX's for a global + 16-token local stack and for the hybrid."""
    from repro.models.config import BlockKind as JBlockKind
    from repro.models.config import Family as JFamily
    from repro.models.config import ModelConfig as JModelConfig
    from repro_torch.models.config import BlockKind
    kw = dict(name="mix", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab_size=64, local_window=16)
    jmix = JModelConfig(family=JFamily.DENSE, block_pattern=(
        JBlockKind.ATTENTION, JBlockKind.LOCAL_ATTENTION), **kw)
    pmix = ModelConfig(family=Family.DENSE, block_pattern=(
        BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION), **kw)
    jc, pc = STACKS["rg5"]
    for jcfg, pcfg in ((jmix, pmix), (jc, pc)):
        tp = T.init(pcfg, seed=0, device="cpu")
        pe = PrefillEngine(pcfg, tp, ECFG, device="cpu")
        je = JPrefill(jcfg, JT.init(jcfg, jax.random.PRNGKey(0)), JECFG)
        assert (pe._pad, pe._pad_cap) == (je._pad, je._pad_cap)
        for slen, matched in ((3, 0), (9, 0), (13, 8), (20, 0), (5, 16)):
            assert pe._bucket_len(slen, matched) == \
                je._bucket_len(slen, matched), (pcfg.name, slen, matched)
    assert PrefillEngine(pmix, T.init(pmix, seed=0, device="cpu"), ECFG,
                         device="cpu")._pad_cap == 16
    assert not pe._pad and pe._bucket_len(13, 0) == 13


# ---------------------------------------------------------------------------
# T.apply: train, prefill, decode (dense rows and pages), resume
# ---------------------------------------------------------------------------

def _prefilled(pc, tp, rows, max_len):
    """A dense (B, max_len) cache holding each row's prompt, each row
    prefilled on its own (a recurrent state cannot take pad tokens)."""
    cache = T.init_cache(pc, len(rows), max_len, device="cpu")
    for i, toks in enumerate(rows):
        one = T.init_cache(pc, 1, max_len, device="cpu")
        T.apply(pc, tp, torch.as_tensor(toks)[None], cache=one,
                mode="prefill")
        st = KC.extract_request_state(one, 0)
        st["length"] = torch.tensor(len(toks), dtype=torch.int32)
        KC.insert_request_state(cache, i, st)
    return cache


def _paged(pc, cache, max_len, bs):
    """The dense cache through the wire format into pages, every row's
    table covering its whole page space (ring or linear)."""
    b = int(cache["lengths"].shape[0])
    plen = check_servable(pc, EngineConfig(max_len=max_len, block_size=bs))
    nb = plen // bs
    pc_ = T.init_paged_cache(pc, b, max_len, bs, device="cpu")
    for row in range(b):
        st = KC.dense_state_to_paged(KC.extract_request_state(cache, row),
                                     bs)
        KC.insert_paged_state(pc_, row, st, list(
            range(1 + row * nb, 1 + row * nb + st["n_blocks"])), bs)
        pc_["block_tables"][row] = torch.arange(1 + row * nb,
                                                1 + (row + 1) * nb)
    return pc_


@pytest.mark.parametrize("tag", list(STACKS))
def test_hybrid_apply_vs_jax(stacks, tag):
    """``T.apply`` against JAX's on each hybrid shape: the stateless
    forward, a fresh prefill into a dense cache, decode steps over dense
    rows (B5's plain version) and over pages (B1's; JAX's
    gather-then-attend reference) that cross the ring's wrap, and a
    resumed chunk over the dense cache (plain attend over [ring ;
    chunk]): logits and every cache leaf."""
    jc, pc, jp, tp = stacks[tag]
    v = pc.vocab_size
    toks = _tokens(v, 3, 2, 19)
    got, _, _ = T.apply(pc, tp, torch.as_tensor(toks), mode="train")
    want, _, _ = JT.apply(jc, jp, jnp.asarray(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)

    max_len = 32
    got, gcache, _ = T.apply(pc, tp, torch.as_tensor(toks),
                             cache=T.init_cache(pc, 2, max_len, device="cpu"),
                             mode="prefill", logits_slice="last")
    want, wcache, _ = JT.apply(jc, jp, jnp.asarray(toks),
                               cache=JT.init_cache(jc, 2, max_len),
                               mode="prefill", logits_slice="last")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert_tree_close(gcache, wcache)

    # rows of 14 and 5 tokens; the steps cross an 8-token ring's wrap
    rows = [_tokens(v, 5, 14), _tokens(v, 6, 5)]
    dense = _prefilled(pc, tp, rows, max_len)
    for paged in (False, True):
        cache = _paged(pc, dense, max_len, 8) if paged else \
            KC.insert_request_state(KC.insert_request_state(
                T.init_cache(pc, 2, max_len, device="cpu"), 0,
                KC.extract_request_state(dense, 0)), 1,
                KC.extract_request_state(dense, 1))
        jcache = _to_jax(cache)
        step = _tokens(v, 7, 2, 1)
        for _ in range(5):
            got, cache, _ = T.apply(pc, tp, torch.as_tensor(step),
                                    cache=cache, mode="decode",
                                    logits_slice="last", paged_kernel=True)
            want, jcache, _ = JT.apply(jc, jp, jnp.asarray(step),
                                       cache=jcache, mode="decode",
                                       logits_slice="last")
            np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
            step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        assert_tree_close(cache, jcache)

    chunk = _tokens(v, 8, 2, 11)
    cache = _prefilled(pc, tp, [rows[0], _tokens(v, 9, 14)], max_len)
    jcache = _to_jax(cache)
    got, cache, _ = T.apply(pc, tp, torch.as_tensor(chunk), cache=cache,
                            mode="prefill", prefix_aware=True)
    want, jcache, _ = JT.apply(jc, jp, jnp.asarray(chunk), cache=jcache,
                               mode="prefill", prefix_aware=True)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert_tree_close(cache, jcache)


def test_hybrid_int8_kv_vs_jax(stacks):
    """The hybrid over int8 KV (``with_kv_quant()``): an unchunked prefill
    into the ring, then paged decode steps across its wrap (B1-int8's
    plain version) against JAX's int8 path: logits, the int8 pages, their
    scales and the recurrent states."""
    jc, pc, jp, tp = stacks["rg5"]
    jq, pq = jc.with_kv_quant(), pc.with_kv_quant()
    toks = _tokens(pc.vocab_size, 11, 2, 12)
    got, cache, _ = T.apply(pq, tp, torch.as_tensor(toks),
                            cache=T.init_cache(pq, 2, 32, device="cpu"),
                            mode="prefill", logits_slice="last")
    want, jcache, _ = JT.apply(jq, jp, jnp.asarray(toks),
                               cache=JT.init_cache(jq, 2, 32),
                               mode="prefill", logits_slice="last")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert_tree_close(cache, jcache)
    cache = _paged(pq, cache, 32, 8)
    jcache = _to_jax(cache)
    step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for _ in range(4):
        got, cache, _ = T.apply(pq, tp, torch.as_tensor(step), cache=cache,
                                mode="decode", logits_slice="last",
                                paged_kernel=True)
        want, jcache, _ = JT.apply(jq, jp, jnp.asarray(step), cache=jcache,
                                   mode="decode", logits_slice="last")
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    assert_tree_close(cache, jcache)


def test_hybrid_int8_served_streams_equal_jax_engines(stacks):
    """The int8-KV hybrid served unchunked through the port's
    ``Orchestrator`` against JAX's own ``PrefillEngine`` and
    ``DecodeEngine`` on the same prompts: the same greedy streams (the
    int8 pools round K/V, so the float ``greedy_reference`` is not the
    rule here)."""
    from repro.serving.engine import DecodeEngine as JDecode
    jc, pc, jp, tp = stacks["rg5"]
    jq, pq = jc.with_kv_quant(), pc.with_kv_quant()
    reqs = _requests(PROMPTS, 6)
    orch = Orchestrator(pq, tp, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ECFG, chunk_tokens=None),
        device="cpu")
    Server(orch).run(reqs)
    jpe, jde = JPrefill(jq, jp, JECFG), JDecode(jq, jp, JECFG)
    jreqs = [JRequest(rid=r.rid, arrival=0.0, prompt=r.prompt.copy(),
                      max_new_tokens=6) for r in reqs]
    for jr in jreqs:
        st, lg = jpe.run(jr)
        jde.insert(jr, st, int(jnp.argmax(lg)))
    while jde.active:
        jde.step()
    for r, jr in zip(reqs, jreqs):
        assert r.outcome == Outcome.COMPLETED
        assert r.generated == jr.generated, r.rid


def test_kvcache_conversions_carry_recurrent_state_vs_jax(stacks):
    """Every state conversion of ``models/kvcache.py`` on a hybrid cache
    (two rows of 13 tokens: the 8-slot rings wrapped) equals JAX's, bit
    for bit, with ``h`` and ``conv`` riding slot-dense beside the ring
    pages: dense rows (extract, insert, blank), whole-cache paging both
    ways, the wire format both ways, one slot's pages out and into
    another pool, a head split, and the byte counts and per-layer
    transfer schedule the hand-off is billed by."""
    from repro.models import kvcache as JKC
    jc, pc, jp, tp = stacks["rg5"]
    exact = dict(atol=0, rtol=0)
    toks = _tokens(pc.vocab_size, 12, 2, 13)
    _, jcache, _ = JT.apply(jc, jp, jnp.asarray(toks),
                            cache=JT.init_cache(jc, 2, 32), mode="prefill")
    cache = tree_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert_tree_close(KC.blank_request_state(cache),
                      JKC.blank_request_state(jcache), **exact)
    jst, st = JKC.extract_request_state(jcache, 1), \
        KC.extract_request_state(cache, 1)
    assert_tree_close(st, jst, **exact)
    copy = T._tree_map(torch.clone, cache)       # the port writes in place
    assert_tree_close(KC.insert_request_state(copy, 0, st),
                      JKC.insert_request_state(jcache, 0, jst), **exact)
    jpc, pcache = JKC.dense_to_paged(jcache, 8), KC.dense_to_paged(cache, 8)
    assert_tree_close(pcache, jpc, **exact)
    assert_tree_close(KC.paged_to_dense(pcache, 8),
                      JKC.paged_to_dense(jpc, 8), **exact)
    jw, w = JKC.dense_state_to_paged(jst, 8), KC.dense_state_to_paged(st, 8)
    assert_tree_close(w, jw, **exact)
    assert w["n_blocks"] == 1 and w["groups"][0]["h"].shape == (1, 64)
    assert_tree_close(KC.paged_state_to_dense(w, 8, 8),
                      JKC.paged_state_to_dense(jw, 8, 8), **exact)
    jx = JKC.extract_paged_state(jpc, 1, 8)
    x = KC.extract_paged_state(pcache, 1, 8)
    assert_tree_close(x, jx, **exact)
    jblank = JKC.dense_to_paged(JT.init_cache(jc, 2, 32), 8)
    blank = KC.dense_to_paged(T.init_cache(pc, 2, 32, device="cpu"), 8)
    assert_tree_close(KC.insert_paged_state(blank, 0, x, [2], 8),
                      JKC.insert_paged_state(jblank, 0, jx, [2], 8),
                      **exact)
    assert_tree_close(KC.split_paged_state(w, 1, 8),
                      JKC.split_paged_state(jw, 1, 8), **exact)
    assert KC.state_num_bytes(w) == JKC.state_num_bytes(jw)
    sched = KC.layer_transfer_schedule(w)
    assert sched == JKC.layer_transfer_schedule(jw)
    # RG-LRU layers 0, 1, 3, 4 bill h (f32) and conv (W - 1 rows)
    rec = 64 * 4 + 3 * 64 * 4
    assert [b for _, b in sched][:2] == [rec, rec] and sched[3][1] == rec


# ---------------------------------------------------------------------------
# Serving: hand-off states, streams, spans, swaps, compiled steps
# ---------------------------------------------------------------------------

def test_handoff_state_equals_jax_prefill_engine(stacks):
    """The port's ``PrefillEngine`` and JAX's, chunked at 10 tokens over
    prompts longer than the 8-token window: the same waves (no padded
    suffix or row), and each paged wire state (ring pages, ``h``,
    ``conv``) and its logits leaf by leaf."""
    jc, pc, jp, tp = stacks["rg5"]
    prompts = _prompts(2, (23, 9, 17))
    jreqs = [JRequest(rid=i, arrival=0.0, prompt=p, max_new_tokens=2)
             for i, p in enumerate(prompts)]
    preqs = _requests(prompts, 2)
    pe = PrefillEngine(pc, tp, ECFG, device="cpu")
    je = JPrefill(jc, jp, JECFG, JStore(block_size=8))
    assert pe.store is None and je.store is None      # not cacheable
    got = pe.run_batch(preqs, chunk_tokens=10)
    want = je.run_batch(jreqs, chunk_tokens=10)
    assert pe.compile_report()["shapes"] == \
        sorted(je.compile_report()["shapes"])
    for (pst, plg), (jst, jlg) in zip(got, want):
        np.testing.assert_allclose(plg.numpy(), jlg, **LOGIT_TOL)
        assert int(pst["n_blocks"]) == int(jst["n_blocks"]) == 1
        assert int(pst["length"]) == int(jst["length"])
        assert_tree_close({k: pst[k] for k in ("groups", "rem")},
                          {k: jst[k] for k in ("groups", "rem")})
    assert pe.tokens_prefilled == je.tokens_prefilled == sum(map(len,
                                                                 prompts))


@pytest.mark.parametrize("chunk", [10, None])
def test_hybrid_served_streams_equal_greedy_reference(stacks,
                                                      greedy_reference,
                                                      chunk):
    """``Server`` over the port's ``Orchestrator`` (one prefill, one decode
    member): prompts longer than the window, prefilled in chunks of 10 or
    at once, decoded over the paged ring across its wrap; every stream
    equals JAX's greedy rollout, and the pools are restored."""
    jc, pc, jp, tp = stacks["rg5"]
    reqs = _requests(PROMPTS, 6)
    orch = Orchestrator(pc, tp, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ECFG, chunk_tokens=chunk),
        device="cpu")
    de = orch.decode_units()[0]
    assert de.paged and de.page_len == 8 and not de._spec_ok
    Server(orch).run(reqs)
    _assert_exact(reqs, jc, jp, greedy_reference)
    de.pool.check(holders=[])


def test_sliding_window_stack_served(model_zoo, greedy_reference):
    """A ``sliding_window`` variant of TINY (window 16, every layer global
    attention under it) pages at its 16-slot ring, as JAX's engines do,
    and serves chunked prompts longer than the window token for token;
    no store (not prefix-cacheable), no speculation."""
    jswa = dataclasses.replace(TINY, name="tiny4-swa16", sliding_window=16)
    pswa = ModelConfig(name="tiny4-swa16", family=Family.DENSE, n_layers=4,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=128, sliding_window=16)
    jp = model_zoo(jswa)
    tp = params_from_jax(pswa, jax.tree.map(np.asarray, jp), device="cpu")
    assert check_servable(pswa, ECFG) == 16
    reqs = _requests(_prompts(4, (26, 26, 26)), 4)
    orch = Orchestrator(pswa, tp, OrchestratorConfig(
        n_prefill=1, n_decode=1, chunk_tokens=8,
        engine=dataclasses.replace(ECFG, speculation="ngram")),
        device="cpu")
    assert orch.prefill_members()[0].prefill.store is None
    assert not orch.decode_units()[0]._spec_ok
    Server(orch).run(reqs)
    _assert_exact(reqs, jswa, jp, greedy_reference)


def _resident(orch):
    return [r.rid for u in orch.decode_units() for r in u.slots
            if r is not None]


def test_recurrent_state_through_spans_moves_rebalance_and_swaps(
        stacks, greedy_reference):
    """Two 2-stage decode pipelines of the 5-layer stack: stage 0 holds
    only RG-LRU layers (dense rows), stage 1 the ring and the remainder.
    Mid-run: a live span move, a KV_HEADS slot rebalance between the
    pipelines, and a swap-out and resume of a resident.  Every slot's
    wire state round-trips a pipeline exactly (``h``, ``conv`` and ring
    pages), and every stream equals JAX's greedy rollout."""
    jc, pc, jp, tp = stacks["rg5"]
    orch = Orchestrator(pc, tp, OrchestratorConfig(
        n_prefill=1, n_decode=2, decode_split=2, migration=False,
        chunk_tokens=10, engine=ECFG), device="cpu")
    p0, p1 = orch.decode_pipes
    assert p0.bounds == [(0, 2), (2, 5)]
    assert [e.paged for e in p0.engines] == [False, True]
    reqs = _requests(PROMPTS, 6)
    srv = Server(orch)
    for r in reqs:
        srv.submit(r, at=0.0)
    while sum(u.active for u in orch.decode_pipes) < 3:
        srv.step()
    # the wire state of a slot round-trips a pipeline exactly
    pipe = max(orch.decode_pipes, key=lambda u: u.active)
    slot = next(i for i, r in enumerate(pipe.slots) if r is not None)
    req, st, tok = pipe.extract_slot(slot)
    assert "n_blocks" in st and st["groups"][0]["h"].dtype == torch.float32
    assert pipe.adopt(req, st, tok, slot=slot) == slot
    _, again, _ = pipe.extract_slot(slot)
    assert_tree_close(again, st, atol=0, rtol=0)
    pipe.adopt(req, again, tok, slot=slot)
    # a live span move of one layer, then pile every resident onto one
    # pipeline and let KV_HEADS rebalance a slot back
    act = MigrationAction(MigrationKind.LAYER, src=pipe.lead.name,
                          dst=pipe.engines[1].name, amount=1,
                          predicted_benefit=1.0, predicted_cost=1e-3)
    assert orch.apply_action(act)
    assert pipe.bounds == [(0, 1), (1, 5)]
    src, dst = sorted(orch.decode_pipes, key=lambda u: -u.active)
    for s_, r in enumerate(dst.slots):
        if r is not None:
            src.adopt(*dst.extract_slot(s_))
    act = MigrationAction(MigrationKind.KV_HEADS, src=src.lead.name,
                          dst=dst.lead.name, amount=1,
                          predicted_benefit=1.0, predicted_cost=1e-3)
    assert orch.apply_action(act) and dst.active == 1
    srv.step()
    assert orch.preempt(_resident(orch)[0], "swap")
    srv.drain()
    s = srv.summary()
    assert not orch._swapped and s["n_preempted_swap"] == 1
    assert s["pages_swapped"] > 0 and s["span_moves"] == 1
    _assert_exact(reqs, jc, jp, greedy_reference)
    for u in orch.decode_pipes:
        assert u.active == 0
        for e in u.engines:
            if e.paged:
                e.pool.check(holders=[])


def test_compiled_hybrid_steps_equal_direct_apply(stacks, monkeypatch,
                                                  greedy_reference):
    """Every ``CompiledStep`` call of a served hybrid run (a full-stack
    decode engine, and a 2-stage pipeline whose first stage holds only
    RG-LRU layers on dense rows) equals a direct ``T.apply`` on a cloned
    cache bit for bit, ring pages and ``h``/``conv`` included, and no
    step's cache tensor is ever rebound."""
    jc, pc, jp, tp = stacks["rg5"]
    orig = E.CompiledStep.__call__
    ptrs, calls = {}, []

    def call(step, x):
        x = torch.as_tensor(x).clone()
        leaves = KC._leaves(step.cache)
        assert ptrs.setdefault(id(step), [t.data_ptr() for t in leaves]) \
            == [t.data_ptr() for t in leaves]
        snap = T._tree_map(lambda a: a.clone(), step.cache)
        out = orig(step, x)
        want, wcache, _ = T.apply(step.cfg, step.params, x.to(step.x.dtype),
                                  cache=snap, mode="decode",
                                  **step.apply_kw)
        assert torch.equal(out, want)
        assert torch.equal(step.cache["lengths"], wcache["lengths"])
        for got, exp in zip(KC._leaves(step.cache["groups"])
                            + KC._leaves(step.cache["rem"]),
                            KC._leaves(snap["groups"])
                            + KC._leaves(snap["rem"])):
            assert torch.equal(got, exp)
        calls.append(("block_tables" in step.cache,
                      step.apply_kw["hidden_in"],
                      step.apply_kw["hidden_out"]))
        return out.clone()

    monkeypatch.setattr(E.CompiledStep, "__call__", call)
    pe = PrefillEngine(pc, tp, ECFG, device="cpu")
    de = DecodeEngine(pc, tp, ECFG, device="cpu")
    dp = DecodePipeline(pc, tp, ECFG, [(0, 2), (2, 5)], device="cpu")
    reqs = _requests(PROMPTS[:2], 6)
    for r, (st, lg) in zip(reqs, pe.run_batch(reqs, chunk_tokens=10)):
        (de if r.rid == 0 else dp).insert(r, st, int(torch.argmax(lg)))
    while de.active or dp.active:
        de.step()
        dp.step()
    _assert_exact(reqs, jc, jp, greedy_reference, served=False)
    # full-stack paged steps, the dense pure-recurrent stage, the paged
    # ring stage behind it
    assert set(calls) == {(True, False, False), (False, False, True),
                          (True, True, False)}
