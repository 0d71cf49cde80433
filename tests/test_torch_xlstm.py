"""The xLSTM stacks (xlstm-350m: mLSTM and sLSTM blocks) of the port
against the JAX package (ROADMAP A6.3).

Held to JAX on inputs made from a seed with numpy, weights from the JAX
``init`` through ``params_from_jax``: ``mlstm_apply`` and
``slstm_apply`` (train, prefill with a state, decode, bf16, two chunks
against one pass), ``T.apply`` in every serving mode on the registry's
``smoke()`` (4 layers: three mLSTM, one sLSTM) and on a 5-layer variant
whose fifth layer is a remainder (``rem``) mLSTM, the dense-row helpers
of ``models/kvcache.py``, the prefill hand-off leaf by leaf against
JAX's ``PrefillEngine``, and served streams token for token against
``greedy_reference``: chunked and unchunked through ``Server``, across a
span move, a slot rebalance and a swap, compiled steps bit for bit
against a direct ``T.apply``, and a prefill whose decode slot an evicted
request left behind (a blanked row's stabilizer ``m`` is 0, not a fresh
row's -1e30).

Tolerances: float32 outputs, logits and states ``1e-5`` (STATE_TOL: the
same f32 recurrence step by step; only the reductions of the GEMMs and
of n . q sum in another order); a whole stack's logits 1e-4 (LOGIT_TOL,
as the other stacks); bf16 block outputs against JAX's bf16 at BF16_TOL
(2^-5 absolute plus 2^-7 relative, on outputs up to ~3: the f32
recurrence is fed by and feeds bf16 GEMMs that round at other places
than XLA's, and each side lies ~0.01-0.035 from the f32 forward on the
same bf16 weights, the port no farther than JAX); tokens exactly.

About 60 s on one worker (one process, two threads), most of it JAX's
eager greedy rollouts (one compile per sequence length, so the served
cases share one prompt length).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch.core.migration import MigrationAction, MigrationKind
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import BlockKind
from repro_torch.models.weights import (cast_params, params_from_jax,
                                         tree_from_numpy)
from repro_torch.serving import engine as E
from repro_torch.serving.api import Server
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine, check_servable)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request
from test_torch_registry import _to_jax, assert_tree_close, variant

STATE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2 ** -5, rtol=2 ** -7)
EXACT = dict(atol=0, rtol=0)
ECFG = EngineConfig(max_len=64, max_batch=3, block_size=8)
JECFG = JEngineConfig(max_len=64, max_batch=3, block_size=8)

ARCH = "xlstm-350m"
STACKS = {
    "smoke": variant(ARCH),
    # one (mLSTM, mLSTM, mLSTM, sLSTM) group plus a remainder mLSTM
    "x5": variant(ARCH, "x5", n_layers=5, d_model=64, n_heads=2,
                  n_kv_heads=2, head_dim=32, vocab_size=128),
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


def _requests(prompts, max_new=6):
    return [Request(rid=i, arrival=0.0, prompt=p.copy(),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]


# Every served case shares these prompts of one length: JAX's eager
# greedy reference compiles its ops once per sequence length.
PROMPTS = [_tokens(128, 20 + i, 19) for i in range(3)]


def _assert_exact(reqs, jc, jp, greedy_reference, served=True):
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED or not served, r.rid
        assert r.generated == greedy_reference(jc, jp, r.prompt,
                                               r.max_new_tokens), r.rid


# ---------------------------------------------------------------------------
# mlstm_apply / slstm_apply
# ---------------------------------------------------------------------------

BLOCKS = {"mlstm": (JL.init_mlstm, JL.mlstm_apply, L.mlstm_apply),
          "slstm": (JL.init_slstm, JL.slstm_apply, L.slstm_apply)}


def _block_case(block, dtype, seed=0, b=2):
    """(port config, JAX block params, port block params, a random state
    (numpy, f32: ``m`` finite as after some steps), JAX dtype) of one
    block at d = 64, 2 heads of 32."""
    jc, pc = STACKS["x5"]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = BLOCKS[block][0](jc, jax.random.PRNGKey(seed), jdt)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    h, hd, d = jc.n_heads, jc.head_dim, jc.d_model
    shapes = ({"C": (b, h, hd, hd), "n": (b, h, hd), "m": (b, h)}
              if block == "mlstm" else
              {k: (b, d) for k in ("c", "n", "m", "h")})
    state = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    if block == "slstm":
        state["n"] = np.abs(state["n"]) + 0.5    # a normalizer is positive
    return jc, pc, jp, tp, state, jdt


@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "bf16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_xlstm_block_vs_jax(block, mode):
    """The block's output and the state it writes in place (every leaf
    f32) against JAX's, with no state (train: zero memory, ``m`` at
    -1e30), over a prefill of 23 tokens from a random state, one decode
    token, and in bf16."""
    dtype = "bfloat16" if mode == "bf16" else "float32"
    jc, pc, jp, tp, state, jdt = _block_case(block, dtype)
    s = 1 if mode == "decode" else 23
    x = np.random.default_rng(1).standard_normal(
        (2, s, jc.d_model)).astype(np.float32)
    tdt = torch.bfloat16 if mode == "bf16" else torch.float32
    xt, xj = torch.as_tensor(x).to(tdt), jnp.asarray(x).astype(jdt)
    jfn, tfn = BLOCKS[block][1], BLOCKS[block][2]
    tol = BF16_TOL if mode == "bf16" else STATE_TOL
    if mode == "train":
        y, st = tfn(pc, tp, xt, state=None, mode="train")
        jy, jst = jfn(jc, jp, xj, state=None, mode="train")
        assert st is None and jst is None
        np.testing.assert_allclose(_np(y), _np(jy), **tol)
        return
    tstate = {k: torch.tensor(v) for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in tstate.items()}
    y, st = tfn(pc, tp, xt, state=tstate, mode=mode if s == 1 else "prefill")
    jy, jst = jfn(jc, jp, xj, state={k: jnp.asarray(v)
                                     for k, v in state.items()},
                  mode="prefill")
    assert y.dtype == tdt
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    assert st is tstate and {k: v.data_ptr() for k, v in st.items()} == ptrs
    for k in state:
        assert st[k].dtype == torch.float32
        np.testing.assert_allclose(_np(st[k]), _np(jst[k]),
                                   **(STATE_TOL if mode != "bf16" else tol))


@pytest.mark.parametrize("block", list(BLOCKS))
def test_xlstm_chunks_equal_one_pass(block):
    """A prompt run in three chunks, the state carried between them in
    place, equals one pass from the blank state (outputs and state)."""
    jc, pc, jp, tp, _, _ = _block_case(block, "float32")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 29, jc.d_model)).astype(np.float32))
    blank = T._block_state(pc, BlockKind(block), (2,), 64, torch.float32,
                           torch.device("cpu"))
    one = {k: v.clone() for k, v in blank.items()}
    fn = BLOCKS[block][2]
    y_one, _ = fn(pc, tp, x, state=one, mode="prefill")
    parts = [fn(pc, tp, x[:, lo:hi], state=blank, mode="prefill")[0]
             for lo, hi in ((0, 11), (11, 12), (12, 29))]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), y_one.numpy(),
                               **STATE_TOL)
    for k in one:
        np.testing.assert_allclose(blank[k].numpy(), one[k].numpy(),
                                   **STATE_TOL)


# ---------------------------------------------------------------------------
# Init, weights, caches
# ---------------------------------------------------------------------------

def test_init_state_and_weights_match_jax_layouts(stacks):
    """``init`` draws JAX's tree (no FFN in an xLSTM block, whatever
    ``d_ff``), ``params_from_jax`` checks it (a wrong ``w_if`` raises),
    bf16 casts keep no f32 leaf here, and the blank cache equals JAX's
    ``init_cache`` leaf for leaf: every state leaf f32 in a bf16 cache,
    ``m`` at -1e30."""
    jc, pc, jp, tp = stacks["x5"]
    mine = T.init(pc, seed=0, device="cpu")
    assert_tree_close(T._tree_map(lambda a: np.zeros(a.shape, np.float32),
                                  mine),
                      jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                   jp), **EXACT)
    assert set(mine["groups"][3]) == {"norm1", "rec"}
    assert set(mine["rem"][0]["rec"]) == {"w_up", "wq", "wk", "wv", "w_if",
                                         "w_o", "w_down"}
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, groups=tuple(
        {**g, "rec": {**g["rec"], "w_if": g["rec"]["w_if"][..., :1]}}
        if "w_if" in g["rec"] else g for g in tree["groups"]))
    with pytest.raises(ValueError, match="w_if"):
        params_from_jax(pc, bad, device="cpu")
    assert all(a.dtype == torch.bfloat16
               for a in KC._leaves(cast_params(tp, torch.bfloat16)))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        assert_tree_close(T.init_cache(pc, 2, 16, dtype=dt, device="cpu"),
                          JT.init_cache(jc, 2, 16, jdt), **EXACT)
    cache = T.init_cache(pc, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert cache["groups"][3]["m"].dtype == torch.float32
    assert torch.equal(cache["rem"][0]["m"], torch.full((2, 2), -1e30))
    assert check_servable(pc, ECFG) is None        # no attention: dense rows
    with pytest.raises(ValueError, match="not pageable"):
        T.init_paged_cache(pc, 2, 64, 8, device="cpu")


def _prefilled(pc, tp, rows, max_len=64):
    """A dense cache holding each row's prompt, each row prefilled on its
    own from a fresh cache (a recurrent state takes no pad tokens)."""
    cache = T.init_cache(pc, len(rows), max_len, device="cpu")
    for i, toks in enumerate(rows):
        one = T.init_cache(pc, 1, max_len, device="cpu")
        T.apply(pc, tp, torch.as_tensor(toks)[None], cache=one,
                mode="prefill")
        KC.insert_request_state(cache, i, KC.extract_request_state(one, 0))
    return cache


@pytest.mark.parametrize("tag", list(STACKS))
def test_xlstm_apply_vs_jax(stacks, tag):
    """``T.apply`` against JAX's: the stateless forward, a fresh prefill
    into a dense cache, decode steps over dense rows of unequal lengths,
    and a resumed (prefix-aware) chunk: logits and every state leaf."""
    jc, pc, jp, tp = stacks[tag]
    v = pc.vocab_size
    toks = _tokens(v, 3, 2, 17)
    got, _, aux = T.apply(pc, tp, torch.as_tensor(toks), mode="train")
    want, _, jaux = JT.apply(jc, jp, jnp.asarray(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    np.testing.assert_allclose(aux["router_load"].numpy(),
                               jaux["router_load"], **EXACT)

    got, cache, _ = T.apply(pc, tp, torch.as_tensor(toks),
                            cache=T.init_cache(pc, 2, 32, device="cpu"),
                            mode="prefill", logits_slice="last")
    want, jcache, _ = JT.apply(jc, jp, jnp.asarray(toks),
                               cache=JT.init_cache(jc, 2, 32),
                               mode="prefill", logits_slice="last")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert_tree_close(cache, jcache)

    cache = _prefilled(pc, tp, [_tokens(v, 5, 14), _tokens(v, 6, 5)])
    jcache = _to_jax(cache)
    step = _tokens(v, 7, 2, 1)
    for _ in range(4):
        got, cache, _ = T.apply(pc, tp, torch.as_tensor(step), cache=cache,
                                mode="decode", logits_slice="last")
        want, jcache, _ = JT.apply(jc, jp, jnp.asarray(step), cache=jcache,
                                   mode="decode", logits_slice="last")
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    assert_tree_close(cache, jcache)

    chunk = _tokens(v, 8, 2, 9)
    got, cache, _ = T.apply(pc, tp, torch.as_tensor(chunk), cache=cache,
                            mode="prefill", prefix_aware=True)
    want, jcache, _ = JT.apply(jc, jp, jnp.asarray(chunk), cache=jcache,
                               mode="prefill", prefix_aware=True)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert_tree_close(cache, jcache)


def test_kvcache_rows_of_an_xlstm_cache_vs_jax(stacks):
    """The dense-row helpers on an xLSTM cache equal JAX's bit for bit:
    extract, insert, blank (``m`` blanked to 0, as JAX's: the trap a
    fresh prefill must not start from), the byte count and the per-layer
    transfer schedule the hand-off is billed by (mLSTM: C, n, m;
    sLSTM: c, n, m, h; all f32)."""
    jc, pc, jp, tp = stacks["x5"]
    toks = _tokens(pc.vocab_size, 12, 2, 13)
    _, jcache, _ = JT.apply(jc, jp, jnp.asarray(toks),
                            cache=JT.init_cache(jc, 2, 16), mode="prefill")
    cache = tree_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    blank = KC.blank_request_state(cache)
    assert_tree_close(blank, JKC.blank_request_state(jcache), **EXACT)
    assert float(blank["groups"][0]["m"].abs().max()) == 0.0
    jst, st = JKC.extract_request_state(jcache, 1), \
        KC.extract_request_state(cache, 1)
    assert_tree_close(st, jst, **EXACT)
    copy = T._tree_map(torch.clone, cache)
    assert_tree_close(KC.insert_request_state(copy, 0, st),
                      JKC.insert_request_state(jcache, 0, jst), **EXACT)
    assert KC.state_num_bytes(st) == JKC.state_num_bytes(jst)
    sched = KC.layer_transfer_schedule(st)
    assert sched == JKC.layer_transfer_schedule(jst)
    h, hd, d = pc.n_heads, pc.head_dim, pc.d_model
    mlstm, slstm = 4 * (h * hd * hd + h * hd + h), 4 * 4 * d
    assert [b for _, b in sched] == [mlstm] * 3 + [slstm, mlstm]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def test_handoff_state_equals_jax_prefill_engine(stacks):
    """The port's ``PrefillEngine`` and JAX's, chunked at 10 tokens: the
    same waves (no padded suffix or row, no store), and each dense wire
    state and its logits leaf by leaf."""
    jc, pc, jp, tp = stacks["x5"]
    prompts = [_tokens(128, 30 + i, n) for i, n in enumerate((23, 9, 17))]
    pe = PrefillEngine(pc, tp, ECFG, device="cpu")
    je = JPrefill(jc, jp, JECFG)
    assert pe._page_len is None and pe.store is None and not pe._pad
    got = pe.run_batch(_requests(prompts, 2), chunk_tokens=10)
    want = je.run_batch([JRequest(rid=i, arrival=0.0, prompt=p,
                                  max_new_tokens=2)
                         for i, p in enumerate(prompts)], chunk_tokens=10)
    assert pe.compile_report()["shapes"] == \
        sorted(je.compile_report()["shapes"])
    for (pst, plg), (jst, jlg) in zip(got, want):
        np.testing.assert_allclose(plg.numpy(), jlg, **LOGIT_TOL)
        assert "n_blocks" not in pst and "n_blocks" not in jst
        assert int(pst["length"]) == int(jst["length"])
        assert_tree_close({k: pst[k] for k in ("groups", "rem")},
                          {k: jst[k] for k in ("groups", "rem")})


@pytest.mark.parametrize("chunk", [10, None])
def test_xlstm_served_streams_equal_greedy_reference(stacks,
                                                     greedy_reference,
                                                     chunk):
    """``Server`` over one prefill and one decode member: the stack has no
    attention, so both serve dense rows (no pool, no block tables, no
    store, no speculation); every stream equals JAX's greedy rollout."""
    jc, pc, jp, tp = stacks["x5"]
    reqs = _requests(PROMPTS, 6)
    orch = Orchestrator(pc, tp, OrchestratorConfig(
        n_prefill=1, n_decode=1, chunk_tokens=chunk,
        engine=dataclasses.replace(ECFG, speculation="ngram")),
        device="cpu")
    de = orch.decode_units()[0]
    assert not de.paged and de.pool is None and not de._spec_ok
    assert "block_tables" not in de.cache
    assert orch.prefill_members()[0].prefill.store is None
    Server(orch).run(reqs)
    _assert_exact(reqs, jc, jp, greedy_reference)


def _resident(orch):
    return [r.rid for u in orch.decode_units() for r in u.slots
            if r is not None]


def test_xlstm_state_through_span_moves_rebalance_and_swaps(
        stacks, greedy_reference):
    """Two 2-stage decode pipelines of the 5-layer stack, every stage on
    dense rows.  Mid-run: a slot's wire state round-trips a pipeline
    exactly, a live span move of two layers (an mLSTM and the sLSTM), a
    KV_HEADS slot rebalance between the pipelines, and a swap-out and
    resume of a resident; every stream equals JAX's greedy rollout."""
    jc, pc, jp, tp = stacks["x5"]
    orch = Orchestrator(pc, tp, OrchestratorConfig(
        n_prefill=1, n_decode=2, decode_split=2, migration=False,
        chunk_tokens=10, engine=ECFG), device="cpu")
    p0, p1 = orch.decode_pipes
    assert p0.bounds == [(0, 2), (2, 5)]
    assert not any(e.paged for e in p0.engines + p1.engines)
    reqs = _requests(PROMPTS, 6)
    srv = Server(orch)
    for r in reqs:
        srv.submit(r, at=0.0)
    while sum(u.active for u in orch.decode_pipes) < 3:
        srv.step()
    pipe = max(orch.decode_pipes, key=lambda u: u.active)
    slot = next(i for i, r in enumerate(pipe.slots) if r is not None)
    req, st, tok = pipe.extract_slot(slot)
    assert "n_blocks" not in st and st["groups"][0]["C"].dtype == \
        torch.float32
    pipe.adopt(req, st, tok, slot=slot)
    _, again, _ = pipe.extract_slot(slot)
    assert_tree_close(again, st, **EXACT)
    pipe.adopt(req, again, tok, slot=slot)
    act = MigrationAction(MigrationKind.LAYER, src=pipe.engines[1].name,
                          dst=pipe.lead.name, amount=2,
                          predicted_benefit=1.0, predicted_cost=1e-3)
    assert orch.apply_action(act)
    assert pipe.bounds == [(0, 4), (4, 5)]
    rec = orch.span_move_log[-1]
    h, hd, d = pc.n_heads, pc.head_dim, pc.d_model
    assert rec["kv_bytes"] == pipe.active * 4 * (
        (h * hd * hd + h * hd + h) + 4 * d)
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
    assert s["span_moves"] == 1
    _assert_exact(reqs, jc, jp, greedy_reference)
    assert all(u.active == 0 for u in orch.decode_pipes)


def test_compiled_xlstm_steps_equal_direct_apply(stacks, monkeypatch,
                                                 greedy_reference):
    """Every ``CompiledStep`` call of a full-stack decode engine and of a
    2-stage pipeline equals a direct ``T.apply`` on a cloned cache bit
    for bit (``C``, ``n``, ``m``, ``c``, ``h`` included); no cache tensor
    is rebound, and every recurrent leaf is one the capture restores
    (``_state_leaves``)."""
    jc, pc, jp, tp = stacks["x5"]
    orig = E.CompiledStep.__call__
    ptrs, calls = {}, []

    def call(step, x):
        x = torch.as_tensor(x).clone()
        leaves = KC._leaves(step.cache)
        assert ptrs.setdefault(id(step), [t.data_ptr() for t in leaves]) \
            == [t.data_ptr() for t in leaves]
        state = {id(a) for a in step._state_leaves()}
        assert state == {id(a) for a in KC._leaves(step.cache["groups"])
                         + KC._leaves(step.cache["rem"])}
        snap = T._tree_map(lambda a: a.clone(), step.cache)
        out = orig(step, x)
        want, wcache, _ = T.apply(step.cfg, step.params, x.to(step.x.dtype),
                                  cache=snap, mode="decode",
                                  **step.apply_kw)
        assert torch.equal(out, want)
        for got, exp in zip(KC._leaves(step.cache), KC._leaves(wcache)):
            assert torch.equal(got, exp)
        calls.append((step.apply_kw["hidden_in"],
                      step.apply_kw["hidden_out"]))
        return out.clone()

    monkeypatch.setattr(E.CompiledStep, "__call__", call)
    from repro_torch.serving.span import DecodePipeline
    pe = PrefillEngine(pc, tp, ECFG, device="cpu")
    de = DecodeEngine(pc, tp, ECFG, device="cpu")
    dp = DecodePipeline(pc, tp, ECFG, [(0, 3), (3, 5)], device="cpu")
    reqs = _requests(PROMPTS[:2], 6)
    for r, (st, lg) in zip(reqs, pe.run_batch(reqs, chunk_tokens=10)):
        (de if r.rid == 0 else dp).insert(r, st, int(torch.argmax(lg)))
    while de.active or dp.active:
        de.step()
        dp.step()
    _assert_exact(reqs, jc, jp, greedy_reference, served=False)
    assert set(calls) == {(False, False), (False, True), (True, False)}


def test_prefill_into_an_evicted_slot(stacks, greedy_reference):
    """The blanked-row trap: a row blanked by ``blank_request_state`` has
    ``m`` = 0, and a prefill from it leaves another stabilizer (and
    memory scale) than one from the fresh state (-1e30).  The engines
    never start from such a row: a decode slot that an evicted request
    left behind (its state, ``m`` finite, still in the row) takes the
    next request's prefilled state whole, and its stream equals JAX's
    greedy rollout, as does the evicted request's once resumed."""
    jc, pc, jp, tp = stacks["x5"]
    toks = torch.as_tensor(PROMPTS[0][:1])[None]    # one step: m = max(
    fresh = T.init_cache(pc, 1, 64, device="cpu")   # log f + m0, log i)
    blanked = T.init_cache(pc, 1, 64, device="cpu")
    KC.insert_request_state(blanked, 0, KC.blank_request_state(blanked))
    T.apply(pc, tp, toks, cache=fresh, mode="prefill")
    T.apply(pc, tp, toks, cache=blanked, mode="prefill")
    layers = list(fresh["groups"]) + list(fresh["rem"])
    blank_layers = list(blanked["groups"]) + list(blanked["rem"])
    assert any(not torch.equal(a["m"], b["m"])
               for a, b in zip(layers, blank_layers))

    ecfg = dataclasses.replace(ECFG, max_batch=1)
    pe = PrefillEngine(pc, tp, ecfg, device="cpu")
    de = DecodeEngine(pc, tp, ecfg, device="cpu")
    first, second = _requests(PROMPTS[:2], 6)
    st, lg = pe.run(first)
    de.insert(first, st, int(torch.argmax(lg)))
    de.step()
    de.step()
    evicted = de.extract_slot(0)           # the row keeps its state
    assert float(de.cache["groups"][0]["m"][:, 0].min()) > -1e29
    st, lg = pe.run(second)
    assert float(st["groups"][0]["m"].min()) > -1e29   # prefilled, not blank
    de.insert(second, st, int(torch.argmax(lg)))
    while de.active:
        de.step()
    de.adopt(*evicted)
    while de.active:
        de.step()
    _assert_exact([first, second], jc, jp, greedy_reference, served=False)
