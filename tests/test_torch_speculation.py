"""The port's speculative decoding against the JAX package: the n-gram
proposer, the draft model, the verify step with rollback, the adaptive
depth, and speculation through the port's ``Orchestrator`` and ``Server``.

Greedy streams must equal ``greedy_reference`` (the monolithic JAX
rollout) exactly: speculation is invisible in token space.  The port's
engine counters (proposals scored, accepted, decode iterations, the
per-slot acceptance EMA) must equal the JAX ``DecodeEngine``'s on the
same run, exactly (float32 on both sides; the EMA is host arithmetic on
the same accept counts).  Pools must be restored after every run.

The JAX orchestrator does not import on Python 3.12 (its config gives a
dataclass field a non-frozen default), so the port's orchestrator is held
against the greedy rollout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY, TINY_ECFG, assert_pools_restored
from repro.serving.engine import DecodeEngine as JDecode
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.engine import ngram_propose as j_ngram_propose
from repro.serving.request import Request as JRequest
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.api import Server
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine, ngram_propose)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request

PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
BASE = EngineConfig(max_len=64, max_batch=3, block_size=8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(params):
    return params_from_jax(PTINY, jax.tree.map(np.asarray, params),
                           device="cpu")


@pytest.fixture(scope="module")
def port_params(tiny_params):
    return _port(tiny_params)


@pytest.fixture(scope="module")
def shallow_draft(model_zoo):
    """A one-layer draft of the target's width (seed 2): cheap enough that
    the load-aware cost model speculates with it."""
    jcfg = dataclasses.replace(TINY, n_layers=1)
    pcfg = dataclasses.replace(PTINY, n_layers=1)
    return pcfg, params_from_jax(
        pcfg, jax.tree.map(np.asarray, model_zoo(jcfg, seed=2)),
        device="cpu")


@pytest.fixture(scope="module")
def other_params(model_zoo):
    """A mismatched draft (TINY from seed 1): (JAX params, port params).
    Its proposals are accepted and rejected in effectively random
    patterns."""
    jp = model_zoo(TINY, seed=1)
    return jp, _port(jp)


def _prompts(seed, n, lo=10, hi=30):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(0, 128, int(rng.integers(lo, hi))),
                       np.int32) for _ in range(n)]


def _run_engine(params, ecfg, prompts, max_new=8, draft=None,
                abort_rid=None, abort_after=3):
    """Prefill + decode to completion on fresh port engines; optionally
    release one request's slot a few iterations in (abort)."""
    pe = PrefillEngine(PTINY, params, ecfg, device="cpu")
    de = DecodeEngine(PTINY, params, ecfg, device="cpu", draft=draft)
    reqs = []
    for rid, prompt in enumerate(prompts):
        r = Request(rid=rid, arrival=0.0, prompt=prompt.copy(),
                    max_new_tokens=max_new)
        st, lg = pe.run(r)
        de.insert(r, st, int(torch.argmax(lg)))
        reqs.append(r)
    it = 0
    while de.active:
        de.step()
        it += 1
        if abort_rid is not None and it == abort_after:
            for slot, r in enumerate(de.slots):
                if r is not None and r.rid == abort_rid:
                    de.release_slot(slot)
                    break
    return de, reqs


def _assert_engine_pool_clean(de):
    assert de.active == 0
    de.pool.check(holders=[de.slot_pages(i)
                           for i in range(de.ecfg.max_batch)])
    assert len(de._free) == de.ecfg.max_batch * de._nb_slot, "leaked pages"


# ---------------------------------------------------------------------------
# The n-gram proposer
# ---------------------------------------------------------------------------

def test_ngram_propose_matches_jax():
    """Seeded contexts over small vocabularies (so suffixes repeat), every
    depth and n-gram cap: the port proposes what JAX proposes."""
    rng = np.random.default_rng(0)
    n_hit = 0
    for _ in range(300):
        vocab = int(rng.integers(2, 12))
        ctx = [int(t) for t in rng.integers(0, vocab, int(rng.integers(0, 40)))]
        k = int(rng.integers(1, 7))
        max_n = int(rng.integers(1, 5))
        got = ngram_propose(ctx, k, max_n=max_n)
        assert got == j_ngram_propose(ctx, k, max_n=max_n), (ctx, k, max_n)
        n_hit += bool(got)
    assert n_hit > 100
    assert ngram_propose([5, 6, 7, 1, 5, 6, 7, 2, 5, 6], 4) == [7, 2, 5, 6]


# ---------------------------------------------------------------------------
# Streams: both proposers x page-fused verify and the gather reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode_kernel", [None, False])
@pytest.mark.parametrize("prop", ["ngram", "draft"])
def test_speculative_streams_equal_greedy_reference(
        tiny_params, port_params, greedy_reference, prop, decode_kernel):
    """Speculative decode (the self-draft: every proposal accepted) gives
    the greedy rollout on the page-fused verify path (kernel B4's plain
    version here) and on the gather-then-attend reference."""
    prompts = _prompts(21, 2)
    ecfg = dataclasses.replace(BASE, speculation=prop, spec_len=4,
                               decode_kernel=decode_kernel)
    draft = (PTINY, port_params) if prop == "draft" else None
    de, reqs = _run_engine(port_params, ecfg, prompts, max_new=8,
                           draft=draft)
    for r in reqs:
        assert r.generated == greedy_reference(TINY, tiny_params, r.prompt,
                                               8), r.rid
    assert de._spec_ok and de.use_kernel is (decode_kernel is None)
    if prop == "draft":
        assert de.spec_proposed > 0
        assert de.spec_accepted == de.spec_proposed       # acceptance 1.0
        assert de.decode_iters < 7                        # plain needs 7
    _assert_engine_pool_clean(de)


def _random_accept_trial(tiny_params, port_params, other_params, seed):
    rng = np.random.default_rng(seed)
    prompts = _prompts(100 + seed, 3)
    max_new = int(rng.integers(4, 12))
    ecfg = dataclasses.replace(BASE, speculation="draft",
                               spec_len=int(rng.integers(2, 6)))
    abort_rid = int(rng.integers(0, 3)) if rng.random() < 0.5 else None
    de, reqs = _run_engine(port_params, ecfg, prompts, max_new=max_new,
                           draft=(PTINY, other_params[1]),
                           abort_rid=abort_rid,
                           abort_after=int(rng.integers(1, 4)))
    return de, reqs, abort_rid, max_new


@pytest.mark.parametrize("seed", range(4))
def test_mismatched_draft_accept_reject_with_aborts(
        tiny_params, port_params, other_params, seed):
    """A mismatched draft gives effectively random verdicts; rejected
    tokens' fresh pages roll back and an aborted slot frees its pages:
    streams stay those of plain decode on the same prompts (itself held
    to the greedy rollout above), an aborted one a prefix of it, and the
    pool is clean."""
    de, reqs, abort_rid, max_new = _random_accept_trial(
        tiny_params, port_params, other_params, seed)
    _, plain = _run_engine(port_params, BASE, [r.prompt for r in reqs],
                           max_new=max_new)
    for r, r0 in zip(reqs, plain):
        want = r0.generated
        if r.rid == abort_rid:
            assert r.generated == want[:len(r.generated)]
        else:
            assert r.generated == want, r.rid
    assert 0 < de.spec_proposed and de.spec_accepted < de.spec_proposed
    _assert_engine_pool_clean(de)


# ---------------------------------------------------------------------------
# Counters and adaptive depth against the JAX DecodeEngine
# ---------------------------------------------------------------------------

def _jax_run(params, ecfg, prompts, max_new, draft=None):
    pe = JPrefill(TINY, params, ecfg, None)
    de = JDecode(TINY, params, ecfg, draft=draft)
    for rid, prompt in enumerate(prompts):
        r = JRequest(rid=rid, arrival=0.0, prompt=prompt.copy(),
                     max_new_tokens=max_new)
        st, lg = pe.run(r)
        de.insert(r, st, int(jnp.argmax(lg)))
    trace = []
    while de.active:
        de.step()
        trace.append((de.decode_iters, de.spec_proposed, de.spec_accepted,
                      de._spec_k.tolist()))
    return de, trace


@pytest.mark.parametrize("prop", ["ngram", "draft"])
def test_engine_counters_equal_jax(tiny_params, port_params, other_params,
                                   prop):
    """Step by step, the port's engine scores and accepts the same number
    of proposals, runs the same number of iterations and adapts the same
    per-slot depth as the JAX DecodeEngine (the mismatched draft; ngram
    on prompts with repeats).  The JAX side runs its gather-then-attend
    reference (same stream, no Pallas interpreter)."""
    rng = np.random.default_rng(41)
    motif = rng.integers(0, 128, 6).astype(np.int32)
    prompts = [np.concatenate([motif, rng.integers(0, 128, 3 + i),
                               motif]).astype(np.int32) for i in range(3)]
    kw = dict(max_len=64, max_batch=3, block_size=8, speculation=prop,
              spec_len=4)
    jde, jtrace = _jax_run(tiny_params, JEngineConfig(decode_kernel=False,
                                                      **kw),
                           prompts, 12,
                           draft=(TINY, other_params[0])
                           if prop == "draft" else None)
    pe = PrefillEngine(PTINY, port_params, EngineConfig(**kw), device="cpu")
    de = DecodeEngine(PTINY, port_params, EngineConfig(**kw), device="cpu",
                      draft=(PTINY, other_params[1])
                      if prop == "draft" else None)
    for rid, prompt in enumerate(prompts):
        r = Request(rid=rid, arrival=0.0, prompt=prompt.copy(),
                    max_new_tokens=12)
        st, lg = pe.run(r)
        de.insert(r, st, int(torch.argmax(lg)))
    trace = []
    while de.active:
        de.step()
        trace.append((de.decode_iters, de.spec_proposed, de.spec_accepted,
                      de._spec_k.tolist()))
    assert trace == jtrace
    assert de.spec_proposed > 0
    assert np.array_equal(de._spec_ema, jde._spec_ema)
    assert de.tokens_decoded == jde.tokens_decoded


def test_adaptive_depth_tracks_acceptance(port_params, other_params):
    """A mismatched draft drags the acceptance EMA and the per-slot depth
    down; a self-draft keeps both at the ceiling."""
    prompts = _prompts(31, 2)
    ecfg = dataclasses.replace(BASE, max_len=96, max_batch=2,
                               speculation="draft", spec_len=4)
    bad_k = []

    def watch(de):
        step = de.step

        def stepped():
            out = step()
            bad_k.append(de._spec_k.copy())
            return out
        return stepped

    pe = PrefillEngine(PTINY, port_params, ecfg, device="cpu")
    bad = DecodeEngine(PTINY, port_params, ecfg, device="cpu",
                       draft=(PTINY, other_params[1]))
    bad.step = watch(bad)
    for rid, p in enumerate(prompts):
        r = Request(rid=rid, arrival=0.0, prompt=p, max_new_tokens=16)
        st, lg = pe.run(r)
        bad.insert(r, st, int(torch.argmax(lg)))
    while bad.active:
        bad.step()
    assert bad.spec_accepted / bad.spec_proposed < 0.5
    assert bad._spec_ema.min() < 0.5
    assert min(int(k.min()) for k in bad_k) < 4
    good, _ = _run_engine(port_params, ecfg, prompts, max_new=16,
                          draft=(PTINY, port_params))
    assert good.spec_accepted == good.spec_proposed
    assert np.all(good._spec_ema == 1.0) and np.all(good._spec_k == 4)


def test_draft_needs_its_model(port_params):
    with pytest.raises(ValueError, match="draft"):
        DecodeEngine(PTINY, port_params,
                     dataclasses.replace(BASE, speculation="draft"),
                     device="cpu")
    with pytest.raises(ValueError, match="speculation"):
        EngineConfig(speculation="lookahead")


# ---------------------------------------------------------------------------
# Through the Orchestrator and Server
# ---------------------------------------------------------------------------

def _port_requests(jreqs):
    return [Request(rid=r.rid, arrival=r.arrival, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, prefix_id=r.prefix_id,
                    prefix_len=r.prefix_len) for r in jreqs]


def _orch(params, speculation, draft=None, **kw):
    ecfg = EngineConfig(max_len=TINY_ECFG.max_len,
                        max_batch=TINY_ECFG.max_batch,
                        block_size=TINY_ECFG.block_size,
                        speculation=speculation, spec_len=3)
    return Orchestrator(PTINY, params, OrchestratorConfig(
        n_prefill=1, n_decode=2, engine=ecfg, chunk_tokens=8, **kw),
        device="cpu", draft=draft)


@pytest.mark.parametrize("prop", ["ngram", "draft"])
def test_server_speculation_over_shared_prefixes(
        tiny_params, port_params, shallow_draft, greedy_reference,
        make_workload, prop):
    """Speculation over zero-copy shared-prefix pages (copy-on-write forks
    keep rollback away from shared blocks), routed by the load-aware cost
    rule: every stream is the greedy rollout, the pools balance with the
    store's holds, and the summary carries the speculation counters."""
    reqs = _port_requests(make_workload(n=4, seed=17, max_new=6,
                                        prefix_share=0.9, n_prefix_groups=1))
    draft = shallow_draft if prop == "draft" else None
    orch = _orch(port_params, prop, draft=draft)
    s = Server(orch).run(reqs)
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED
        assert r.generated == greedy_reference(
            TINY, tiny_params, r.prompt, r.max_new_tokens), r.rid
        assert len(r.t_tokens) == len(r.generated)
        assert all(b >= a for a, b in zip(r.t_tokens, r.t_tokens[1:]))
    assert s["pages_bound"] > 0
    assert_pools_restored(orch)
    assert s["speculation"] == prop
    assert s["spec_iters"] > 0
    assert s["spec_iters"] + s["spec_plain_iters"] >= s["decode_iters"]
    assert s["spec_accepted"] <= s["spec_proposed"]
    assert s["tokens_per_decode_iter"] >= 1.0
    assert s["acceptance_rate"] is None or 0.0 <= s["acceptance_rate"] <= 1
    if prop == "draft":
        assert s["spec_proposed"] > 0   # the shallow draft pays for itself


def test_load_aware_routing_refuses_a_draft_as_large_as_the_target(
        port_params, make_workload):
    """The cost model bills the draft's own decode steps: a draft the size
    of the target never pays for itself, so load-aware routing decodes
    plain (no proposal is scored), while the n-gram proposer, which costs
    nothing, speculates; speculation off reads zero, never NaN."""
    orch = _orch(port_params, "draft", draft=(PTINY, port_params))
    s = Server(orch).run(_port_requests(make_workload(n=3, seed=23, max_new=6)))
    assert s["spec_iters"] == 0 and s["spec_plain_iters"] > 0
    assert s["spec_proposed"] == 0 and s["acceptance_rate"] is None
    orch = _orch(port_params, "ngram")
    s = Server(orch).run(_port_requests(make_workload(n=3, seed=23, max_new=6)))
    assert s["spec_iters"] > 0          # tried first: acceptance 0.8 assumed
    s0 = Server(_orch(port_params, "off")).run(
        _port_requests(make_workload(n=3, seed=23, max_new=4)))
    assert s0["speculation"] == "off" and "spec_iters" not in s0
    assert s0["spec_proposed"] == 0 and s0["acceptance_rate"] is None
    assert s0["tokens_per_decode_iter"] is not None
