"""The port's serving path against the JAX package: wire states handed
from a JAX ``PrefillEngine`` into the port's ``DecodeEngine``, the port's
prefill engine against JAX's, and ``Server`` over the port's
``Orchestrator`` against the ``greedy_reference`` rollout.

The port's orchestrator is held here against the greedy rollout and the
JAX engines; ``test_torch_frontdoor.py`` holds it event by event against
the JAX orchestrator itself.

Tolerances: greedy tokens exactly; wire-state leaves and logits ``1e-4``
(float32, four layers summed in another order); positions exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY, TINY_ECFG, assert_pools_restored
from repro.core.kvstore import GlobalKVStore as JStore
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch import configs as port_configs
from repro_torch.core import analytical as A
from repro_torch.core.kvstore import GlobalKVStore
from repro_torch.models import kvcache as KC
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax, tree_from_numpy
from repro_torch.serving.api import Server
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine, check_servable)
from repro_torch.serving.fairshare import FairShareScheduler, SchedulerConfig
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request
from repro_torch.serving.workload import WorkloadConfig, generate

PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
ECFG = EngineConfig(max_len=TINY_ECFG.max_len, max_batch=TINY_ECFG.max_batch,
                    block_size=TINY_ECFG.block_size)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def port_params(tiny_params):
    return params_from_jax(PTINY, jax.tree.map(np.asarray, tiny_params),
                           device="cpu")


def _port_requests(jreqs):
    """The port's Requests for a JAX workload (same prompts and budgets)."""
    return [Request(rid=r.rid, arrival=r.arrival, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, prefix_id=r.prefix_id,
                    prefix_len=r.prefix_len) for r in jreqs]


def _shared_prefix_prompts(seed=0, n=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 128, 24, dtype=np.int32)
    return [np.concatenate([shared, rng.integers(0, 128, 9 + 3 * i,
                                                 dtype=np.int32)])
            for i in range(n)]


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def test_jax_wire_state_into_port_decode(tiny_params, port_params,
                                         greedy_reference):
    """A JAX prefill's paged hand-off state, through numpy, is adopted by
    the port's DecodeEngine, which decodes the greedy rollout exactly."""
    pe = JPrefill(TINY, tiny_params, TINY_ECFG, JStore(block_size=8))
    de = DecodeEngine(PTINY, port_params, ECFG, device="cpu")
    reqs = []
    for rid, prompt in enumerate(_shared_prefix_prompts()):
        st, logits = pe.run(JRequest(rid=rid, arrival=0.0, prompt=prompt,
                                     max_new_tokens=6))
        wire = tree_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
        req = Request(rid=rid, arrival=0.0, prompt=prompt, max_new_tokens=6)
        de.insert(req, wire, int(jnp.argmax(logits)))
        reqs.append(req)
    while de.active:
        de.step()
    for r in reqs:
        assert r.generated == greedy_reference(TINY, tiny_params, r.prompt,
                                               6), r.rid
    de.pool.check(holders=[de.slot_pages(i) for i in range(ECFG.max_batch)])


@pytest.mark.parametrize("chunk", [None, 10])
def test_port_prefill_matches_jax_prefill(tiny_params, port_params, chunk):
    """The port's PrefillEngine (store hits, chunk resumes over the paged
    wave cache) yields the JAX engine's wire states and logits."""
    prompts = _shared_prefix_prompts(1)
    jreqs = [JRequest(rid=i, arrival=0.0, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    preqs = _port_requests(jreqs)
    jpe = JPrefill(TINY, tiny_params, TINY_ECFG, JStore(block_size=8))
    ppe = PrefillEngine(PTINY, port_params, ECFG, GlobalKVStore(block_size=8),
                        device="cpu")
    for jr, pr in zip(jreqs, preqs):        # one by one: later ones hit
        (jst, jlg), = jpe.run_batch([jr], chunk_tokens=chunk)
        (pst, plg), = ppe.run_batch([pr], chunk_tokens=chunk)
        assert pr.cached_tokens == jr.cached_tokens
        np.testing.assert_allclose(plg.numpy(), jlg, **TOL)
        assert int(pst["n_blocks"]) == int(jst["n_blocks"])
        assert int(pst["length"]) == int(jst["length"])
        for pg, jg in zip(pst["groups"], jst["groups"]):
            for k in ("k", "v", "pos"):
                np.testing.assert_allclose(pg[k].numpy(), jg[k], **TOL)
    assert preqs[1].cached_tokens == 24
    assert ppe.tokens_prefilled == jpe.tokens_prefilled


def test_decode_kernel_opt_out_gives_the_same_stream(port_params,
                                                     tiny_params,
                                                     greedy_reference):
    """``decode_kernel=False`` (gather-then-attend, the A/B reference) and
    the default page-fused path decode identical streams."""
    streams = []
    for flag in (None, False):
        ecfg = dataclasses.replace(ECFG, decode_kernel=flag)
        pe = PrefillEngine(PTINY, port_params, ecfg, device="cpu")
        de = DecodeEngine(PTINY, port_params, ecfg, device="cpu")
        reqs = [Request(rid=i, arrival=0.0, prompt=p, max_new_tokens=5)
                for i, p in enumerate(_shared_prefix_prompts(2))]
        for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
            de.insert(r, st, int(torch.argmax(lg)))
        while de.active:
            de.step()
        streams.append([r.generated for r in reqs])
        assert de.use_kernel is (flag is None)
    assert streams[0] == streams[1]
    assert streams[0][0] == greedy_reference(TINY, tiny_params,
                                             reqs[0].prompt, 5)


def test_cow_fork_before_a_shared_page_is_written(tiny_params, port_params,
                                                  greedy_reference):
    """A 12-token request binds both pages of an active 16-token donor (its
    prompt is a strict prefix): its first decode write lands mid-way into a
    shared page, so the page is forked copy-on-write BEFORE the in-place
    write.  Both streams stay the greedy rollout."""
    pe = PrefillEngine(PTINY, port_params, ECFG, device="cpu")
    de = DecodeEngine(PTINY, port_params, ECFG, device="cpu")
    prompt = np.random.default_rng(2).integers(0, 128, 16, dtype=np.int32)
    r1 = Request(rid=0, arrival=0.0, prompt=prompt, max_new_tokens=6)
    st1, lg1 = pe.run(r1)
    s1 = de.insert(r1, st1, int(torch.argmax(lg1)))
    pages = de.slot_pages(s1)[:2]
    r2 = Request(rid=1, arrival=0.0, prompt=prompt[:12], max_new_tokens=6)
    st2, lg2 = pe.run(r2)
    st2 = KC.split_paged_state(st2, 2, ECFG.block_size)
    assert int(st2["n_blocks"]) == 0
    s2 = de.insert(r2, st2, int(torch.argmax(lg2)), shared_pages=pages)
    de.step()
    assert de.cow_forks == 1
    assert de.slot_pages(s2)[0] == pages[0]     # the untouched head stays
    assert de.slot_pages(s2)[1] != pages[1]     # the written page forked
    while de.active:
        de.step()
    assert r1.generated == greedy_reference(TINY, tiny_params, prompt, 6)
    assert r2.generated == greedy_reference(TINY, tiny_params, prompt[:12],
                                            6)
    de.pool.check(holders=[])


def test_unservable_stacks_raise_not_implemented(port_params):
    """Every stack is servable since the xLSTM and cross-attention slice:
    the xLSTM's decode engine is built on dense rows (it holds no
    attention KV to page), and seamless' check reports its page space
    (cross K/V ride slot-dense beside the pages).  int8 KV serves, but,
    as in JAX, cannot resume a prompt: one longer than ``chunk_tokens``
    raises ``ValueError`` before any prefill work."""
    xl = DecodeEngine(port_configs.get("xlstm-350m").smoke(), port_params,
                      ECFG, device="cpu")
    assert not xl.paged and xl.pool is None
    assert "block_tables" not in xl.cache
    sm = port_configs.get("seamless-m4t-large-v2").smoke()
    assert check_servable(sm, ECFG) == ECFG.max_len
    pe = PrefillEngine(dataclasses.replace(PTINY, kv_quant=True),
                       port_params,
                       dataclasses.replace(ECFG, speculation="ngram"),
                       device="cpu")
    req = Request(rid=0, arrival=0.0, prompt=_shared_prefix_prompts(4, 1)[0],
                  max_new_tokens=2)
    with pytest.raises(ValueError, match="int8 KV cannot resume"):
        pe.prefill_waves([req], chunk_tokens=16)
    assert pe.tokens_prefilled == 0


def test_store_fetch_bills_a_layer_schedule(port_params):
    """The store's per-layer fetch schedule comes from the port's kvcache
    (imported lazily); a wrong import would bill every fetch at zero."""
    pe = PrefillEngine(PTINY, port_params, ECFG, device="cpu")
    prompt = _shared_prefix_prompts(3, 1)[0]
    (st, _), = pe.run_batch([Request(rid=0, arrival=0.0, prompt=prompt,
                                     max_new_tokens=1)])
    store = GlobalKVStore(block_size=8)
    pays = [KC.paged_state_block(st, j, 8) for j in range(3)]
    keys = store.insert(prompt[:24], pays, KC.state_num_bytes(pays[0]))
    _, t_serial = store.fetch(keys)
    _, t_overlap = store.fetch(keys, t_layer_compute=1e-9)
    sched = store._entries[keys[0]].sched
    assert len(sched) == PTINY.n_layers and all(b > 0 for _, b in sched)
    assert t_serial > 0 and t_overlap > 0


# ---------------------------------------------------------------------------
# Server over the port's Orchestrator
# ---------------------------------------------------------------------------

def test_orchestrator_bills_the_h100_by_default():
    assert OrchestratorConfig().hw is A.H100_SXM
    assert A.H100_SXM.peak_flops == 989e12 and A.H100_SXM.hbm_bw == 3.35e12
    assert A.PROFILES["h100_sxm"] is A.H100_SXM


def test_workload_copy_matches_jax(make_workload):
    jreqs = make_workload(6)
    preqs = generate(WorkloadConfig(
        kind="synthetic", rps=1000.0, n_requests=6, vocab_size=128,
        max_new_tokens=6, prefix_share=0.5, n_prefix_groups=2, seed=3,
        prompt_len_lo=16, prompt_len_hi=48))
    for a, b in zip(jreqs, preqs):
        assert np.array_equal(a.prompt, b.prompt) and a.arrival == b.arrival


@pytest.mark.parametrize("chunk,n_decode", [(None, 2), (10, 1)])
def test_server_streams_equal_greedy_reference(tiny_params, port_params,
                                               greedy_reference,
                                               make_workload, chunk,
                                               n_decode):
    """Route → (chunked) prefill with store hits → hand-off with zero-copy
    prefix binds → paged decode: every stream equals the monolithic greedy
    rollout and every pool is restored."""
    reqs = _port_requests(make_workload(6))
    orch = Orchestrator(PTINY, port_params, OrchestratorConfig(
        n_prefill=1, n_decode=n_decode, engine=ECFG, chunk_tokens=chunk),
        device="cpu")
    summary = Server(orch).run(reqs)
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED
        assert r.generated == greedy_reference(
            TINY, tiny_params, r.prompt, r.max_new_tokens), r.rid
    assert summary["n_requests"] == len(reqs)
    assert summary["store_hit_rate"] > 0 and summary["pages_bound"] > 0
    assert any(r.cached_tokens > 0 for r in reqs)
    assert_pools_restored(orch)


def test_abort_in_decode_frees_the_slot(port_params, make_workload):
    reqs = _port_requests(make_workload(3, max_new=12))
    orch = Orchestrator(PTINY, port_params, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ECFG), device="cpu")
    for r in reqs:
        orch.submit(r, at=r.arrival)
    while not any(u.active for u in orch.decode_units()):
        orch.step()
    victim = next(s for s in orch.decode_units()[0].slots if s is not None)
    assert orch.abort(victim.rid)
    orch.drain()
    assert victim.outcome == Outcome.ABORTED
    assert all(r.outcome == Outcome.COMPLETED for r in reqs
               if r is not victim)
    assert_pools_restored(orch)
    orch.set_scheduler(SchedulerConfig(preemption="swap"))
    assert isinstance(orch.scheduler, FairShareScheduler)
