"""The port's compiled decode-side forwards (``serving/engine.py``
``CompiledStep``) and the prefill shape report, on the CPU.

On the CPU a ``CompiledStep`` runs its forward eagerly over the engine's
static buffers (on the card it replays a CUDA graph captured over the same
buffers).  Every call in these scenarios is held, bit for bit, against a
direct ``transformer.apply`` on a clone of the cache it runs on: the same
logits and the same pools, positions, scales, tables and lengths after.
Before each call the cache's tables and live rows' lengths must equal the
engine's host mirrors, and its tensors must be the ones the step was built
over (nothing rebound).  The scenarios insert and adopt mid-run, retire
and reuse slots, fork a shared page copy-on-write, move slots between
engines, roll back rejected verify pages, verify at every width and move a
span.

``compile_report`` is held against the JAX ``PrefillEngine``'s on the
workload of its own bound test: equal shape sets and bounds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import TINY, TINY_ECFG
from repro.models import transformer as JT
from repro.models.config import Family as JFamily
from repro.models.config import ModelConfig as JModelConfig
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch.models import kvcache as KC
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import engine as E
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine)
from repro_torch.serving.request import Request
from repro_torch.serving.span import DecodePipeline

PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
ECFG = EngineConfig(max_len=TINY_ECFG.max_len, max_batch=TINY_ECFG.max_batch,
                    block_size=TINY_ECFG.block_size)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(params, dtype=None):
    return params_from_jax(PTINY, jax.tree.map(np.asarray, params),
                           device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def weights(tiny_params):
    return {"float32": _port(tiny_params),
            "bfloat16": _port(tiny_params, torch.bfloat16)}


@pytest.fixture(scope="module")
def other_weights(model_zoo):
    """A mismatched draft (TINY from seed 1): its proposals are accepted
    and rejected in effectively random patterns."""
    return _port(model_zoo(TINY, seed=1))


# ---------------------------------------------------------------------------
# The checker: every CompiledStep call against a direct T.apply
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if torch.is_tensor(tree) else tree


class StepChecker:
    """Wraps ``CompiledStep.__call__``: holds each call against
    ``T.apply`` on a cloned cache and the owning engine's host mirrors,
    and records what ran."""

    def __init__(self, monkeypatch):
        self.engines = []
        self.calls = []          # (kind, width, hidden_in, hidden_out, int8)
        self._ptrs = {}
        orig = E.CompiledStep.__call__
        checker = self

        def call(step, x):
            x = torch.as_tensor(x).clone()
            checker.check_state(step)
            snap = _clone(step.cache)
            out = orig(step, x)
            want, wcache, _ = T.apply(step.cfg, step.params,
                                      x.to(step.x.dtype), cache=snap,
                                      mode="decode", **step.apply_kw)
            assert torch.equal(out, want)
            wcache = dict(snap, lengths=wcache["lengths"])
            for got, exp in zip(_leaves(step.cache), _leaves(wcache)):
                assert torch.equal(got, exp)
            checker.calls.append(checker.kind(step))
            return out.clone()

        monkeypatch.setattr(E.CompiledStep, "__call__", call)

    def kind(self, step):
        kw = step.apply_kw
        mode = ("decode" if step.x.shape[1] == 1 else "verify") \
            if "block_tables" in step.cache else "draft"
        return (mode, step.x.shape[1], kw.get("hidden_in", False),
                kw.get("hidden_out", False), step.cfg.kv_quant)

    def check_state(self, step):
        ptrs = [t.data_ptr() for t in _leaves(step.cache)]
        assert self._ptrs.setdefault(id(step), ptrs) == ptrs, \
            "a cache tensor was rebound after the step was built"
        for e in self.engines:
            if e.cache is step.cache:
                assert np.array_equal(step.cache["block_tables"].numpy(),
                                      e._bt)
                live = [i for i, r in enumerate(e.slots) if r is not None]
                assert np.array_equal(
                    step.cache["lengths"].numpy()[live],
                    e._slot_len[live].astype(np.int32))
                assert e.compiled.steps[self.kind(step)] is step
                return
            if e._draft is not None and e._draft.cache is step.cache:
                # pinned to the host mirror, then one ahead per micro-step
                ahead = step.cache["lengths"].numpy() - e._draft.len
                assert ahead.min() == ahead.max() >= 0
                return
        raise AssertionError("a step ran on a cache no engine owns")


@pytest.fixture
def checker(monkeypatch):
    return StepChecker(monkeypatch)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 128, n, dtype=np.int32)


# ---------------------------------------------------------------------------
# (a) Every mode, bit for bit, through the page movers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kv_quant", [("float32", False),
                                            ("bfloat16", False),
                                            ("float32", True)])
def test_plain_decode_steps_equal_direct_apply(weights, checker, dtype,
                                               kv_quant):
    """Plain decode on bf16/f32 and int8 pools across mid-run inserts, a
    copy-on-write fork of a bound page, a retired slot whose pages are
    recycled, and a slot moved to another engine (extract/adopt, as a
    KV_HEADS rebalance does): every step equals a direct apply, the
    pools are never rebound, and each engine holds one step."""
    cfg = dataclasses.replace(PTINY, kv_quant=kv_quant)
    params = weights[dtype]
    pe = PrefillEngine(cfg, params, ECFG, device="cpu")
    e0 = DecodeEngine(cfg, params, ECFG, name="d0", device="cpu")
    e1 = DecodeEngine(cfg, params, ECFG, name="d1", device="cpu")
    checker.engines += [e0, e1]
    ptrs = {e.name: [t.data_ptr() for t in _leaves(e.cache)]
            for e in (e0, e1)}

    def put(eng, rid, prompt, max_new, shared=None):
        r = Request(rid=rid, arrival=0.0, prompt=prompt,
                    max_new_tokens=max_new)
        st, lg = pe.run(r)
        if shared:
            st = KC.split_paged_state(st, len(shared), ECFG.block_size)
        eng.insert(r, st, int(torch.argmax(lg)), shared_pages=shared)
        return r

    donor = _prompt(2, 16)
    r0 = put(e0, 0, donor, 12)
    put(e0, 1, _prompt(3, 21), 3)              # retires after 3 tokens
    e0.step()
    e0.step()
    # binds both pages of the donor: its first write forks page 1
    put(e0, 2, donor[:12], 8, shared=e0.slot_pages(0)[:2])
    forks = e0.cow_forks
    e0.step()
    assert e0.cow_forks == forks + 1
    put(e1, 3, _prompt(4, 30), 6)
    for _ in range(3):
        e0.step()
        e1.step()
    # move the donor to the other engine mid-stream
    slot = next(i for i, r in enumerate(e0.slots) if r is r0)
    e1.adopt(*e0.extract_slot(slot))
    put(e0, 4, _prompt(5, 9), 5)               # reuses recycled pages
    while e0.active or e1.active:
        e0.step()
        e1.step()
    for e in (e0, e1):
        assert [t.data_ptr() for t in _leaves(e.cache)] == ptrs[e.name]
        assert list(e.compiled.steps) == [("decode", 1, False, False,
                                         kv_quant)]
        rep = e.compiled.report()
        assert not rep["graphs"] and rep["graphs_captured"] == 0
        e.pool.check(holders=[])
    assert {c[0] for c in checker.calls} == {"decode"}


@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_and_draft_steps_equal_direct_apply(weights, other_weights,
                                                   checker, kv_quant):
    """Draft speculation with a mismatched draft near the cache's end:
    the verify runs at every width 2..spec_len + 1 (capped by the room
    left), the draft's micro-step runs on its dense cache, and rejected
    tokens' fresh pages roll back; every call equals a direct apply."""
    cfg = dataclasses.replace(PTINY, kv_quant=kv_quant)
    ecfg = EngineConfig(max_len=48, max_batch=3, block_size=8,
                        speculation="draft", spec_len=4)
    params = weights["float32"]
    pe = PrefillEngine(cfg, params, ecfg, device="cpu")
    de = DecodeEngine(cfg, params, ecfg, device="cpu",
                      draft=(PTINY, other_weights))
    checker.engines.append(de)
    rolled = []
    orig = DecodeEngine._rollback_pages

    def rollback(self, slot, fresh):
        n = int(self._slot_len[slot])
        rolled.extend(b for j, b in fresh if j * self.ecfg.block_size >= n)
        return orig(self, slot, fresh)

    DecodeEngine._rollback_pages = rollback
    try:
        for rid, n in enumerate((22, 27, 31)):
            r = Request(rid=rid, arrival=0.0, prompt=_prompt(10 + rid, n),
                        max_new_tokens=40)
            st, lg = pe.run(r)
            de.insert(r, st, int(torch.argmax(lg)))
        while de.active:
            de.step()
    finally:
        DecodeEngine._rollback_pages = orig
    widths = {c[1] for c in checker.calls if c[0] == "verify"}
    assert widths == set(range(2, ecfg.spec_len + 2))
    assert any(c[0] == "draft" for c in checker.calls)
    assert rolled, "no rejected verify rolled a page back"
    assert de.spec_accepted < de.spec_proposed
    steps = de.compiled.steps
    assert {k[1] for k in steps if k[0] == "verify"} == widths
    assert ("draft", 1, False, False, False) in steps
    de.pool.check(holders=[])


def test_span_stage_steps_equal_direct_apply_across_a_move(weights,
                                                           checker):
    """A 2-stage pipeline: the first stage's step emits the residual
    stream (hidden_out), the second takes it (hidden_in).  A live span
    move rebuilds both stages' caches, so their steps are dropped there
    and built again on the next step; every call equals a direct apply."""
    params = weights["float32"]
    pe = PrefillEngine(PTINY, params, ECFG, device="cpu")
    dp = DecodePipeline(PTINY, params, ECFG, [(0, 2), (2, 4)],
                        device="cpu")
    checker.engines += dp.engines
    for rid, n in enumerate((14, 25, 33)):
        r = Request(rid=rid, arrival=0.0, prompt=_prompt(20 + rid, n),
                    max_new_tokens=8)
        st, lg = pe.run(r)
        dp.insert(r, st, int(torch.argmax(lg)))
    for _ in range(3):
        dp.step()
    assert [list(e.compiled.steps) for e in dp.engines] == [
        [("decode", 1, False, True, False)],
        [("decode", 1, True, False, False)]]
    assert dp.move_span(0, 1, 1)["kv_bytes"] > 0
    assert [len(e.compiled.steps) for e in dp.engines] == [0, 0]
    dp.step()
    assert [len(e.compiled.steps) for e in dp.engines] == [1, 1]
    while dp.active:
        dp.step()
    kinds = {c[:4] for c in checker.calls}
    assert kinds == {("decode", 1, False, True), ("decode", 1, True, False)}


def test_graph_switch_is_off_on_the_cpu(weights):
    """The CPU has no graphs: with or without ``cuda_graphs`` an engine
    runs its steps eagerly over the same static buffers."""
    for flag in (True, False):
        ecfg = dataclasses.replace(ECFG, cuda_graphs=flag)
        de = DecodeEngine(PTINY, weights["float32"], ecfg, device="cpu")
        assert de.compiled.graphed is False
        assert EngineConfig().cuda_graphs is True


# ---------------------------------------------------------------------------
# (b) compile_report against JAX
# ---------------------------------------------------------------------------

def test_compile_report_equals_jax():
    """The workload of JAX's bounded-compile test (2 layers, prompts of
    3-40 tokens in 4 batches of 4): the port's wave shapes and bound
    equal the JAX engine's, and stay under the bound."""
    jcfg = JModelConfig(name="pg-guard", family=JFamily.DENSE, n_layers=2,
                        d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                        vocab_size=64)
    pcfg = ModelConfig(name="pg-guard", family=Family.DENSE, n_layers=2,
                       d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                       vocab_size=64)
    jparams = JT.init(jcfg, jax.random.PRNGKey(2))
    jpe = JPrefill(jcfg, jparams, JEngineConfig(max_len=64, max_batch=4,
                                                block_size=8), None)
    ppe = PrefillEngine(pcfg, params_from_jax(
        pcfg, jax.tree.map(np.asarray, jparams), device="cpu"),
        EngineConfig(max_len=64, max_batch=4, block_size=8), device="cpu")
    rng = np.random.default_rng(11)
    rid = 0
    for _ in range(4):
        prompts = []
        for _ in range(4):
            prompts.append(rng.integers(0, 64, int(rng.integers(3, 40)),
                                        dtype=np.int32))
        jpe.run_batch([JRequest(rid=rid + i, arrival=0.0, prompt=p,
                                max_new_tokens=1)
                       for i, p in enumerate(prompts)])
        ppe.run_batch([Request(rid=rid + i, arrival=0.0, prompt=p,
                               max_new_tokens=1)
                       for i, p in enumerate(prompts)])
        rid += 4
    want, got = jpe.compile_report(), ppe.compile_report()
    assert got["shapes"] == [tuple(s) for s in want["shapes"]]
    assert got["bound"] == want["bound"]
    assert got["n_shapes"] == want["n_shapes"] <= got["bound"]
