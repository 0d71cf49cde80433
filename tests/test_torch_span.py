"""Layer-span serving of the port (``serving/span.py``, the span hooks of
``serving/engine.py`` and the orchestrator's migration control loop)
against the JAX package: pipelined greedy decode equals the monolithic
``greedy_reference`` rollout, before and after live span moves, slot
rebalances and role re-rolls; per-span states, merged to the wire format,
equal the JAX ``PrefillPipeline`` / ``DecodePipeline``'s on the same
inputs.  The cases mirror ``tests/test_layer_span.py`` (which imports the
JAX orchestrator and so does not collect on Python 3.12).

Tolerances: token streams, positions, lengths and byte counts exactly;
K/V leaves and logits ``1e-4`` (float32, four layers summed in another
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY, TINY_ECFG, assert_pools_restored
from repro.serving.request import Request as JRequest
from repro.serving.span import DecodePipeline as JDecodePipeline
from repro.serving.span import PrefillPipeline as JPrefillPipeline
from repro_torch.core import analytical as A
from repro_torch.core.layer_migration import even_spans
from repro_torch.core.migration import (DeviceLoad, MigrationAction,
                                        MigrationKind)
from repro_torch.models.config import BlockKind, Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.api import Server
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request
from repro_torch.serving.span import DecodePipeline, PrefillPipeline

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
def tp(tiny_params):
    return params_from_jax(PTINY, jax.tree.map(np.asarray, tiny_params),
                           device="cpu")


# one prompt set for the engine-level cases, in a narrow length band: the
# greedy reference (JAX) is memoized per prompt and compiles once per
# sequence length, which prompts of close lengths share
_RNG = np.random.default_rng(1)
PROMPTS = [_RNG.integers(0, 128, int(n), dtype=np.int32)
           for n in _RNG.integers(24, 29, 6)]


def _mk_requests(idx, max_new=8):
    return [Request(rid=i, arrival=0.0, prompt=PROMPTS[i].copy(),
                    max_new_tokens=max_new) for i in idx]


def _jax_requests(reqs):
    return [JRequest(rid=r.rid, arrival=0.0, prompt=r.prompt.copy(),
                     max_new_tokens=r.max_new_tokens) for r in reqs]


def _port_requests(jreqs):
    return [Request(rid=r.rid, arrival=r.arrival, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, prefix_id=r.prefix_id,
                    prefix_len=r.prefix_len) for r in jreqs]


def _assert_exact(reqs, tiny_params, greedy_reference):
    for r in reqs:
        assert r.generated == greedy_reference(
            TINY, tiny_params, r.prompt, r.max_new_tokens), r.rid


def _assert_state_equal(got, want):
    """A port wire state against a JAX one: K/V within TOL, positions,
    lengths and page counts exactly."""
    assert int(got["length"]) == int(want["length"])
    assert int(got.get("n_blocks", -1)) == int(want.get("n_blocks", -1))
    for part in ("groups", "rem"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# Span-partitioned pipelines == the monolithic stack (the Eq. 5 contract)
# ---------------------------------------------------------------------------

SPLITS = [even_spans(PTINY.n_layers, 2), [(0, 1), (1, PTINY.n_layers)],
          even_spans(PTINY.n_layers, 4)]


@pytest.mark.parametrize("bounds", SPLITS, ids=["2-even", "1-3", "4-way"])
def test_pipelined_fleet_token_exact(tp, tiny_params, greedy_reference,
                                     bounds):
    """Prefill and decode pipelines split 2 and 4 ways, even and skewed,
    decode the greedy rollout exactly; the span engines' weights are
    views of the full parameters."""
    pp = PrefillPipeline(PTINY, tp, ECFG, bounds, device="cpu")
    dp = DecodePipeline(PTINY, tp, ECFG, bounds, device="cpu")
    full = {t.untyped_storage().data_ptr()
            for g in tp["groups"] for t in g["attn"].values()}
    for e in pp.engines + dp.engines:
        for g in e.sparams["groups"]:
            for t in g["attn"].values():
                assert t.untyped_storage().data_ptr() in full
    reqs = _mk_requests(range(3))
    for r, (st, lg) in zip(reqs, pp.run_batch(reqs)):
        dp.insert(r, st, int(torch.argmax(lg)))
    while dp.active:
        dp.step()
    _assert_exact(reqs, tiny_params, greedy_reference)
    for e in dp.engines:
        assert len(e._free) == ECFG.max_batch * e._nb_slot


@pytest.mark.parametrize("bounds", SPLITS[:2], ids=["2-even", "1-3"])
def test_pipeline_states_match_jax(tp, tiny_params, bounds):
    """Prefill wire states (with a chunk-resume wave) and the decode
    pipeline's merged slot states after two steps equal the JAX
    pipelines' on the same requests."""
    reqs = _mk_requests(range(2))
    jreqs = _jax_requests(reqs)
    jecfg = dataclasses.replace(TINY_ECFG, decode_kernel=False)
    jpp = JPrefillPipeline(TINY, tiny_params, jecfg, bounds)
    jdp = JDecodePipeline(TINY, tiny_params, jecfg, bounds)
    pp = PrefillPipeline(PTINY, tp, ECFG, bounds, device="cpu")
    dp = DecodePipeline(PTINY, tp, ECFG, bounds, device="cpu")
    jout = jpp.run_batch(jreqs, chunk_tokens=12)
    pout = pp.run_batch(reqs, chunk_tokens=12)
    for r, jr, (pst, plg), (jst, jlg) in zip(reqs, jreqs, pout, jout):
        _assert_state_equal(pst, jst)
        np.testing.assert_allclose(plg.numpy(), np.asarray(jlg), **TOL)
        dp.insert(r, pst, int(torch.argmax(plg)))
        jdp.insert(jr, jst, int(jnp.argmax(jlg)))
    for _ in range(2):
        dp.step()
        jdp.step()
    for slot in range(len(reqs)):
        req, st, tok = dp.extract_slot(slot)
        jreq, jst, jtok = jdp.extract_slot(slot)
        assert req.generated == jreq.generated and tok == jtok
        _assert_state_equal(st, jst)


def test_span_wire_interop_with_full_stack_engines(tp, tiny_params,
                                                   greedy_reference):
    """Mid-flight slots move pipeline -> full-stack engine and back: every
    edge speaks the full-stack wire format."""
    bounds = even_spans(PTINY.n_layers, 2)
    pp = PrefillPipeline(PTINY, tp, ECFG, bounds, device="cpu")
    dp = DecodePipeline(PTINY, tp, ECFG, bounds, device="cpu")
    mono = DecodeEngine(PTINY, tp, ECFG, name="mono", device="cpu")
    reqs = _mk_requests(range(2))
    for r, (st, lg) in zip(reqs, pp.run_batch(reqs)):
        dp.insert(r, st, int(torch.argmax(lg)))
    for _ in range(2):
        dp.step()
    req, st, tok = dp.extract_slot(0)
    mono.adopt(req, st, tok)
    for _ in range(2):
        dp.step()
        mono.step()
    req, st, tok = mono.extract_slot(0)
    dp.adopt(req, st, tok)
    while dp.active:
        dp.step()
    _assert_exact(reqs, tiny_params, greedy_reference)


# ---------------------------------------------------------------------------
# Live boundary moves between decode steps
# ---------------------------------------------------------------------------

def test_span_move_under_load_token_exact(tp, tiny_params, greedy_reference):
    """Greedy decode stays exact when layer spans move mid-stream, forward
    and back, with a request inserted after the first move."""
    bounds = even_spans(PTINY.n_layers, 2)
    pp = PrefillPipeline(PTINY, tp, ECFG, bounds, device="cpu")
    dp = DecodePipeline(PTINY, tp, ECFG, bounds, device="cpu")
    reqs = _mk_requests(range(2), max_new=10)
    for r, (st, lg) in zip(reqs, pp.run_batch(reqs)):
        dp.insert(r, st, int(torch.argmax(lg)))
    for _ in range(3):
        dp.step()
    rec = dp.move_span(0, 1, 1)
    assert rec is not None and rec["layers"] == 1
    assert dp.bounds == [(0, 1), (1, 4)]
    for _ in range(2):
        dp.step()
    late = _mk_requests([2], max_new=6)[0]
    st, lg = pp.run(late)
    dp.insert(late, st, int(torch.argmax(lg)))
    dp.step()
    assert dp.move_span(1, 0, 2)["layers"] == 2
    assert dp.bounds == [(0, 3), (3, 4)]
    while dp.active:
        dp.step()
    _assert_exact(reqs + [late], tiny_params, greedy_reference)


def _move_payload(cfg, params, ecfg, k, pipe_cls, prefill_cls, req_cls,
                  argmax, **dev):
    dp = pipe_cls(cfg, params, ecfg, [(0, 3), (3, 4)], **dev)
    pe = prefill_cls(cfg, params, ecfg, None, **dev)
    r = req_cls(rid=0, arrival=0.0, prompt=np.arange(24, dtype=np.int32),
                max_new_tokens=100)
    st, lg = pe.run(r)
    dp.insert(r, st, int(argmax(lg)))
    dp.step()
    return dp.move_span(0, 1, k)


def test_span_move_payload_scales_with_span(tp, tiny_params):
    """The migrated payload is the moved span's weights and KV: k layers
    cost ~k times one layer, never the whole stack; the byte counts equal
    JAX's."""
    from repro.serving.engine import PrefillEngine as JPrefill
    got = {k: _move_payload(PTINY, tp, ECFG, k, DecodePipeline,
                            PrefillEngine, Request, torch.argmax,
                            device="cpu") for k in (1, 2)}
    for k, rec in got.items():
        assert rec["layers"] == k
        want = _move_payload(TINY, tiny_params, TINY_ECFG, k,
                             JDecodePipeline, JPrefill, JRequest,
                             jnp.argmax)
        assert (rec["weight_bytes"], rec["kv_bytes"]) == \
            (want["weight_bytes"], want["kv_bytes"])
        assert rec["schedule"] == want["schedule"]
    one, two = (got[k]["weight_bytes"] + got[k]["kv_bytes"] for k in (1, 2))
    assert 1.8 * one <= two <= 2.2 * one


def test_span_move_schedule_is_per_moved_layer(tp):
    """The move's ordered schedule names exactly the moved layers (absolute
    indices) and its bytes add up to the billed payload."""
    rec = _move_payload(PTINY, tp, ECFG, 2, DecodePipeline, PrefillEngine,
                        Request, torch.argmax, device="cpu")
    assert [l for l, _ in rec["schedule"]] == [1, 2]     # layers [1, 3)
    assert sum(b for _, b in rec["schedule"]) == \
        rec["weight_bytes"] + rec["kv_bytes"]
    nbytes = [b for _, b in rec["schedule"]]
    bw = A.H100_SXM.net_bw
    assert A.overlapped_schedule_time(nbytes, bw, 1e-4, t_sync=0.0) <= \
        A.serial_schedule_time(nbytes, bw, 1e-4, t_sync=0.0) + 1e-12


def test_prefill_pipeline_span_move(tp, tiny_params, greedy_reference):
    """Prefill stages re-slice live (no resident state): requests
    prefilled across the new cut, one of them resumed chunk by chunk over
    the chain's dense caches, still match the monolith; emptying a stage
    is refused."""
    pp = PrefillPipeline(PTINY, tp, ECFG, even_spans(PTINY.n_layers, 2),
                         device="cpu")
    dp = DecodePipeline(PTINY, tp, ECFG, even_spans(PTINY.n_layers, 2),
                        device="cpu")
    def serve(i, chunk=None):
        r = _mk_requests([i], max_new=5)[0]
        (st, lg), = pp.run_batch([r], chunk_tokens=chunk)
        dp.insert(r, st, int(torch.argmax(lg)))
        while dp.active:
            dp.step()
        _assert_exact([r], tiny_params, greedy_reference)

    serve(3)
    assert pp.move_span(0, 1, 1) == 1
    assert pp.bounds == [(0, 1), (1, 4)]
    serve(4, chunk=8)
    assert pp.move_span(0, 1, 1) is None         # would empty stage 0
    assert pp.move_span(1, 0, 2) == 2
    assert pp.bounds == [(0, 3), (3, 4)]
    serve(5, chunk=5)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_span_move_refuses_to_empty_a_stage(tp, kind):
    cls = DecodePipeline if kind == "decode" else PrefillPipeline
    pipe = cls(PTINY, tp, ECFG, [(0, 1), (1, 4)], device="cpu")
    assert pipe.move_span(0, 1, 1) is None        # would leave 0 layers
    moved = pipe.move_span(1, 0, 99)               # clamped to span - 1
    assert (moved["layers"] if kind == "decode" else moved) == 2
    assert pipe.bounds == [(0, 3), (3, 4)]
    with pytest.raises(ValueError, match="adjacent"):
        pipe.move_span(0, 2, 1)


def test_int8_pipeline_streams_equal_jax(tp, tiny_params):
    """int8 KV through pipelines, as JAX serves it: the same streams as the
    JAX int8 DecodePipeline across a span move; a prompt longer than
    ``chunk_tokens`` is refused (JAX cannot resume it either)."""
    q, jq = PTINY.with_kv_quant(), TINY.with_kv_quant()
    bounds = even_spans(PTINY.n_layers, 2)
    prompts = [np.arange(5 + 7 * i, 25 + 7 * i, dtype=np.int32) % 128
               for i in range(2)]
    streams = []
    for side in ("port", "jax"):
        if side == "port":
            pp = PrefillPipeline(q, tp, ECFG, bounds, device="cpu")
            dp = DecodePipeline(q, tp, ECFG, bounds, device="cpu")
            mk, am = Request, torch.argmax
        else:
            jecfg = dataclasses.replace(TINY_ECFG, decode_kernel=False)
            pp = JPrefillPipeline(jq, tiny_params, jecfg, bounds)
            dp = JDecodePipeline(jq, tiny_params, jecfg, bounds)
            mk, am = JRequest, jnp.argmax
        reqs = [mk(rid=i, arrival=0.0, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r, (st, lg) in zip(reqs, pp.run_batch(reqs)):
            dp.insert(r, st, int(am(lg)))
        dp.step()
        assert dp.move_span(0, 1, 1)["layers"] == 1
        while dp.active:
            dp.step()
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]
    pp = PrefillPipeline(q, tp, ECFG, bounds, device="cpu")
    long = Request(rid=9, arrival=0.0, prompt=prompts[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="int8 KV cannot resume"):
        pp.prefill_waves([long], chunk_tokens=8)


MIXED = ModelConfig(name="mix-span", family=Family.DENSE, n_layers=4,
                    d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                    vocab_size=64, local_window=16,
                    block_pattern=(BlockKind.ATTENTION,
                                   BlockKind.LOCAL_ATTENTION))
MIXED_ECFG = EngineConfig(max_len=64, max_batch=2, block_size=8)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mixed_arch_span_pipeline_token_exact(kind, model_zoo,
                                              greedy_reference):
    """JAX's mixed-stack case: a ring-only stage (a lone 16-token window,
    paged at its own window) de-pages at the wire, and the tokens still
    equal the monolith's across a live span move of the decode pipeline
    (``kind`` "decode"), or of the prefill pipeline between waves
    (``kind`` "prefill")."""
    from repro.models.config import BlockKind as JBlockKind
    from repro.models.config import Family as JFamily
    from repro.models.config import ModelConfig as JModelConfig
    jmixed = JModelConfig(name="mix-span", family=JFamily.DENSE, n_layers=4,
                          d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                          vocab_size=64, local_window=16,
                          block_pattern=(JBlockKind.ATTENTION,
                                         JBlockKind.LOCAL_ATTENTION))
    jp = model_zoo(jmixed)
    params = params_from_jax(MIXED, jax.tree.map(np.asarray, jp),
                             device="cpu")
    bounds = [(0, 3), (3, 4)]            # stage 1 hosts a lone ring layer
    pp = PrefillPipeline(MIXED, params, MIXED_ECFG, bounds, device="cpu")
    dp = DecodePipeline(MIXED, params, MIXED_ECFG, bounds, device="cpu")
    assert [e.page_len for e in dp.engines] == [64, 16]
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, arrival=0.0, max_new_tokens=8,
                    prompt=rng.integers(0, 64, int(n), dtype=np.int32))
            for i, n in enumerate(rng.integers(10, 30, 2))]
    if kind == "prefill":
        assert pp.move_span(0, 1, 1) == 1
        assert pp.bounds == [(0, 2), (2, 4)]
    for r, (st, lg) in zip(reqs, pp.run_batch(reqs, chunk_tokens=8)):
        dp.insert(r, st, int(torch.argmax(lg)))
    for _ in range(3):
        dp.step()
    if kind == "decode":
        assert dp.move_span(0, 1, 1)["layers"] == 1
        assert dp.bounds == [(0, 2), (2, 4)]
    while dp.active:
        dp.step()
    for r in reqs:
        assert r.generated == greedy_reference(jmixed, jp, r.prompt,
                                               r.max_new_tokens), r.rid


# ---------------------------------------------------------------------------
# The orchestrator: span moves, rebalances, re-rolls and Algorithm 1
# ---------------------------------------------------------------------------

def _orch(tp, **kw):
    kw.setdefault("migration", False)
    return Orchestrator(PTINY, tp, OrchestratorConfig(engine=ECFG, **kw),
                        device="cpu")


def _drive(orch, n):
    while orch.metrics.n_requests < n:
        orch.step()


def test_orchestrator_config_defaults():
    """The controller defaults are JAX's, built per config (R1 does not
    recur), and the fleet bills the H100 by default."""
    a, b = OrchestratorConfig(), OrchestratorConfig()
    assert a.controller == b.controller and a.controller is not b.controller
    c = a.controller
    assert (c.delta_up, c.delta_down, c.rho, c.max_actions_per_cycle) == \
        (0.5, 0.25, 0.5, 2)
    assert a.migration and a.decode_split == 1 and a.hw is A.H100_SXM


def test_orchestrator_span_move_before_and_after_exact(tp, tiny_params,
                                                       greedy_reference,
                                                       make_workload):
    """decode_split=2: greedy tokens are exact before and after a live
    LAYER span move applied mid-run, the move re-cuts the pipeline
    instead of re-rolling, and the payload is logged."""
    orch = _orch(tp, n_prefill=1, n_decode=1, decode_split=2)
    assert orch.fleet == {"prefill0": "prefill", "decode0.0": "decode",
                          "decode0.1": "decode"}
    reqs = _port_requests(make_workload(6, max_new=8))
    for r in reqs:
        orch.submit(r)
    for _ in range(3):
        orch.step()
    assert orch.decode_pipes[0].active > 0
    act = MigrationAction(MigrationKind.LAYER, src="decode0.0",
                          dst="decode0.1", amount=1,
                          predicted_benefit=1.0, predicted_cost=1e-3)
    assert orch.apply_action(act)
    assert orch.decode_pipes[0].bounds == [(0, 1), (1, 4)]
    assert orch.fleet["decode0.0"] == "decode"
    _drive(orch, len(reqs))
    s = orch.summary()
    assert s["span_moves"] == 1 and s["span_bytes_moved"] > 0
    assert s["span_bounds"]["decode0"] == [(0, 1), (1, 4)]
    _assert_exact(reqs, tiny_params, greedy_reference)
    assert_pools_restored(orch)


def test_orchestrator_span_stages_never_reroll(tp):
    """LAYER actions between a stage and anything outside its pipeline are
    refused: stages re-slice spans, not roles."""
    orch = _orch(tp, n_prefill=1, n_decode=2, decode_split=2)
    for src, dst in (("decode0.1", "prefill0"), ("decode0.0", "decode1.0")):
        act = MigrationAction(MigrationKind.LAYER, src=src, dst=dst,
                              amount=1, predicted_benefit=1.0,
                              predicted_cost=1e-3)
        assert not orch.apply_action(act)
    assert orch.fleet["prefill0"] == "prefill"
    assert len(orch.migration_log) == 0


def test_controller_never_prices_stage_reroll(tp, make_workload):
    """A hot stage paired with a cold full-stack member prices at benefit
    0, so the controller never plans actions apply_action refuses; every
    LAYER action applied on a split fleet is a same-pipeline span move."""
    orch = _orch(tp, n_prefill=2, n_decode=1, decode_split=2,
                 migration=True)
    hot = DeviceLoad(device="decode0.0", compute_frac=1.0, memory_frac=1.0)
    cold = DeviceLoad(device="prefill0", compute_frac=0.0, memory_frac=0.0)
    benefit, _ = orch._migration_cost(MigrationKind.LAYER, hot, cold, 2)
    assert benefit == 0.0
    for r in _port_requests(make_workload(6, max_new=8)):
        orch.submit(r)
    _drive(orch, 6)
    for act in orch.migration_log:
        if act.kind == MigrationKind.LAYER:
            src, dst = orch._by_name[act.src], orch._by_name[act.dst]
            assert src.pipe is not None and src.pipe is dst.pipe


def test_orchestrator_rebalance_across_pipelines(tp, tiny_params,
                                                 greedy_reference,
                                                 make_workload):
    """KV_HEADS between two pipelines with different cuts: slots merge to
    the wire format on exit and re-split at the target's cuts."""
    orch = _orch(tp, n_prefill=1, n_decode=2, decode_split=2)
    assert orch.decode_pipes[1].move_span(0, 1, 1) is not None
    reqs = _port_requests(make_workload(6, max_new=8))[:3]
    for r in reqs:
        orch.submit(r)
    while sum(u.active for u in orch.decode_pipes) < len(reqs):
        orch.step()
    # pile every resident onto one pipeline (wire-format extract/adopt)
    src, dst = sorted(orch.decode_pipes, key=lambda u: -u.active)
    for slot, r in enumerate(dst.slots):
        if r is not None:
            src.adopt(*dst.extract_slot(slot))
    assert (src.active, dst.active) == (3, 0)
    act = MigrationAction(MigrationKind.KV_HEADS, src=src.lead.name,
                          dst=dst.lead.name, amount=1,
                          predicted_benefit=1.0, predicted_cost=1e-3)
    assert orch.apply_action(act)
    assert (src.active, dst.active) == (2, 1)
    _drive(orch, len(reqs))
    _assert_exact(reqs, tiny_params, greedy_reference)
    assert_pools_restored(orch)


@pytest.mark.parametrize("direction", ["prefill->decode", "decode->prefill"])
def test_forced_reroll_exact(tp, tiny_params, greedy_reference,
                             make_workload, direction):
    """A whole-instance role re-roll mid-run, in each direction: a prefill
    member becomes a decode engine (its queue re-routes), or a decode
    engine drains its residents to a peer and becomes a prefill member
    (its store pages are demoted first).  Streams stay exact."""
    orch = _orch(tp, n_prefill=2, n_decode=2)
    reqs = _port_requests(make_workload(6, max_new=8))[:3]
    for r in reqs:
        orch.submit(r)
    if direction == "prefill->decode":
        name, src = "prefill1", "decode0"
        orch.step()
        while orch._by_name[name].busy or orch._by_name[name]._wavegen:
            orch.step()
    else:
        # the residents must fit on the other decode engine
        name, src = "decode1", "prefill0"
        while orch._reserved or not orch._by_name[name].decode.active:
            orch.step()
    act = MigrationAction(MigrationKind.LAYER, src=src, dst=name,
                          amount=PTINY.n_layers, predicted_benefit=1.0,
                          predicted_cost=1e-3)
    assert orch.apply_action(act)
    m = orch._by_name[name]
    assert m.rerolled and m.role == orch._by_name[src].role
    _drive(orch, len(reqs))
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED
    _assert_exact(reqs, tiny_params, greedy_reference)
    assert_pools_restored(orch)


def test_algorithm1_serves_exact_through_server(tp, tiny_params,
                                                greedy_reference,
                                                make_workload):
    """``migration=True`` on a split fleet through ``Server``: Algorithm 1
    plans on its own every control interval, applies what it plans, and
    the streams equal the greedy rollout; the summary carries the span
    keys JAX's tests read."""
    orch = _orch(tp, n_prefill=1, n_decode=2, decode_split=2,
                 migration=True, chunk_tokens=16)
    # a skewed cut: the stage hosting 3 of 4 layers reads 3x as hot
    assert orch.decode_pipes[0].move_span(0, 1, 1)["layers"] == 1
    reqs = _port_requests(make_workload(6, max_new=8))
    for r in reqs:
        r.arrival = 0.0            # one burst: both pipelines fill up
    s = Server(orch).run(reqs)
    assert orch.util_trace, "the control loop never ran"
    assert orch.span_move_log, "Algorithm 1 moved no span"
    assert all(a.predicted_benefit / a.predicted_cost
               >= orch.ocfg.controller.rho for a in orch.migration_log)
    assert s["migrations"] == len(orch.migration_log)
    assert s["span_moves"] == len(orch.span_move_log)
    assert set(s["span_bounds"]) == {"decode0", "decode1"}
    _assert_exact(reqs, tiny_params, greedy_reference)
    assert_pools_restored(orch)
