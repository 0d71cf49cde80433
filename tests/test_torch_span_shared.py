"""The span pipelines' shared-page surface and lead-stage delegates
(``serving/span.py``) and the orchestrator's per-member decode counter,
held to the JAX package.

* A live span move while two pipeline slots share prefix pages on every
  stage mirrors ``tests/test_prefix_sharing.py::
  test_move_span_with_shared_prefix_in_flight`` (which imports the JAX
  orchestrator and so does not collect on Python 3.12): both streams
  equal ``greedy_reference``, and the JAX ``DecodePipeline`` driven by the
  same calls reports the same pages, shares, delegates and tokens.
* ``PrefillPipeline.queue``/``enqueue``/``load_report``/``run_queued``
  against JAX's on the same calls.
* ``_Member.tokens_decoded`` against the JAX orchestrator, loaded as
  ``repro.serving._orchestrator_oracle`` (``test_torch_frontdoor.py``).

Tolerances: token streams, page ids, counters and load reports exactly;
prefilled K/V within ``1e-4`` (float32).  ~25 s on one CPU worker, most
of it the JAX pipelines and the greedy reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY, TINY_ECFG
from repro.models import kvcache as JKC
from repro.serving.engine import PrefillEngine as JPrefillEngine
from repro.serving.request import Request as JRequest
from repro.serving.span import DecodePipeline as JDecodePipeline
from repro.serving.span import PrefillPipeline as JPrefillPipeline
from repro_torch.core import analytical as A
from repro_torch.core.layer_migration import even_spans
from repro_torch.models import kvcache as KC
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import EngineConfig, PrefillEngine
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Request
from repro_torch.serving.span import DecodePipeline, PrefillPipeline
from test_torch_frontdoor import oracle  # noqa: F401  (a fixture)

PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
ECFG = EngineConfig(max_len=TINY_ECFG.max_len, max_batch=TINY_ECFG.max_batch,
                    block_size=TINY_ECFG.block_size)
BS = ECFG.block_size
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


def _shared_prefix_run(side, prompt):
    """The mirrored scenario on one package: r1 inserted, r2 bound to r1's
    first two blocks on every stage, 3 steps, a live 1-layer move, then
    decode to the end.  Returns what each check reads."""
    pe, pipe, Req, split, argmax = side
    r1 = Req(rid=0, arrival=0.0, prompt=prompt.copy(), max_new_tokens=8)
    st1, lg1 = pe.run(r1)
    s1 = pipe.insert(r1, st1, argmax(lg1))
    pages = pipe.slot_pages(s1)[:2]
    r2 = Req(rid=1, arrival=0.0, prompt=prompt.copy(), max_new_tokens=8)
    st2, lg2 = pe.run(r2)
    s2 = pipe.insert(r2, split(st2, 2, BS), argmax(lg2),
                     shared_pages=pages)
    out = {"slots": (s1, s2), "pages": pages,
           "pages2": pipe.slot_pages(s2),
           "shared": [e.pages_shared for e in pipe.engines],
           "free_slot": pipe.free_slot()}
    for _ in range(3):
        pipe.step()
    out["decoded_before_move"] = pipe.tokens_decoded
    res = pipe.move_span(0, 1, 1)
    out["moved"] = res["layers"] if res is not None else None
    out["bounds"] = [tuple(b) for b in pipe.bounds]
    while pipe.active:
        pipe.step()
    out["decoded"] = pipe.tokens_decoded
    out["free_slot_after"] = pipe.free_slot()
    out["streams"] = (r1.generated, r2.generated)
    return out


def test_move_span_with_shared_prefix_in_flight(tp, tiny_params,
                                                greedy_reference):
    """Two pipeline slots share 2 prefix pages on both stages; a live
    1-layer span move gathers the shared content and re-adopts it
    unshared; neither stream moves off the greedy rollout, every stage's
    pool is whole afterwards, and the JAX pipeline on the same calls
    agrees on pages, shares, delegates and tokens."""
    bounds = even_spans(PTINY.n_layers, 2)
    prompt = np.random.default_rng(3).integers(0, PTINY.vocab_size, 16,
                                                dtype=np.int32)
    pipe = DecodePipeline(PTINY, tp, ECFG, bounds, device="cpu")
    port = (PrefillEngine(PTINY, tp, ECFG, None, device="cpu"), pipe,
            Request, KC.split_paged_state,
            lambda lg: int(torch.argmax(lg)))
    got = _shared_prefix_run(port, prompt)
    jpipe = JDecodePipeline(TINY, tiny_params, TINY_ECFG, bounds)
    jside = (JPrefillEngine(TINY, tiny_params, TINY_ECFG, None), jpipe,
             JRequest, JKC.split_paged_state,
             lambda lg: int(jnp.argmax(lg)))
    want = _shared_prefix_run(jside, prompt)

    assert got["shared"] == [2, 2]
    assert all(len(t) == 2 for t in got["pages"])   # one page per stage
    assert got["pages2"][:2] == got["pages"]         # bound by reference
    assert got["moved"] == 1 and got["bounds"] == [(0, 1), (1, 4)]
    ref = greedy_reference(TINY, tiny_params, prompt, 8)
    assert got["streams"] == (ref, ref)
    for e in pipe.engines:                     # every stage pool restored
        e.pool.check(holders=[])
        assert len(e._free) == ECFG.max_batch * e._nb_slot
    norm = {k: ([tuple(int(p) for p in t) for t in v]
                if k in ("pages", "pages2") else v) for k, v in want.items()}
    assert got == norm


def test_shared_pages_refuse_dense_stages(tp):
    """A pipeline on dense rows (``max_len`` not a multiple of the block)
    has no pages to bind: the engine's refusal, per stage, as JAX's
    assertion."""
    ecfg = EngineConfig(max_len=100, max_batch=2, block_size=8)
    pipe = DecodePipeline(PTINY, tp, ecfg, even_spans(PTINY.n_layers, 2),
                          device="cpu")
    pe = PrefillEngine(PTINY, tp, ecfg, None, device="cpu")
    req = Request(rid=0, arrival=0.0, prompt=np.arange(20, dtype=np.int32),
                  max_new_tokens=2)
    st, lg = pe.run(req)
    with pytest.raises(ValueError, match="paged"):
        pipe.insert(req, st, int(torch.argmax(lg)),
                    shared_pages=[(1, 1)])
    assert pipe.active == 0


def test_prefill_pipeline_delegates_match_jax(tp, tiny_params):
    """``queue``, ``enqueue`` (which names the pipeline on the request),
    ``load_report`` and ``run_queued`` go to the lead stage, as JAX's."""
    bounds = even_spans(PTINY.n_layers, 2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, int(n), dtype=np.int32)
               for n in (20, 27, 33)]
    pp = PrefillPipeline(PTINY, tp, ECFG, bounds, name="pp7", device="cpu")
    jp = JPrefillPipeline(TINY, tiny_params, TINY_ECFG, bounds, name="pp7")
    reqs = [Request(rid=i, arrival=0.0, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    jreqs = [JRequest(rid=i, arrival=0.0, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    for r, jr in zip(reqs, jreqs):
        pp.enqueue(r)
        jp.enqueue(jr)
    assert [r.prefill_instance for r in reqs] == ["pp7"] * 3 == \
        [r.prefill_instance for r in jreqs]
    assert pp.queue is pp.lead.queue and len(pp.queue) == len(jp.queue) == 3
    assert vars(pp.load_report()) == vars(jp.load_report())
    got, want = pp.run_queued(2), jp.run_queued(2)
    assert [r.rid for r, _, _ in got] == [r.rid for r, _, _ in want] == [0, 1]
    for (_, st, lg), (_, jst, jlg) in zip(got, want):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        assert int(st["length"]) == int(jst["length"])
        np.testing.assert_allclose(st["groups"][0]["k"].numpy(),
                                   np.asarray(jst["groups"][0]["k"]), **TOL)
    assert [r.rid for r in pp.queue] == [r.rid for r in jp.queue] == [2]
    assert vars(pp.load_report()) == vars(jp.load_report())
    assert pp.run_queued(0) == [] == jp.run_queued(0)


def _member_counts(orch, reqs):
    for r in reqs:
        orch.submit(r)
    while orch.metrics.n_requests < len(reqs):
        orch.step()
    return {m.name: (m.role, m.tokens_decoded) for m in orch.members}


@pytest.mark.parametrize("fleet", [dict(n_prefill=1, n_decode=2),
                                   dict(n_prefill=1, n_decode=1,
                                        decode_split=2)],
                         ids=["two-engines", "2-stage-pipeline"])
def test_member_tokens_decoded_match_oracle(oracle, tp, tiny_params,  # noqa: F811
                                            make_workload, fleet):
    """Each member's ``tokens_decoded`` after a served workload equals the
    JAX orchestrator's; a pipeline counts on its lead stage."""
    jreqs = make_workload(6, max_new=6)
    want = _member_counts(oracle.Orchestrator(
        TINY, tiny_params, oracle.OrchestratorConfig(
            engine=TINY_ECFG, migration=False, **fleet)), jreqs)
    preqs = [Request(rid=r.rid, arrival=r.arrival, prompt=r.prompt,
                     max_new_tokens=r.max_new_tokens, prefix_id=r.prefix_id,
                     prefix_len=r.prefix_len) for r in make_workload(
                         6, max_new=6)]
    got = _member_counts(Orchestrator(PTINY, tp, OrchestratorConfig(
        engine=ECFG, migration=False, hw=A.TPU_V5E, **fleet),
        device="cpu"), preqs)
    assert got == want
    decoded = sum(n for role, n in got.values() if role == "decode")
    # every token after each request's first comes from a decode step
    assert decoded == sum(len(r.generated) - 1 for r in preqs) > 0
