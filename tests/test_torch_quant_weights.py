"""Int8 weights of the port against the JAX package: ``models/quant.py``
(``quantize_weights``, ``dequant``, the int8 KV page helpers), the
quantized stack forward (``forward_train``, ``prefill``, ``decode_step``)
on JAX's own quantized tree through ``params_from_jax``, quantized TINY
served through ``Server``, and a span move over quantized views.

Every input is made with numpy or JAX's ``init`` from a seed and handed to
both sides.  Tolerances: int8 values and f32 scales exactly equal (the
same f32 arithmetic, rounding half to even on both sides); logits 1e-4
(float32, summed in another order); token streams and byte counts
exactly.  About 35 s on one CPU worker, most of it the JAX greedy
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY, TINY_ECFG
from repro.core import layer_migration as JLM
from repro.models import quant as JQ
from repro.models import transformer as JT
from repro_torch.core import layer_migration as LM
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.api import Server
from repro_torch.serving.engine import EngineConfig, PrefillEngine
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request
from repro_torch.serving.span import DecodePipeline

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
def jq(tiny_params):
    """JAX's quantized TINY tree."""
    return JQ.quantize_weights(tiny_params)


@pytest.fixture(scope="module")
def pq(jq):
    """The same quantized tree in the port, through numpy."""
    return params_from_jax(PTINY, jax.tree.map(np.asarray, jq), device="cpu")


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_equals_jax(tiny_params, dtype):
    """Every int8 value and scale equals JAX's on the same tree: stacked
    leaves one scale per layer, other matrices one per tensor, norms left
    as they are."""
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), tiny_params)
    port = params_from_jax(PTINY, jax.tree.map(np.asarray, jp), device="cpu")
    got = Q.quantize_weights(port)
    want = JQ.quantize_weights(jp)
    n_q = 0
    for path, leaf in _leaves_with_path(got):
        w = _get(want, path)
        if Q.is_quantized(leaf):
            n_q += 1
            assert JQ.is_quantized(w), path
            assert leaf["q"].dtype == torch.int8
            np.testing.assert_array_equal(leaf["q"].numpy(),
                                          np.asarray(w["q"]), err_msg=path)
            np.testing.assert_array_equal(leaf["s"].numpy(),
                                          np.asarray(w["s"]), err_msg=path)
            stacked = path[0] == "groups"
            assert tuple(leaf["s"].shape) == \
                ((leaf["q"].shape[0],) if stacked else ())
        else:
            assert not JQ.is_quantized(w), path
            assert leaf is _get(port, path)
    # embed + 7 matrices of the one stacked group (wq wk wv wo, 3 MLP)
    assert n_q == 8
    assert not Q.is_quantized(got["groups"][0]["norm1"])


def test_dequant_roundtrip_error_bounded():
    """Half a step of the int8 grid at most, as JAX's own bound; the page
    helpers equal JAX's."""
    x = np.random.default_rng(3).normal(size=(64, 128)).astype(np.float32)
    x *= 3.0
    q = Q.quantize_weights({"w": torch.as_tensor(x)})["w"]
    back = Q.dequant(q, torch.float32)
    err = float((back - torch.as_tensor(x)).abs().max())
    assert err <= float(q["s"]) * 0.51 + 1e-6
    pages = np.random.default_rng(4).normal(size=(3, 8, 2, 16)) \
        .astype(np.float32)
    kq, ks, vq, vs = Q.quantize_kv_pages(torch.as_tensor(pages),
                                         torch.as_tensor(2 * pages))
    jkq, jks, jvq, jvs = JQ.quantize_kv_pages(jnp.asarray(pages),
                                              jnp.asarray(2 * pages))
    for g, w in ((kq, jkq), (ks, jks), (vq, jvq), (vs, jvs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        Q.dequantize_kv_page(kq, ks, torch.float32).numpy(),
        np.asarray(JQ.dequantize_kv_page(jkq, jks, jnp.float32)), **TOL)


def test_quantized_forward_matches_jax(jq, pq):
    """``forward_train`` and ``prefill`` then ``decode_step`` on JAX's
    quantized tree: the port's logits against JAX's."""
    toks = np.random.default_rng(5).integers(0, 128, (2, 24))
    got, _ = T.forward_train(PTINY, pq, torch.as_tensor(toks))
    want, _ = JT.forward_train(TINY, jq, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cache = T.init_cache(PTINY, 2, 64, device="cpu")
    lg, cache, _ = T.prefill(PTINY, pq, torch.as_tensor(toks), cache)
    jcache = JT.init_cache(TINY, 2, 64)
    jlg, jcache, _ = JT.prefill(TINY, jq, jnp.asarray(toks), jcache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    nxt = np.array(jnp.argmax(jlg, -1))[:, None]
    lg2, _, _ = T.decode_step(PTINY, pq, torch.as_tensor(nxt), cache)
    jlg2, _, _ = JT.decode_step(TINY, jq, jnp.asarray(nxt), jcache)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(jlg2), **TOL)


def _requests(n, max_new=6):
    rng = np.random.default_rng(7)
    return [Request(rid=i, arrival=0.0,
                    prompt=rng.integers(0, 128, 20 + 3 * i).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def test_quantized_served_stream_is_the_greedy_rollout(jq, pq,
                                                       greedy_reference):
    """Quantized TINY through ``Server`` (16-token chunks resumed over
    paged waves, paged decode): every stream equals the greedy rollout of
    the same quantized weights under JAX."""
    reqs = _requests(3)
    orch = Orchestrator(PTINY, pq, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ECFG, chunk_tokens=16),
        device="cpu")
    Server(orch).run(reqs)
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED
        assert r.generated == greedy_reference(TINY, jq, r.prompt,
                                               r.max_new_tokens), r.rid


def test_span_move_over_quantized_views(jq, pq, greedy_reference):
    """A 2-stage pipeline over quantized weights: the stages' leaves are
    views of the quantized tensors (values and scales cut per layer), a
    span move mid-stream keeps the streams the greedy rollout, and the
    weight bytes it accounts (int8 values plus f32 scales) equal JAX's
    bytes of the same quantized layer."""
    dp = DecodePipeline(PTINY, pq, ECFG, [(0, 2), (2, 4)], device="cpu")
    views = {t.untyped_storage().data_ptr()
             for e in dp.engines for t in LM._leaves(e.sparams["groups"])}
    owned = {t.untyped_storage().data_ptr() for t in LM._leaves(pq)}
    assert views <= owned
    assert dp.engines[1].sparams["groups"][0]["attn"]["wq"]["s"].shape \
        == (1,)
    pe = PrefillEngine(PTINY, pq, ECFG, device="cpu")
    reqs = _requests(2, max_new=8)
    for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
        dp.insert(r, st, int(torch.argmax(lg)))
    dp.step()
    rec = dp.move_span(0, 1, 1)
    while dp.active:
        dp.step()
    for r in reqs:
        assert r.generated == greedy_reference(TINY, jq, r.prompt, 8), r.rid
    # the moved layer is layer 1: JAX's bytes of its quantized leaves
    jlayer = JLM.unstack_layers(TINY, jq)[1][1]
    assert rec["layers"] == 1 and rec["kv_bytes"] > 0
    assert rec["weight_bytes"] == JLM.layer_param_bytes(jlayer)
    layer = LM.unstack_layers(PTINY, pq)[1][1]
    assert rec["weight_bytes"] == LM.layer_param_bytes(layer) < \
        LM.layer_param_bytes(Q.dequant_tree(layer, torch.float32))
