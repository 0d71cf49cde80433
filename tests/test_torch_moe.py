"""The port's top-k MoE (``models/layers.py`` ``init_moe``/``moe_apply``)
and the MoE stacks it serves, against the JAX package.

``moe_apply`` is held to JAX ``L.moe_apply`` on the same inputs and
weights for each impl: dense, sorted with no drop (what serving runs) and
sorted at a capacity factor that drops pairs.  The stacks are
granite-moe-3b-a800m and grok-1-314b at their ``smoke()`` sizes and in
two small variants that keep each arch's GQA ratio and head_dim:
"granite-moe-gqa" (4 layers, 6/2 heads, head_dim 64, 40 experts top-8)
and "grok-gqa" (2 layers, 12/2 heads, head_dim 32, 8 experts top-2,
GEGLU, untied).  They run train, fresh prefill, paged decode, paged
verify and paged resume against JAX ``T.apply`` (the GQA variants also
over int8 KV: prefill, decode and verify), are served through the
port's ``Orchestrator`` and a 2-stage ``DecodePipeline`` against
``greedy_reference``, decode a JAX prefill's wire state, and every
``CompiledStep`` call equals a direct ``T.apply`` bit for bit.

Tolerances: float32 on both sides.  ``moe_apply``'s output and load
``1e-5`` (the same products, summed over k in another order); logits and
cache leaves after a stack ``1e-4``, as ``test_torch_model``; greedy
tokens and compiled steps exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kvstore import GlobalKVStore as JStore
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch import configs as port_configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax, tree_from_numpy
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.span import DecodePipeline
from test_torch_graphs import StepChecker
from test_torch_registry import (ECFG, check_apply, check_served,
                                 port_params, served_requests, variant)

TOL = dict(atol=1e-5, rtol=1e-5)

VARIANTS = {
    "granite-moe-smoke": ("granite-moe-3b-a800m", None, {}),
    "grok-smoke": ("grok-1-314b", None, {}),
    "granite-moe-gqa": ("granite-moe-3b-a800m", "gqa", dict(
        n_layers=4, d_model=128, n_heads=6, n_kv_heads=2, head_dim=64,
        d_ff=32, vocab_size=256)),
    "grok-gqa": ("grok-1-314b", "gqa", dict(
        n_layers=2, d_model=128, n_heads=12, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=256)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _variant(key):
    name, tag, shape = VARIANTS[key]
    return variant(name, tag, **shape)


@pytest.fixture(scope="module")
def stacks(model_zoo):
    """``stacks(key) -> (JAX config, port config, JAX params, port
    params)`` for a variant, made once per module."""
    memo = {}

    def get(key):
        if key not in memo:
            jc, pc = _variant(key)
            jp = model_zoo(jc)
            memo[key] = (jc, pc, jp, port_params(jp, pc))
        return memo[key]

    return get


# ---------------------------------------------------------------------------
# moe_apply against JAX
# ---------------------------------------------------------------------------

def _moe_case(activation, seed=0, e=8, k=3, d=32, f=16):
    """(JAX config, port config, weights, x) with a router skewed toward
    expert 0, so that a capacity factor of 1.25 drops pairs there."""
    jc, pc = variant("grok-1-314b", "moe", n_experts=e, top_k=k, d_model=d,
                     d_ff=f, activation=activation)
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)).astype(np.float32),
         "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) * 0.2,
         "w_up": rng.normal(size=(e, d, f)).astype(np.float32) * 0.2,
         "w_down": rng.normal(size=(e, f, d)).astype(np.float32) * 0.2}
    x = rng.normal(size=(3, 5, d)).astype(np.float32)
    p["router"][:, 0] += 2.0 * np.sign(x.reshape(-1, d).mean(0))
    return jc, pc, p, x


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
@pytest.mark.parametrize("impl,cf", [("dense", None), ("sorted", None),
                                     ("sorted", 1.25)])
def test_moe_apply_vs_jax(impl, cf, activation):
    """``y`` and ``router_load`` equal JAX's; at capacity factor 1.25 some
    pairs are dropped (an expert holds more than cap), and the output
    then differs from the no-drop one, on both sides alike."""
    jc, pc, p, x = _moe_case(
        port_configs.get("grok-1-314b").activation.__class__(activation))
    tp = {key: torch.as_tensor(a) for key, a in p.items()}
    got, load = L.moe_apply(pc, tp, torch.as_tensor(x), impl=impl,
                            capacity_factor=cf)
    want, jload = JL.moe_apply(jc, {key: jnp.asarray(a)
                                    for key, a in p.items()},
                               jnp.asarray(x), impl=impl, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(load.numpy(), jload, **TOL)
    if cf is not None:
        t, e, k = 15, pc.n_experts, pc.top_k
        cap = int(np.ceil(t * k / e * cf))
        assert round(float(load.max()) * t * k) > cap, "no pair dropped"
        free, _ = L.moe_apply(pc, tp, torch.as_tensor(x))
        assert not torch.allclose(got, free)


def test_moe_router_load_is_a_distribution():
    """JAX's ``test_moe_router_load_is_a_distribution``: the load is a
    share per expert, non-negative, summing to 1, for every impl."""
    _, pc, p, x = _moe_case(port_configs.get("grok-1-314b").activation)
    tp = {key: torch.as_tensor(a) for key, a in p.items()}
    for impl, cf in (("dense", None), ("sorted", None), ("sorted", 1.25)):
        _, load = L.moe_apply(pc, tp, torch.as_tensor(x), impl=impl,
                              capacity_factor=cf)
        assert load.shape == (pc.n_experts,) and float(load.min()) >= 0
        assert abs(float(load.sum()) - 1.0) < 1e-6


def test_local_sorted_without_a_mesh_is_sorted():
    """``local_sorted`` with no mesh is the ``sorted`` dispatch, as JAX
    falls back when no data axis is in scope: ``y`` and ``router_load``
    bit for bit, with and without a capacity factor.  (Over a mesh it is
    held to JAX's in ``test_torch_multidevice.py``.)  An unknown impl is
    still refused."""
    _, pc, p, x = _moe_case(port_configs.get("grok-1-314b").activation)
    tp = {key: torch.as_tensor(a) for key, a in p.items()}
    xt = torch.as_tensor(x)
    for cf in (None, 1.25):
        want = L.moe_apply(pc, tp, xt, impl="sorted", capacity_factor=cf)
        got = L.moe_apply(pc, tp, xt, impl="local_sorted",
                          capacity_factor=cf, mesh=None)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="impl"):
        L.moe_apply(pc, tp, xt, impl="megablocks")


# ---------------------------------------------------------------------------
# Init and weights
# ---------------------------------------------------------------------------

def test_moe_init_matches_jax_layout_and_scales(stacks):
    """The port's ``init`` gives JAX's tree, shapes and dtypes, the router
    f32 in a bf16 model, and JAX's expert scale 1/sqrt(E) (``_dense``'s
    fan-in is the leading axis, R4)."""
    jc, pc, jp, _ = stacks("granite-moe-gqa")
    port = T.init(pc, seed=0, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp) == \
        jax.tree.map(lambda a: (tuple(a.shape),
                                str(a.dtype).removeprefix("torch.")), port)
    ffn = port["groups"][0]["ffn"]
    assert abs(float(ffn["w_gate"].std()) - pc.n_experts ** -0.5) < 0.01
    assert abs(float(ffn["router"].std()) - pc.d_model ** -0.5) < 0.01
    again = T.init(pc, seed=0, device="cpu")
    assert torch.equal(again["groups"][0]["ffn"]["w_down"], ffn["w_down"])
    bf = T.init(pc, seed=0, dtype=torch.bfloat16, device="cpu")
    assert bf["groups"][0]["ffn"]["router"].dtype == torch.float32
    assert bf["groups"][0]["ffn"]["w_up"].dtype == torch.bfloat16
    assert torch.equal(bf["groups"][0]["ffn"]["router"], ffn["router"])


def test_params_from_jax_keeps_the_router_f32(stacks):
    jc, pc, jp, _ = stacks("grok-smoke")
    tree = jax.tree.map(np.asarray, jp)
    bf = params_from_jax(pc, tree, device="cpu", dtype=torch.bfloat16)
    for blk in bf["groups"]:
        assert blk["ffn"]["router"].dtype == torch.float32
        assert blk["ffn"]["w_gate"].dtype == torch.bfloat16
        np.testing.assert_array_equal(blk["ffn"]["router"].numpy(),
                                      tree["groups"][0]["ffn"]["router"])
    bad = dict(tree, groups=({**tree["groups"][0], "ffn": {
        k: v for k, v in tree["groups"][0]["ffn"].items()
        if k != "router"}},))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(pc, bad, device="cpu")


def test_dense_stack_router_load_is_jax_zeros(tiny_params):
    """A stack without experts returns JAX's zeros of shape (1,)."""
    from conftest import TINY
    pc = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                     d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                     vocab_size=128)
    tp = params_from_jax(pc, jax.tree.map(np.asarray, tiny_params),
                         device="cpu")
    toks = np.zeros((1, 3), np.int32)
    _, _, aux = T.apply(pc, tp, torch.as_tensor(toks))
    _, _, jaux = JT.apply(TINY, tiny_params, jnp.asarray(toks))
    assert aux["router_load"].shape == (1,)
    np.testing.assert_array_equal(aux["router_load"].numpy(),
                                  jaux["router_load"])


# ---------------------------------------------------------------------------
# Stacks against JAX T.apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(VARIANTS))
def test_moe_stack_apply_vs_jax(stacks, key):
    """Train, fresh prefill, paged decode, paged verify (S = 5) and paged
    resume: logits, every cache leaf and ``aux["router_load"]``."""
    jc, pc, jp, tp = stacks(key)
    T.check_supported(port_configs.get(VARIANTS[key][0]))
    check_apply(jc, pc, jp, tp, ("train", "prefill", "decode", "verify",
                                 "resume"))


@pytest.mark.parametrize("key", ["granite-moe-gqa", "grok-gqa"])
def test_moe_int8_stack_apply_vs_jax(stacks, key):
    """With int8 KV: fresh prefill (int8 values and scales written), two
    paged decode steps and a verify step against JAX: logits, every pool
    leaf of every layer (int8 K/V, their scales, positions) and
    ``aux["router_load"]``."""
    jc, pc, jp, tp = stacks(key)
    check_apply(jc.with_kv_quant(), pc.with_kv_quant(), jp, tp,
                ("prefill", "decode", "verify"))


# ---------------------------------------------------------------------------
# Served streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["granite-moe-gqa", "grok-gqa"])
def test_moe_served_streams_equal_greedy_reference(stacks, greedy_reference,
                                                   key):
    """``Server`` over the port's ``Orchestrator`` (chunked prefill with
    store hits, paged decode): every stream is the JAX greedy rollout."""
    jc, pc, jp, tp = stacks(key)
    reqs = check_served(jc, pc, jp, tp, greedy_reference, chunk=10)
    assert any(r.cached_tokens > 0 for r in reqs)


def test_moe_decode_pipeline_and_jax_wire_states(stacks, greedy_reference):
    """A JAX ``PrefillEngine``'s paged wire states, through numpy, decode
    in the port's full-stack ``DecodeEngine`` and in a 2-stage
    ``DecodePipeline`` (its span weights views of the full ones): both
    give the greedy rollout."""
    jc, pc, jp, tp = stacks("granite-moe-gqa")
    jpe = JPrefill(jc, jp, JEngineConfig(max_len=ECFG.max_len,
                                         max_batch=ECFG.max_batch,
                                         block_size=ECFG.block_size),
                   JStore(block_size=ECFG.block_size))
    units = [DecodeEngine(pc, tp, ECFG, device="cpu"),
             DecodePipeline(pc, tp, ECFG, [(0, 2), (2, 4)], device="cpu")]
    for unit in units:
        reqs = served_requests(pc)
        for r in reqs:
            st, lg = jpe.run(JRequest(rid=r.rid, arrival=0.0,
                                      prompt=r.prompt,
                                      max_new_tokens=r.max_new_tokens))
            unit.insert(r, tree_from_numpy(jax.tree.map(np.asarray, st),
                                           device="cpu"),
                        int(jnp.argmax(lg)))
        while unit.active:
            unit.step()
        for r in reqs:
            assert r.generated == greedy_reference(
                jc, jp, r.prompt, r.max_new_tokens), r.rid
    full = {t.untyped_storage().data_ptr() for g in tp["groups"]
            for t in g["ffn"].values()}
    for e in units[1].engines:
        for g in e.sparams["groups"]:
            assert {t.untyped_storage().data_ptr()
                    for t in g["ffn"].values()} <= full


# ---------------------------------------------------------------------------
# Compiled decode-side steps
# ---------------------------------------------------------------------------

@pytest.fixture
def checker(monkeypatch):
    return StepChecker(monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_compiled_steps_equal_direct_apply(stacks, checker, dtype):
    """Plain decode, then draft speculation with a mismatched draft (the
    same MoE stack from other weights): every plain step, every verify
    width and every draft micro-step equals a direct ``T.apply`` on a
    cloned cache bit for bit (``test_torch_graphs.StepChecker``)."""
    jc, pc, jp, tp = stacks("granite-moe-gqa")
    dt = getattr(torch, dtype)
    params = params_from_jax(pc, jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=dt)
    other = T.init(pc, seed=1, dtype=dt, device="cpu")
    plain = ECFG
    spec = dataclasses.replace(ECFG, speculation="draft", spec_len=3)
    for ecfg, draft in ((plain, None), (spec, (pc, other))):
        pe = PrefillEngine(pc, params, ecfg, device="cpu")
        de = DecodeEngine(pc, params, ecfg, device="cpu", draft=draft)
        checker.engines.append(de)
        reqs = served_requests(pc, n=3, max_new=10)
        for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
            de.insert(r, st, int(torch.argmax(lg)))
        while de.active:
            de.step()
        de.pool.check(holders=[])
    kinds = {c[:2] for c in checker.calls}
    assert ("decode", 1) in kinds and ("draft", 1) in kinds
    assert any(c[0] == "verify" for c in checker.calls)


def test_moe_layers_migrate_as_views(stacks):
    """``unstack_layers`` and ``span_params`` give views of the stacked MoE
    leaves; ``layer_param_bytes`` counts the router at f32 in a bf16
    model; the layer-wise executor runs the MoE blocks as ``T.apply``."""
    from repro_torch.core import layer_migration as LM
    jc, pc, jp, tp = stacks("granite-moe-gqa")
    bf = params_from_jax(pc, jax.tree.map(np.asarray, jp), device="cpu",
                         dtype=torch.bfloat16)
    layers = LM.unstack_layers(pc, bf)
    d, e, f = pc.d_model, pc.n_experts, pc.d_ff
    ffn = layers[1][1]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_up"].untyped_storage().data_ptr() == \
        bf["groups"][0]["ffn"]["w_up"].untyped_storage().data_ptr()
    attn = sum(a.numel() for a in layers[1][1]["attn"].values()) * 2
    assert LM.layer_param_bytes(layers[1][1]) == \
        attn + 2 * 2 * d + d * e * 4 + 3 * e * d * f * 2
    span = LM.span_params(pc, bf, 1, 3)
    assert span["groups"][0]["ffn"]["router"].data_ptr() == \
        bf["groups"][0]["ffn"]["router"][1:2].data_ptr()
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, pc.vocab_size, (2, 9)))
    ex = LM.PartitionedExecutor(pc, tp, ["a", "a", "b", "b"])
    got, _, shares = ex.forward(toks)
    want, _, _ = T.apply(pc, tp, toks)
    assert torch.equal(got, want) and set(shares) == {"a", "b"}
