"""The port's Algorithm 1 controller (``core/migration.py``, a copy) and
layer-level migration (``core/layer_migration.py``, partial-stack
``transformer.apply`` and the dense-cache resume) against the JAX package
on the same inputs.

Tolerances: controller actions exactly (the same float arithmetic);
logits after the stack ``1e-4`` (float32, four layers summed in another
order), as the port's model tests hold them; positions, lengths and byte
counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.core import layer_migration as JLM
from repro.core import migration as JM
from repro.core.analytical import TPU_V5E
from repro.models import kvcache as JKC
from repro.models import transformer as JT
from repro_torch.core import layer_migration as LM
from repro_torch.core import migration as M
from repro_torch.core.analytical import H100_SXM
from repro_torch.models import kvcache as KC
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax, tree_from_numpy

PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


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


def _tokens(b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# Algorithm 1: the copied controller against JAX's
# ---------------------------------------------------------------------------

def _cost_fn(mod, layer_useless=False):
    def cost_fn(kind, d_o, d_u, amount):
        gap = d_o.utilization - d_u.utilization
        if kind == mod.MigrationKind.LAYER:
            return (0.0 if layer_useless else gap * 0.5), 0.010
        return gap * 0.2, 0.001
    return cost_fn


# (case, controller kwargs, layer migration useless, load sequences:
# (name, compute, memory, supports_layer) per device, one list per cycle)
CONTROLLER_CASES = [
    ("balanced", {}, False,
     [[("a", 0.5, 0.5, True), ("b", 0.55, 0.45, True)]]),
    ("hot-to-cold", {}, False,
     [[("hot", 0.9, 0.9, True), ("cold", 0.1, 0.1, True)]]),
    ("benefit-cost-ratio", {"rho": 1e9}, False,
     [[("hot", 1.0, 1.0, True), ("cold", 0.0, 0.0, True)]]),
    ("hysteresis", {}, False,
     [[("a", 0.9, 0.9, True), ("b", 0.1, 0.1, True)],
      [("a", 0.6, 0.0, True), ("b", 0.3, 0.05, True)]]),
    ("attention-only", {}, True,
     [[("hot", 0.9, 0.9, False), ("cold", 0.0, 0.0, True)]]),
    ("budget", {"t_budget": 0.010, "max_actions_per_cycle": 10}, False,
     [[("h1", 1.0, 1.0, True), ("h2", 0.9, 0.95, True),
       ("c1", 0.0, 0.0, True), ("c2", 0.05, 0.0, True)]]),
]


@pytest.mark.parametrize("case,kw,layer_useless,cycles", CONTROLLER_CASES,
                         ids=[c[0] for c in CONTROLLER_CASES])
def test_controller_matches_jax(case, kw, layer_useless, cycles):
    """The same DeviceLoad sequences plan the same actions, cycle by cycle
    (hysteresis state included), on both controllers."""
    plans = []
    for mod in (M, JM):
        ctl = mod.MigrationController(mod.ControllerConfig(**kw),
                                      _cost_fn(mod, layer_useless))
        plans.append([
            [(a.kind.value, a.src, a.dst, a.amount, a.predicted_benefit,
              a.predicted_cost) for a in ctl.plan(
                [mod.DeviceLoad(n, c, m, supports_layer=sl)
                 for n, c, m, sl in loads])]
            for loads in cycles])
    assert plans[0] == plans[1]
    acts = plans[0][-1]
    expect_any = case in ("hot-to-cold", "hysteresis", "attention-only",
                          "budget")
    assert bool(acts) == expect_any
    if case == "attention-only":
        assert acts[0][0] == "kv_heads"
    if case == "budget":
        assert sum(a[5] for a in acts) <= 0.010 + 1e-9


# ---------------------------------------------------------------------------
# Layer spans: views, configs and the state wire format
# ---------------------------------------------------------------------------

def test_span_params_are_views(tp):
    """``span_params`` slices the stacked weights on the layer axis: every
    span leaf shares its storage with the full parameters, and the span
    config describes exactly the span's layers."""
    full = {id(a.untyped_storage()): a for a in LM._leaves(tp)}
    ptrs = {a.untyped_storage().data_ptr() for a in full.values()}
    for a, b in LM.even_spans(PTINY.n_layers, 2) + [(1, 4)]:
        sp = LM.span_params(PTINY, tp, a, b)
        scfg = LM.span_config(PTINY, a, b)
        assert scfg.n_layers == b - a and len(sp["groups"]) == b - a
        for leaf in LM._leaves(sp):
            assert leaf.untyped_storage().data_ptr() in ptrs
        for k, g in enumerate(sp["groups"]):
            for key in ("wq", "wo"):
                assert torch.equal(g["attn"][key][0],
                                   tp["groups"][0]["attn"][key][a + k])
    assert LM.layer_param_bytes(LM.span_params(PTINY, tp, 0, 2)["groups"]) \
        * 2 == LM.layer_param_bytes(tp["groups"])


def test_restack_layers_is_the_identity(tp):
    layers = LM.unstack_layers(PTINY, tp)
    back = LM.restack_layers(PTINY, layers)
    for g, w in zip(back["groups"], tp["groups"]):
        for x, y in zip(LM._leaves(g), LM._leaves(w)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("bounds", [[(0, 2), (2, 4)], [(0, 1), (1, 3),
                                                       (3, 4)]])
def test_split_merge_state_spans_match_jax(tiny_params, bounds):
    """A paged wire state split at ``bounds`` and merged back is the
    identity, and each part equals JAX's split, leaf for leaf."""
    jcache = JT.init_cache(TINY, 1, 32)
    _, jcache, _ = JT.prefill(TINY, tiny_params,
                              jnp.asarray(_tokens(1, 20)), jcache)
    jst = JKC.dense_state_to_paged(JKC.extract_request_state(jcache, 0), 8)
    st = tree_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    parts = LM.split_state_spans(PTINY, st, bounds)
    jparts = JLM.split_state_spans(TINY, jst, bounds)
    for p, jp in zip(parts, jparts):
        assert int(p["n_blocks"]) == int(jp["n_blocks"])
        assert len(p["groups"]) == len(jp["groups"])
        for g, jg in zip(p["groups"], jp["groups"]):
            for k in g:
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(jg[k]))
    back = LM.merge_state_spans(PTINY, parts, bounds)
    assert int(back["n_blocks"]) == int(st["n_blocks"])
    for g, w in zip(back["groups"], st["groups"]):
        for k in g:
            assert torch.equal(g[k], w[k])
    assert KC.layer_transfer_schedule(parts[-1], base_layer=bounds[-1][0]) \
        == [tuple(x) for x in JKC.layer_transfer_schedule(
            jparts[-1], base_layer=bounds[-1][0])]


def test_chained_spans_equal_the_monolithic_forward(tp, tiny_params):
    """``apply(hidden_in/hidden_out)`` over two spans (views of the
    weights) gives the full-stack logits, which equal JAX's."""
    toks = _tokens()
    want, _, _ = JT.apply(TINY, tiny_params, jnp.asarray(toks), mode="train")
    x = torch.as_tensor(toks, dtype=torch.long)
    for k, (a, b) in enumerate([(0, 3), (3, 4)]):
        x, _, _ = T.apply(LM.span_config(PTINY, a, b),
                          LM.span_params(PTINY, tp, a, b), x, mode="train",
                          hidden_in=k > 0, hidden_out=k == 0)
        if k == 0:
            assert x.shape == (2, 12, PTINY.d_model)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), **LOGIT_TOL)


def test_dense_prefix_aware_prefill_matches_jax(tp, tiny_params):
    """A chunk resumed over a dense per-row cache (the chained prefill's
    resume: plain attend over the cached prefix and the chunk) equals
    JAX's, logits and written cache."""
    toks = _tokens(2, 20, seed=3)
    jcache = JT.init_cache(TINY, 2, 32)
    _, jcache, _ = JT.apply(TINY, tiny_params, jnp.asarray(toks[:, :12]),
                            cache=jcache, mode="prefill")
    jlg, jcache, _ = JT.apply(TINY, tiny_params, jnp.asarray(toks[:, 12:]),
                              cache=jcache, mode="prefill",
                              prefix_aware=True)
    cache = T.init_cache(PTINY, 2, 32, device="cpu")
    t = torch.as_tensor(toks, dtype=torch.long)
    _, cache, _ = T.apply(PTINY, tp, t[:, :12], cache=cache, mode="prefill")
    lg, cache, _ = T.apply(PTINY, tp, t[:, 12:], cache=cache, mode="prefill",
                           prefix_aware=True)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    for g, jg in zip(cache["groups"], jcache["groups"]):
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(jg["pos"]))
        np.testing.assert_allclose(g["k"].numpy(), np.asarray(jg["k"]),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# The partitioned executor (Eq. 5 correctness) against JAX's
# ---------------------------------------------------------------------------

def test_partitioned_forward_matches_jax(tp, tiny_params):
    toks = _tokens()
    ref, _ = JT.forward_train(TINY, tiny_params, jnp.asarray(toks))
    ex = LM.PartitionedExecutor(PTINY, tp, ["p0", "p0", "p1", "p1"],
                                hw=H100_SXM)
    out, _, shares = ex.forward(torch.as_tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGIT_TOL)
    assert set(shares) == {"p0", "p1"}


def test_migration_preserves_semantics_and_moves_flops(tp, tiny_params):
    toks = _tokens()
    ex = LM.PartitionedExecutor(PTINY, tp, ["p0"] * 4, hw=H100_SXM)
    jex = JLM.PartitionedExecutor(TINY, tiny_params, ["p0"] * 4,
                                  hw=TPU_V5E)
    rec, jrec = ex.migrate(2, 4, "p1"), jex.migrate(2, 4, "p1")
    assert rec.payload_bytes == jrec.payload_bytes > 0
    assert rec.est_time_s > 0
    out, _, shares = ex.forward(torch.as_tensor(toks, dtype=torch.long))
    jout, _, _ = jex.forward(jnp.asarray(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LOGIT_TOL)
    assert shares["p0"] == shares["p1"]
    assert ex.layers_on("p1") == [2, 3]


def test_migration_with_live_decode_state(tp, tiny_params):
    """Fig. 3: weights AND KV move mid-flight; the decode step after the
    move equals JAX's monolithic one."""
    toks = _tokens()
    jcache = JT.init_cache(TINY, 2, 32)
    lg, jcache, _ = JT.prefill(TINY, tiny_params, jnp.asarray(toks), jcache)
    nxt = np.array(jnp.argmax(lg, -1))[:, None]
    ref_lg, _, _ = JT.decode_step(TINY, tiny_params, jnp.asarray(nxt),
                                  jcache)

    ex = LM.PartitionedExecutor(PTINY, tp, ["p0"] * 4, hw=H100_SXM)
    cache = T.init_cache(PTINY, 2, 32, device="cpu")
    states = LM.unstack_cache(PTINY, cache)
    lengths = torch.zeros(2, dtype=torch.int32)
    plg, states, _ = ex.forward(torch.as_tensor(toks, dtype=torch.long),
                                states, mode="prefill", lengths=lengths)
    assert np.array_equal(plg[:, -1].argmax(-1).numpy(), nxt[:, 0])
    rec = ex.migrate(1, 3, "p1", states=states)
    assert rec.payload_bytes == sum(
        LM.layer_param_bytes(ex.layers[i][1])
        + LM.layer_state_bytes(states[i]) for i in (1, 2))
    lg2, states, _ = ex.forward(torch.as_tensor(nxt, dtype=torch.long),
                                states, mode="decode",
                                lengths=lengths + toks.shape[1])
    np.testing.assert_allclose(lg2[:, -1].numpy(), np.asarray(ref_lg),
                               **LOGIT_TOL)
