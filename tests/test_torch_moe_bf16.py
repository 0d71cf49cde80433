"""The port's MoE block and stack in bfloat16, against the JAX package.

Two questions, on the CPU at granite-moe-3b-a800m's full width:

* Does the port's bf16 MoE block compute JAX's bf16 block?  ``moe_apply``
  on the same bf16 input and weights (the router f32 on both sides) routes
  alike, so ``router_load`` is equal and ``y`` is within ``BF16_Y`` of
  JAX's: two bf16 steps at the largest |y| (measured <= 0.9 %, the size
  of bf16's own distance from the f32 block).
* Where does a bf16 MoE stack's drift from f32 come from?  With the depth
  cut to 2 layers and 64 tokens, the f32 stacks agree to ``LOGIT_TOL``,
  and each side's bf16 forward is compared with its own f32 forward.  In
  the MoE stack, at JAX's expert scales (1/sqrt(E), ROADMAP R4) and at
  fan-in scales, JAX's own bf16 forward leaves the f32 one by more than
  the card smoke's teacher-forced rule allows (``TOKEN_GAP_TOL``), as the
  port's does: a bf16 rounding flips a near-tied top-8 choice.  In the
  same stack with a gated MLP in place of the experts both stay well
  inside it, and the port's bf16 logits are within ``BF16_LOGITS`` of
  JAX's.  Run with ``-s`` to see the drifts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as port_configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.weights import params_from_jax

NAME = "granite-moe-3b-a800m"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# chip_smoke.py's teacher-forced rule: a served token within this many
# logits of its step's best
TOKEN_GAP_TOL = 0.25
BF16_Y = 2 ** -6            # of the largest |y|: two bf16 steps
BF16_LOGITS = TOKEN_GAP_TOL / 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_bf16(tree):
    """JAX params in bf16 but the router, which JAX keeps f32."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if getattr(path[-1], "key", None) == "router"
        else a.astype(jnp.bfloat16), tree)


@pytest.mark.parametrize("impl,cf", [("dense", None), ("sorted", None),
                                     ("sorted", 1.25)])
def test_moe_apply_bf16_vs_jax(impl, cf):
    jc, pc = jax_configs.get(NAME), port_configs.get(NAME)
    e, d, f = pc.n_experts, pc.d_model, pc.d_ff
    rng = np.random.default_rng(0)
    # JAX init's scales: the router at fan-in d, the experts at 1/sqrt(E)
    p = {"router": rng.standard_normal((d, e)) / d ** 0.5,
         "w_gate": rng.standard_normal((e, d, f)) / e ** 0.5,
         "w_up": rng.standard_normal((e, d, f)) / e ** 0.5,
         "w_down": rng.standard_normal((e, f, d)) / e ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    tp = {k: torch.as_tensor(v) if k == "router"
          else torch.as_tensor(v).bfloat16() for k, v in p.items()}
    y, load = L.moe_apply(pc, tp, torch.as_tensor(x).bfloat16(), impl=impl,
                          capacity_factor=cf)
    jy, jload = JL.moe_apply(jc, _jax_bf16({k: jnp.asarray(v)
                                            for k, v in p.items()}),
                             jnp.asarray(x).astype(jnp.bfloat16), impl=impl,
                             capacity_factor=cf)
    assert y.dtype == torch.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=0,
                               atol=BF16_Y * float(np.abs(jy).max()))


def _scaled_to_fan_in(cfg, tree):
    """The expert leaves rescaled from 1/sqrt(E) to 1/sqrt(fan-in)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    gain = {"w_gate": (e / d) ** 0.5, "w_up": (e / d) ** 0.5,
            "w_down": (e / f) ** 0.5}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * gain.get(getattr(path[-1], "key", None), 1.0),
        tree)


@pytest.mark.parametrize("stack", ["moe", "moe-fan-in-scales",
                                   "gated-mlp"])
def test_full_width_bf16_drift_is_the_references_own(stack):
    extra = dict(n_experts=0, top_k=0) if stack == "gated-mlp" else {}
    jc, pc = (dataclasses.replace(reg.get(NAME), name=f"{NAME}-2l",
                                  n_layers=2, **extra)
              for reg in (jax_configs, port_configs))
    jp = JT.init(jc, jax.random.PRNGKey(0))
    if stack == "moe-fan-in-scales":
        jp = _scaled_to_fan_in(jc, jp)
    tree = jax.tree.map(np.asarray, jp)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (1, 64))
    jt = jnp.asarray(toks, jnp.int32)
    tt = torch.as_tensor(toks)
    logits = {
        "jax f32": np.asarray(JT.apply(jc, jp, jt)[0]),
        "jax bf16": np.asarray(JT.apply(jc, _jax_bf16(jp), jt)[0]
                               .astype(jnp.float32)),
        "port f32": T.apply(pc, params_from_jax(pc, tree, device="cpu"),
                            tt)[0].numpy(),
        "port bf16": T.apply(pc, params_from_jax(
            pc, tree, device="cpu", dtype=torch.bfloat16), tt)[0]
        .float().numpy()}
    np.testing.assert_allclose(logits["port f32"], logits["jax f32"],
                               **LOGIT_TOL)

    def gap(a, b):
        return float(np.abs(logits[a] - logits[b]).max())

    drift = {side: gap(f"{side} bf16", f"{side} f32")
             for side in ("jax", "port")}
    cross = gap("port bf16", "jax bf16")
    print(f"{stack}: bf16 vs f32 JAX {drift['jax']:.4f}, port "
          f"{drift['port']:.4f}; port vs JAX bf16 {cross:.4f}; logit std "
          f"{logits['jax f32'].std():.3f}")
    if stack == "gated-mlp":
        assert max(drift.values()) < TOKEN_GAP_TOL, drift
        assert cross < BF16_LOGITS
    else:
        assert min(drift.values()) > TOKEN_GAP_TOL, drift
