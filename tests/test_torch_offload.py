"""Fig. 4 head offload and the split-KV attention of the port against the
JAX package: ``core/attention_offload.py`` (``expand_gqa``,
``split_kv_attention`` along the sequence and along the heads,
``reference_attention``), and ``T.apply(head_offload=n)`` at the model
level, whose branches run kernel B5's plain version here.

Every input is made with numpy from a seed and handed to both sides.
Tolerances (float32 on both sides): split attention 1e-5, as JAX's own
test (summation order over D and 40 keys); the offloaded decode's logits
2e-4, as ``tests/test_models.py`` holds JAX's (two layers, another
summation order in each branch).  About 30 s on one CPU worker.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention_offload as JAO
from repro.models import transformer as JT
from repro.models.config import Family as JFamily
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.core import attention_offload as AO
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_OFF = dict(rtol=2e-4, atol=2e-4)

# tests/test_models.py's head-offload config (8 query / 4 kv heads)
JOFF = JModelConfig(name="off", family=JFamily.DENSE, n_layers=2,
                    d_model=64, n_heads=8, n_kv_heads=4, d_ff=128,
                    vocab_size=128)
OFF = ModelConfig(name="off", family=Family.DENSE, n_layers=2, d_model=64,
                  n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128)


def _inputs(seed=0, b=3, h=4, d=16, l=40, p_mask=0.8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, l, h, d)).astype(np.float32)
    v = rng.normal(size=(b, l, h, d)).astype(np.float32)
    mask = rng.random((b, l)) < p_mask
    return q, k, v, mask


def _both(*arrays):
    """(torch tensors, jax arrays) of the same numpy inputs."""
    return ([torch.as_tensor(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _parts(x, cuts, axis):
    return [x[:, a:b] if axis == 1 else x[:, :, a:b]
            for a, b in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("cuts", [[0, 20, 40], [0, 7, 19, 25, 40],
                                  [0, 1, 39, 40]])
def test_seq_split_exact(cuts):
    (q, k, v, m), (jq, jk, jv, jm) = _both(*_inputs())
    out = AO.split_kv_attention(q, _parts(k, cuts, 1), _parts(v, cuts, 1),
                                _parts(m, cuts, 1), axis="seq")
    want = JAO.split_kv_attention(jq, _parts(jk, cuts, 1),
                                  _parts(jv, cuts, 1), _parts(jm, cuts, 1),
                                  axis="seq")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        out.numpy(), AO.reference_attention(q, k, v, m).numpy(), **TOL)


@pytest.mark.parametrize("cuts", [[0, 1, 4], [0, 3, 4], [0, 1, 2, 4]])
def test_head_split_exact_paper_fig4(cuts):
    """The hot/cold device head partition of Fig. 4 (and a three-way one),
    each part its own exact softmax."""
    (q, k, v, m), (jq, jk, jv, jm) = _both(*_inputs())
    out = AO.split_kv_attention(q, _parts(k, cuts, 2), _parts(v, cuts, 2),
                                [m] * (len(cuts) - 1), axis="head")
    want = JAO.split_kv_attention(jq, _parts(jk, cuts, 2),
                                  _parts(jv, cuts, 2),
                                  [jm] * (len(cuts) - 1), axis="head")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JAO.reference_attention(jq, jk, jv, jm)),
        **TOL)


def test_fully_masked_partition():
    q, k, v, mask = _inputs()
    mask[:, :7] = False
    (q, k, v, m), (jq, jk, jv, jm) = _both(q, k, v, mask)
    out = AO.split_kv_attention(q, [k[:, :7], k[:, 7:]], [v[:, :7], v[:, 7:]],
                                [m[:, :7], m[:, 7:]], axis="seq")
    ref = JAO.reference_attention(jq, jk, jv, jm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        AO.reference_attention(q, k, v, m).numpy(), np.asarray(ref), **TOL)


def test_combine_is_order_invariant():
    (q, k, v, m), (jq, jk, jv, jm) = _both(*_inputs(seed=5))
    spans = [(0, 13), (13, 27), (27, 40)]
    parts = [AO.partial_attention(q, k[:, a:b], v[:, a:b], m[:, a:b])
             for a, b in spans]
    fwd = AO.combine_partials(*zip(*parts))
    rev = AO.combine_partials(*zip(*parts[::-1]))
    np.testing.assert_allclose(fwd.numpy(), rev.numpy(), rtol=1e-6,
                               atol=1e-6)
    jparts = [JAO.partial_attention(jq, jk[:, a:b], jv[:, a:b], jm[:, a:b])
              for a, b in spans]
    np.testing.assert_allclose(
        fwd.numpy(), np.asarray(JAO.combine_partials(*zip(*jparts))), **TOL)


def test_bf16_stability():
    """The running-max form survives bf16 score ranges where the paper's
    raw-exp form (Eq. 7) would overflow, and agrees with JAX's."""
    q, k, v, mask = _inputs()
    qb = torch.as_tensor(q * 30).to(torch.bfloat16)
    kb = torch.as_tensor(k * 30).to(torch.bfloat16)
    vb = torch.as_tensor(v).to(torch.bfloat16)
    m = torch.as_tensor(mask)
    parts = [AO.partial_attention(qb.float(), kb[:, a:b].float(),
                                  vb[:, a:b].float(), m[:, a:b], scale=1.0)
             for a, b in [(0, 20), (20, 40)]]
    out = AO.combine_partials(*zip(*parts))
    assert bool(torch.isfinite(out).all())
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (qb, kb, vb))
    jparts = [JAO.partial_attention(jq, jk[:, a:b], jv[:, a:b],
                                    jnp.asarray(mask[:, a:b]), scale=1.0)
              for a, b in [(0, 20), (20, 40)]]
    want = np.asarray(JAO.combine_partials(*zip(*jparts)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)


def test_expand_gqa_matches_jax():
    q = np.random.default_rng(3).normal(size=(2, 8, 16)).astype(np.float32)
    got = AO.expand_gqa(torch.as_tensor(q), 2)
    assert tuple(got.shape) == (2, 2, 4, 16)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JAO.expand_gqa(jnp.asarray(q),
                                                            2)))


# ---------------------------------------------------------------------------
# Fig. 4 inside the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def offload_setup():
    """JAX's and the port's weights (the same tree), and a dense cache of
    16 prefilled tokens on each side with the next token to decode."""
    jparams = JT.init(JOFF, jax.random.PRNGKey(0))
    params = params_from_jax(OFF, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = np.random.default_rng(1).integers(0, 128, (2, 16))
    jcache = JT.init_cache(JOFF, 2, 32)
    jlg, jcache, _ = JT.prefill(JOFF, jparams, jnp.asarray(toks), jcache)
    nxt = np.array(jnp.argmax(jlg, -1))[:, None]
    return jparams, params, toks, jcache, nxt


def _port_cache(params, toks, cfg=OFF):
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    _, cache, _ = T.prefill(cfg, params, torch.as_tensor(toks), cache)
    return cache


def _clone(cache):
    return T._tree_map(lambda a: a.clone(), cache)


@pytest.mark.parametrize("n_off", [1, 2, 3])
def test_head_offloaded_decode_matches_jax_and_monolithic(offload_setup,
                                                          n_off):
    """``T.apply(head_offload=n)``: the last n kv heads a separate branch
    (B5's plain version per branch, two per layer), against JAX's
    ``T.apply(head_offload=n)`` and the port's monolithic step."""
    jparams, params, toks, jcache, nxt = offload_setup
    cache = _port_cache(params, toks)
    ref, _, _ = T.decode_step(OFF, params, torch.as_tensor(nxt),
                              _clone(cache))
    calls = []
    orig = ops.decode_partials

    def count(*a, **kw):
        calls.append((a[0].shape[1], a[1].shape[2]))
        return orig(*a, **kw)

    L.ops.decode_partials = count
    try:
        out, _, _ = T.apply(OFF, params, torch.as_tensor(nxt), cache=cache,
                            mode="decode", logits_slice="last",
                            head_offload=n_off)
    finally:
        L.ops.decode_partials = orig
    want, _, _ = JT.apply(JOFF, jparams, jnp.asarray(nxt), cache=jcache,
                          mode="decode", logits_slice="last",
                          head_offload=n_off)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL_OFF)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL_OFF)
    # (query heads, kv heads): hot [:kv - n], cold [kv - n:], per layer
    g = OFF.n_heads // OFF.n_kv_heads
    hot = OFF.n_kv_heads - n_off
    assert calls == [(g * hot, hot), (g * n_off, n_off)] * OFF.n_layers


def test_head_offload_refusals_and_int8_noop(offload_setup):
    """A paged cache raises ``ValueError`` before any work (JAX asserts),
    as does n_off outside 0..kv (the cache untouched); on an int8 cache the offload is ignored,
    as JAX's ``and not quant``: the step equals the plain int8 step."""
    _, params, toks, _, nxt = offload_setup
    x = torch.as_tensor(nxt)
    pcache = T.init_paged_cache(OFF, 2, 32, 8, device="cpu")
    before = pcache["lengths"].clone()
    with pytest.raises(ValueError, match="head offload and paged"):
        T.apply(OFF, params, x, cache=pcache, mode="decode", head_offload=1)
    assert torch.equal(pcache["lengths"], before)
    cache = _port_cache(params, toks)
    before = _clone(cache)
    with pytest.raises(ValueError, match="head_offload must be in"):
        T.apply(OFF, params, x, cache=cache, mode="decode",
                head_offload=OFF.n_kv_heads + 1)
    for got, want in zip(cache["groups"][0].values(),
                         before["groups"][0].values()):
        assert torch.equal(got, want)
    qcfg = dataclasses.replace(OFF, kv_quant=True)
    qcache = _port_cache(params, toks, qcfg)
    a, _, _ = T.decode_step(qcfg, params, x, _clone(qcache))
    b, _, _ = T.apply(qcfg, params, x, cache=qcache, mode="decode",
                      logits_slice="last", head_offload=2)
    assert torch.equal(a, b)
