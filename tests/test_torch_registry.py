"""The registry's dense attention stacks, served by the port, against the
JAX package (ROADMAP A3).

For gemma-7b, chameleon-34b, granite-8b, minitron-8b, llama3-405b and
opt-13b: each arch's ``smoke()`` (4 heads, head_dim d_model / 4) and a
small variant that keeps the arch's GQA ratio and head_dim (gemma's 256,
chameleon's G = 8, llama3-405b's G = 16, ...).  Both run ``T.apply``
against JAX ``T.apply`` on weights from the JAX ``init``: train, fresh
prefill over a dense cache, and paged decode over identical pools; the
variant is also served through the port's ``Orchestrator`` and its greedy
streams held to ``greedy_reference``.

The helpers here (``variant``, ``check_apply``, ``check_served``) are
shared with ``test_torch_moe.py``.

Tolerances: float32 on both sides; logits and cache leaves ``1e-4`` (a
few layers of matmuls summed in another order, as ``test_torch_model``);
greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as JT
from repro_torch import configs as port_configs
from repro_torch.models import kvcache as KC
from repro_torch.models import transformer as T
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.api import Server
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Outcome, Request

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ECFG = EngineConfig(max_len=64, max_batch=3, block_size=8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def variant(name, tag=None, **shape):
    """(JAX config, port config) of registry arch ``name``: its
    ``smoke()``, or with ``shape`` the full config with those fields
    replaced (and ``-tag`` added to its name)."""
    if not shape:
        return jax_configs.get(name).smoke(), port_configs.get(name).smoke()
    return tuple(dataclasses.replace(reg.get(name), name=f"{name}-{tag}",
                                     **shape)
                 for reg in (jax_configs, port_configs))


def port_params(jp, pcfg):
    return params_from_jax(pcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_jax(tree):
    """A JAX copy of a port tree (the port updates its caches in place)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy().copy()) if torch.is_tensor(tree) else tree


def assert_tree_close(port, jax_tree, **tol):
    if isinstance(jax_tree, dict):
        assert set(port) == set(jax_tree)
        for k in jax_tree:
            assert_tree_close(port[k], jax_tree[k], **tol)
    elif isinstance(jax_tree, (tuple, list)):
        assert len(port) == len(jax_tree)
        for a, b in zip(port, jax_tree):
            assert_tree_close(a, b, **tol)
    else:
        a, b = _np(port), np.asarray(jax_tree)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, **(tol or LOGIT_TOL))


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _paged_after_prefill(pcfg, tp, toks, lengths, max_len, bs):
    """The port's paged cache holding each row's prefilled prefix (through
    the wire format), every row's table covering its whole page range."""
    b = toks.shape[0]
    dense = T.init_cache(pcfg, b, max_len, device="cpu")
    T.apply(pcfg, tp, torch.as_tensor(toks), cache=dense, mode="prefill")
    pc = T.init_paged_cache(pcfg, b, max_len, bs, device="cpu")
    nb = max_len // bs
    for row in range(b):
        st = KC.dense_state_to_paged(KC.extract_request_state(dense, row),
                                     bs, length=int(lengths[row]))
        KC.insert_paged_state(pc, row, st, list(
            range(1 + row * nb, 1 + row * nb + st["n_blocks"])), bs)
        pc["block_tables"][row] = torch.arange(1 + row * nb,
                                               1 + (row + 1) * nb)
    pc["lengths"] = torch.as_tensor(lengths, dtype=torch.int32)
    return pc


def _check_aux(aux, jaux):
    np.testing.assert_allclose(_np(aux["router_load"]),
                               np.asarray(jaux["router_load"]), atol=1e-5,
                               rtol=1e-5)


def check_apply(jc, pc, jp, tp, modes):
    """``T.apply`` against JAX ``T.apply`` in each of ``modes`` ("train",
    "prefill": fresh over a dense cache, "decode": two paged steps,
    "verify": one 5-token paged step, "resume": a prefix-aware chunk
    over the paged prefix): logits, every cache leaf and
    ``aux["router_load"]``.  The port's paged steps take the kernel path
    (B1/B4's plain versions on the CPU), JAX's its gather-then-attend
    reference, the cheaper of its two on the CPU."""
    if "train" in modes:
        toks = _tokens(pc, 3, 2, 11)
        got, _, aux = T.apply(pc, tp, torch.as_tensor(toks), mode="train")
        want, _, jaux = JT.apply(jc, jp, jnp.asarray(toks), mode="train")
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        _check_aux(aux, jaux)
    if "prefill" in modes:
        toks = _tokens(pc, 4, 2, 16)
        at = np.asarray([15, 9], np.int32)
        got, gcache, aux = T.apply(
            pc, tp, torch.as_tensor(toks),
            cache=T.init_cache(pc, 2, 32, device="cpu"), mode="prefill",
            logits_slice="last", logits_at=torch.as_tensor(at))
        want, wcache, jaux = JT.apply(
            jc, jp, jnp.asarray(toks), cache=JT.init_cache(jc, 2, 32),
            mode="prefill", logits_slice="last", logits_at=jnp.asarray(at))
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        assert_tree_close(gcache, wcache)
        _check_aux(aux, jaux)
    if "decode" in modes:
        toks = _tokens(pc, 5, 2, 15)
        cache = _paged_after_prefill(pc, tp, toks, np.asarray([15, 11]),
                                     32, 8)
        jcache = _to_jax(cache)
        step = _tokens(pc, 6, 2, 1)
        for _ in range(2):                   # row 0 crosses into a new page
            got, cache, aux = T.apply(pc, tp, torch.as_tensor(step),
                                      cache=cache, mode="decode",
                                      logits_slice="last", paged_kernel=True)
            want, jcache, jaux = JT.apply(jc, jp, jnp.asarray(step),
                                          cache=jcache, mode="decode",
                                          logits_slice="last")
            np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
            _check_aux(aux, jaux)
            step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        assert_tree_close(cache, jcache)
    if "verify" in modes:
        toks = _tokens(pc, 10, 2, 13)
        cache = _paged_after_prefill(pc, tp, toks, np.asarray([13, 11]),
                                     32, 8)
        jcache = _to_jax(cache)
        spec = _tokens(pc, 11, 2, 5)
        got, cache, aux = T.apply(pc, tp, torch.as_tensor(spec), cache=cache,
                                  mode="decode", logits_slice="all",
                                  paged_kernel=True)
        want, jcache, jaux = JT.apply(jc, jp, jnp.asarray(spec),
                                      cache=jcache, mode="decode",
                                      logits_slice="all")
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        assert_tree_close(cache, jcache)
        _check_aux(aux, jaux)
    if "resume" in modes:
        toks = _tokens(pc, 7, 2, 16)
        cache = _paged_after_prefill(pc, tp, toks, np.asarray([16, 16]),
                                     32, 8)
        jcache = _to_jax(cache)
        chunk = _tokens(pc, 8, 2, 11)
        got, cache, aux = T.apply(pc, tp, torch.as_tensor(chunk),
                                  cache=cache, mode="prefill",
                                  prefix_aware=True)
        want, jcache, jaux = JT.apply(jc, jp, jnp.asarray(chunk),
                                      cache=jcache, mode="prefill",
                                      prefix_aware=True)
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        assert_tree_close(cache, jcache)
        _check_aux(aux, jaux)


def served_requests(cfg, n=2, max_new=4, seed=0):
    """``n`` prompts of 21, 25, ... tokens behind one 16-token shared
    prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
    return [Request(rid=i, arrival=0.0, max_new_tokens=max_new,
                    prompt=np.concatenate([shared, rng.integers(
                        0, cfg.vocab_size, 5 + 4 * i, dtype=np.int32)]))
            for i in range(n)]


def check_served(jc, pc, jp, tp, greedy_reference, chunk=None):
    """``Server`` over the port's ``Orchestrator`` (one prefill, one decode
    member; ``chunk`` tokens per prefill chunk): every stream equals the
    JAX greedy rollout."""
    reqs = served_requests(pc)
    orch = Orchestrator(pc, tp, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ECFG, chunk_tokens=chunk),
        device="cpu")
    Server(orch).run(reqs)
    for r in reqs:
        assert r.outcome == Outcome.COMPLETED
        assert r.generated == greedy_reference(jc, jp, r.prompt,
                                               r.max_new_tokens), r.rid
    return reqs


# ---------------------------------------------------------------------------
# The dense registry archs
# ---------------------------------------------------------------------------

# arch: the small variant's shape (the arch's GQA ratio and head_dim kept)
SMALL = {
    "gemma-7b": dict(n_heads=2, n_kv_heads=2, head_dim=256),
    "chameleon-34b": dict(n_heads=8, n_kv_heads=1, head_dim=128),
    "granite-8b": dict(n_heads=4, n_kv_heads=1, head_dim=128),
    "minitron-8b": dict(n_heads=4, n_kv_heads=1, head_dim=128),
    "llama3-405b": dict(n_heads=16, n_kv_heads=1, head_dim=128),
    "opt-13b": dict(n_heads=2, n_kv_heads=2, head_dim=128),
}


def _small(name):
    return variant(name, "gqa", n_layers=2, d_model=64, d_ff=96,
                   vocab_size=256, **SMALL[name])


@pytest.mark.parametrize("name", list(SMALL))
def test_dense_arch_matches_jax_and_greedy_reference(name, model_zoo,
                                                     greedy_reference):
    """Train, fresh prefill and paged decode of the smoke config and of
    the GQA-keeping variant against JAX; the variant's served streams
    (chunked prefill with store hits, paged decode) against
    ``greedy_reference``."""
    T.check_supported(port_configs.get(name))
    for jc, pc in (variant(name), _small(name)):
        jp = model_zoo(jc)
        tp = port_params(jp, pc)
        check_apply(jc, pc, jp, tp, ("train", "prefill", "decode"))
    reqs = check_served(jc, pc, jp, tp, greedy_reference, chunk=10)
    assert any(r.cached_tokens > 0 for r in reqs)
