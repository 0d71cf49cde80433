"""The port's model layers, stacks, weights and paged-cache runtime against
the JAX package on the same inputs.

Weights come from the JAX ``transformer.init`` through numpy
(``params_from_jax``); caches built on one side are handed to the other
through numpy, so every comparison starts from identical state.

Tolerances: float32 on both sides.  Single layers (norm, rope, attention)
``atol = rtol = 1e-5``; logits after a whole stack ``1e-4`` (four layers of
matmuls summed in another order); integer and position leaves exactly.
bf16 rope: one bf16 step (2^-8 relative), since XLA may fuse what torch
rounds op by op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.models import kvcache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get as port_config
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax, tree_from_numpy

# the port's own copy of the shared tiny stack (tests/conftest.py TINY)
PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tiny_params):
    """(JAX params, the port's params made from them)."""
    return tiny_params, params_from_jax(
        PTINY, jax.tree.map(np.asarray, tiny_params), device="cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_jax(tree):
    """A JAX copy of a port tree.  The copy matters: on the CPU a JAX array
    may share a numpy buffer, and the port updates its caches in place."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy().copy()) if torch.is_tensor(tree) else tree


def _assert_tree_close(port, jax_tree, **tol):
    if isinstance(jax_tree, dict):
        assert set(port) == set(jax_tree)
        for k in jax_tree:
            _assert_tree_close(port[k], jax_tree[k], **tol)
    elif isinstance(jax_tree, (tuple, list)):
        assert len(port) == len(jax_tree)
        for a, b in zip(port, jax_tree):
            _assert_tree_close(a, b, **tol)
    else:
        a, b = _np(port), np.asarray(jax_tree)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, **(tol or TOL))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_vs_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-6).numpy(),
        JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), **TOL)
    np.testing.assert_allclose(
        L.rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0).numpy(),
        JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), **TOL)
    got = L.rope(torch.as_tensor(x).bfloat16(), torch.as_tensor(pos), 1e4)
    want = JL.rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), 1e4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("s,window,cap", [(7, None, None), (12, 5, None),
                                          (9, None, 3.0), (1030, 64, 2.0)])
def test_attend_vs_jax(s, window, cap):
    """Positional-masked GQA attention with holes; S > 1024 takes the
    blocked path on both sides."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, s, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, s, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, s, 2, 8)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    pos_k = pos.copy()
    pos_k[0, 1] = -1
    got = L.attend(*(torch.as_tensor(a) for a in (q, k, v, pos, pos_k)),
                   window=window, scale=0.3, soft_cap=cap)
    want = JL.attend(*(jnp.asarray(a) for a in (q, k, v, pos, pos_k)),
                     window=window, scale=0.3, soft_cap=cap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mlp_vs_jax():
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=sh).astype(np.float32) * 0.1 for k, sh in
         (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    got = L.mlp_apply(PTINY, {k: torch.as_tensor(a) for k, a in p.items()},
                      torch.as_tensor(x))
    want = JL.mlp_apply(TINY, {k: jnp.asarray(a) for k, a in p.items()},
                        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# Init and weights
# ---------------------------------------------------------------------------

def test_init_matches_jax_layout_and_scales(tiny_params):
    port = T.init(PTINY, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), tiny_params)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == shapes
    wq = port["groups"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - PTINY.d_model ** -0.5) < 0.02
    assert abs(float(port["embed"].std()) - 0.02) < 0.002
    assert float(port["groups"][0]["norm1"].abs().max()) == 0.0
    again = T.init(PTINY, seed=0, device="cpu")
    assert torch.equal(again["embed"], port["embed"])


def test_init_paged_cache_matches_jax_layout():
    got = T.init_paged_cache(PTINY, 3, 96, 8, device="cpu")
    want = JT.init_paged_cache(TINY, 3, 96, 8)
    _assert_tree_close(got, want)


def test_params_from_jax_checks_the_tree(tiny_params):
    tree = jax.tree.map(np.asarray, tiny_params)
    bad = dict(tree, groups=({**tree["groups"][0],
                              "norm1": tree["groups"][0]["norm1"][:, :3]},))
    with pytest.raises(ValueError, match="norm1"):
        params_from_jax(PTINY, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(PTINY, {k: v for k, v in tree.items()
                                if k != "out_norm"}, device="cpu")


def test_unported_stacks_raise_not_implemented():
    """Recurrent, SSM and audio stacks are a later slice (ROADMAP A6); the
    MoE stacks are served."""
    for name in ("recurrentgemma-9b", "xlstm-350m",
                 "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError, match="A6: a later slice"):
            T.check_supported(port_config(name).smoke())
    for name in ("llama-13b", "granite-moe-3b-a800m", "grok-1-314b"):
        T.check_supported(port_config(name))
        T.check_supported(port_config(name).smoke())


# ---------------------------------------------------------------------------
# Stack forward: train, fresh prefill, paged decode, paged resume prefill
# ---------------------------------------------------------------------------

def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, PTINY.vocab_size,
                                                (b, s)).astype(np.int32)


def test_apply_train_vs_jax(weights):
    jp, tp = weights
    toks = _tokens(3, 2, 21)
    got, _, _ = T.apply(PTINY, tp, torch.as_tensor(toks), mode="train")
    want, _, _ = JT.apply(TINY, jp, jnp.asarray(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_apply_fresh_prefill_vs_jax(weights):
    """Fresh prefill over a dense cache (kernel B2's path on the card):
    last-token logits at each row's true end and the written caches."""
    jp, tp = weights
    toks = _tokens(4, 2, 16)
    at = np.asarray([15, 9], np.int32)
    got, gcache, _ = T.apply(
        PTINY, tp, torch.as_tensor(toks),
        cache=T.init_cache(PTINY, 2, 32, device="cpu"), mode="prefill",
        logits_slice="last", logits_at=torch.as_tensor(at))
    want, wcache, _ = JT.apply(
        TINY, jp, jnp.asarray(toks), cache=JT.init_cache(TINY, 2, 32),
        mode="prefill", logits_slice="last", logits_at=jnp.asarray(at))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _assert_tree_close(gcache, wcache, **LOGIT_TOL)


def _paged_after_prefill(tp, toks, lengths, max_len, bs):
    """The port's paged cache holding each row's prefilled prefix (through
    the wire format), every row's table covering its whole page range."""
    b = toks.shape[0]
    dense = T.init_cache(PTINY, b, max_len, device="cpu")
    T.apply(PTINY, tp, torch.as_tensor(toks), cache=dense, mode="prefill")
    pc = T.init_paged_cache(PTINY, b, max_len, bs, device="cpu")
    nb = max_len // bs
    for row in range(b):
        st = KC.dense_state_to_paged(KC.extract_request_state(dense, row),
                                     bs, length=int(lengths[row]))
        n = st["n_blocks"]
        KC.insert_paged_state(pc, row, st,
                              list(range(1 + row * nb, 1 + row * nb + n)), bs)
        pc["block_tables"][row] = torch.arange(1 + row * nb,
                                               1 + (row + 1) * nb)
    pc["lengths"] = torch.as_tensor(lengths, dtype=torch.int32)
    return pc


@pytest.mark.parametrize("paged_kernel", [True, False])
def test_apply_paged_decode_vs_jax(weights, paged_kernel):
    """Paged decode (kernel B1 or the gather-then-attend reference) on
    identical pools: logits and every updated pool leaf."""
    jp, tp = weights
    toks = _tokens(5, 2, 13)
    lengths = np.asarray([13, 13], np.int32)
    pc = _paged_after_prefill(tp, toks, lengths, 48, 8)
    jc = _to_jax(pc)
    step = _tokens(6, 2, 1)
    for _ in range(3):                       # crosses into a fresh page
        got, pc, _ = T.apply(PTINY, tp, torch.as_tensor(step), cache=pc,
                             mode="decode", logits_slice="last",
                             paged_kernel=paged_kernel)
        want, jc, _ = JT.apply(TINY, jp, jnp.asarray(step), cache=jc,
                               mode="decode", logits_slice="last",
                               paged_kernel=paged_kernel)
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    _assert_tree_close(pc, jc, **LOGIT_TOL)


@pytest.mark.parametrize("paged_kernel", [True, False])
def test_apply_paged_verify_vs_jax(weights, paged_kernel):
    """Multi-token paged decode, the speculative verify forward (kernel B4
    or the gather-then-attend reference): S = 5 tokens written into their
    pages, then read with per-query horizons.  Logits for every position
    and every pool leaf against JAX on identical pools; the logits also
    equal the stateless forward over the whole context; and ``lengths``
    advances by S."""
    jp, tp = weights
    toks = _tokens(10, 2, 13)
    lengths = np.asarray([13, 11], np.int32)
    pc = _paged_after_prefill(tp, toks, lengths, 48, 8)
    jc = _to_jax(pc)
    spec = _tokens(11, 2, 5)
    got, pc, _ = T.apply(PTINY, tp, torch.as_tensor(spec), cache=pc,
                         mode="decode", logits_slice="all",
                         paged_kernel=paged_kernel)
    want, jc, _ = JT.apply(TINY, jp, jnp.asarray(spec), cache=jc,
                           mode="decode", logits_slice="all",
                           paged_kernel=paged_kernel)
    assert tuple(got.shape) == (2, 5, PTINY.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _assert_tree_close(pc, jc, **LOGIT_TOL)
    assert pc["lengths"].tolist() == (lengths + 5).tolist()
    for row, n in enumerate(lengths):
        ctx = np.concatenate([toks[row, :n], spec[row]])[None]
        full, _, _ = JT.apply(TINY, jp, jnp.asarray(ctx), mode="train")
        np.testing.assert_allclose(got[row].numpy(), full[0, n:],
                                   **LOGIT_TOL)


def test_apply_dense_decode_vs_jax(weights):
    """Decode over a dense per-row cache (the draft model's): ring write at
    positions % cache_len, then plain attention; logits and caches against
    JAX over steps that cross rows of different lengths."""
    jp, tp = weights
    toks = _tokens(12, 2, 10)
    at = np.asarray([9, 6], np.int32)
    dense = T.init_cache(PTINY, 2, 32, device="cpu")
    _, dense, _ = T.apply(PTINY, tp, torch.as_tensor(toks), cache=dense,
                          mode="prefill", logits_slice="last",
                          logits_at=torch.as_tensor(at))
    dense["lengths"] = torch.as_tensor(at + 1)
    jc = _to_jax(dense)
    step = _tokens(13, 2, 1)
    for _ in range(3):
        got, dense, _ = T.apply(PTINY, tp, torch.as_tensor(step),
                                cache=dense, mode="decode",
                                logits_slice="last")
        want, jc, _ = JT.apply(TINY, jp, jnp.asarray(step), cache=jc,
                               mode="decode", logits_slice="last")
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    _assert_tree_close(dense, jc, **LOGIT_TOL)


def test_apply_paged_resume_prefill_vs_jax(weights):
    """Paged incremental prefill (kernels B3 + B2 on the card): a chunk
    attends over its prefix pages plus itself, then lands in its pages."""
    jp, tp = weights
    toks = _tokens(7, 2, 16)
    pc = _paged_after_prefill(tp, toks, np.asarray([16, 16], np.int32),
                              64, 8)
    jc = _to_jax(pc)
    chunk = _tokens(8, 2, 11)
    got, pc, _ = T.apply(PTINY, tp, torch.as_tensor(chunk), cache=pc,
                         mode="prefill", prefix_aware=True)
    want, jc, _ = JT.apply(TINY, jp, jnp.asarray(chunk), cache=jc,
                           mode="prefill", prefix_aware=True)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _assert_tree_close(pc, jc, **LOGIT_TOL)
    full, _, _ = JT.apply(TINY, jp, jnp.concatenate(
        [jnp.asarray(toks), jnp.asarray(chunk)], 1), mode="train")
    np.testing.assert_allclose(got.numpy(), full[:, 16:], **LOGIT_TOL)


# ---------------------------------------------------------------------------
# Paged runtime: the wire format, leaf for leaf
# ---------------------------------------------------------------------------

def test_wire_state_functions_vs_jax(weights):
    _, tp = weights
    toks = _tokens(9, 2, 21)
    pc = _paged_after_prefill(tp, toks, np.asarray([21, 21], np.int32),
                              48, 8)
    jc = _to_jax(pc)
    row = pc["block_tables"][1].numpy()[:3]
    st = KC.extract_paged_state(pc, 1, 8, table_row=row, length=21)
    jst = JKC.extract_paged_state(jc, 1, 8, table_row=row, length=21)
    _assert_tree_close(st, jst)
    _assert_tree_close(KC.split_paged_state(st, 1, 8),
                       JKC.split_paged_state(jst, 1, 8))
    _assert_tree_close(KC.paged_state_block(st, 2, 8),
                       JKC.paged_state_block(jst, 2, 8))
    _assert_tree_close(KC.page_payload(pc, 5, 8), JKC.page_payload(jc, 5, 8))
    pays = [KC.paged_state_block(st, j, 8) for j in range(2)]
    jpays = [JKC.paged_state_block(jst, j, 8) for j in range(2)]
    _assert_tree_close(KC.pages_from_payloads(pays, 16),
                       JKC.pages_from_payloads(jpays, 16))
    dense = KC.paged_state_to_dense(st, 8, 48)
    _assert_tree_close(dense, JKC.paged_state_to_dense(jst, 8, 48))
    _assert_tree_close(KC.dense_state_to_paged(dense, 8),
                       JKC.dense_state_to_paged(
                           JKC.paged_state_to_dense(jst, 8, 48), 8))
    assert KC.state_num_bytes(st) == JKC.state_num_bytes(jst)
    assert KC.layer_transfer_schedule(st, base_layer=2) == \
        JKC.layer_transfer_schedule(jst, base_layer=2)
    # the wire state crosses back into a JAX pool and a port pool alike
    blank = T.init_paged_cache(PTINY, 2, 48, 8, device="cpu")
    KC.insert_paged_state(blank, 0, st, [7, 3, 9], 8)
    jblank = JKC.insert_paged_state(JT.init_paged_cache(TINY, 2, 48, 8), 0,
                                    _to_jax(st), [7, 3, 9], 8)
    _assert_tree_close(blank, jblank)
    src, dst = [7, 3], [11, 12]
    KC.copy_pages(blank, src, dst, block_size=8)
    jblank = JKC.copy_pages(jblank, jnp.asarray(src), jnp.asarray(dst),
                            block_size=8)
    _assert_tree_close(blank, jblank)
    KC.reset_page_positions(blank, [7], 8)
    _assert_tree_close(blank, JKC.reset_page_positions(jblank, [7], 8))


def test_wire_state_from_numpy_keeps_ints():
    st = {"length": np.int32(5), "n_blocks": 2,
          "groups": ({"k": np.zeros((1, 2, 8, 1, 4), np.float32)},),
          "rem": ()}
    t = tree_from_numpy(st, device="cpu")
    assert t["n_blocks"] == 2 and isinstance(t["n_blocks"], int)
    assert int(t["length"]) == 5 and t["groups"][0]["k"].shape == \
        (1, 2, 8, 1, 4)


def test_block_pool_refcounts_match_jax():
    """The same alloc / ref / unref script gives the same pages, refcounts
    and free lists on both sides."""
    port, ref = KC.BlockPool(9), JKC.BlockPool(9)
    script = [("alloc", 3), ("ref", [1, 2]), ("unref", [1, 3]),
              ("alloc", 2), ("unref", [2, 2]), ("alloc", 4), ("ref", [4]),
              ("unref", [1, 4, 5])]
    for op, arg in script:
        a = getattr(port, op)(arg)
        b = getattr(ref, op)(arg)
        assert a == b, (op, arg)
        assert port.free_list == ref.free_list
        assert np.array_equal(port.refcount, ref.refcount)
        port.check()
    assert port.peak_used == ref.peak_used and port.used == ref.used
    with pytest.raises(AssertionError):
        port.unref([8])
    with pytest.raises(AssertionError):
        port.alloc(100)

