"""Cross attention (seamless-m4t-large-v2's text decoder over encoder
frames) in the port, against the JAX package (ROADMAP A6.4).

Held to JAX on inputs made from a seed with numpy (frames included),
weights from the JAX ``init`` through ``params_from_jax``: the cross part
of ``attention_apply`` (train, prefill writing the cross cache, decode
reading it through B5's plain version, bf16), two prefill chunks against
one pass, ``T.apply`` in every serving mode on the registry's ``smoke()``
and on a GQA variant, every ``models/kvcache.py`` helper over states
with nested ``cross`` dicts, the prefill hand-off against JAX's
``PrefillEngine`` (``run(req, frames)`` chunked, and a padded wave whose
dummy row gets zero frames), and served streams against JAX's
``T.prefill``/``T.decode_step`` rollout with the same frames: two
requests with their own frames in one paged decode batch, on dense rows,
through a 2-stage ``PrefillPipeline`` and ``DecodePipeline`` with a live
span move, and every ``CompiledStep`` over a cache holding ``cross`` bit
for bit against a direct ``T.apply``.  The ``Orchestrator`` refuses the
stack (it carries no frames, as JAX's).

Tolerances: float32 outputs and states 1e-5 (STATE_TOL: one layer, sums
in another order); a stack's logits and caches 1e-4 (LOGIT_TOL, as the
other stacks); bf16 outputs against JAX's bf16 at BF16_TOL (2^-7
absolute and relative: one or two bf16 steps on outputs of order 1, the
scores rounded at other places); helper outputs exactly; tokens exactly.

About 60 s on one worker, most of it JAX's eager rollouts and engines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.weights import params_from_jax, tree_from_numpy
from repro_torch.serving import engine as E
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine, check_servable)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Request
from repro_torch.serving.span import DecodePipeline, PrefillPipeline
from test_torch_registry import _to_jax, assert_tree_close, variant

STATE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)
EXACT = dict(atol=0, rtol=0)
ECFG = EngineConfig(max_len=64, max_batch=3, block_size=8)
JECFG = JEngineConfig(max_len=64, max_batch=3, block_size=8)

ARCH = "seamless-m4t-large-v2"
STACKS = {
    "smoke": variant(ARCH),
    # GQA (4 query heads on 2 kv heads), 3 layers, 12 frames
    "gqa": variant(ARCH, "gqa", n_layers=3, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128,
                   n_frames=12),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def stacks(model_zoo):
    """tag -> (JAX config, port config, JAX params, port params)."""
    out = {}
    for tag, (jc, pc) in STACKS.items():
        jp = model_zoo(jc)
        out[tag] = (jc, pc, jp, params_from_jax(
            pc, jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def _tokens(vocab, seed, *shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(cfg, seed, b=1):
    """Encoder frames (b, n_frames, d_model) from ``seed``."""
    return np.random.default_rng(1000 + seed).standard_normal(
        (b, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _requests(prompts, max_new=6):
    return [Request(rid=i, arrival=0.0, prompt=p.copy(),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]


# The served prompts share one length (JAX's eager rollout compiles per
# shape) and each request has its own frames.
PROMPTS = [_tokens(128, 40 + i, 21) for i in range(3)]


def jax_rollout(jc, jp, prompt, frames, n, max_len=64):
    """JAX's greedy stream: ``T.prefill`` of the prompt with its frames
    into a fresh cache, then ``T.decode_step``s reading the cached cross
    K/V."""
    cache = JT.init_cache(jc, 1, max_len)
    lg, cache, _ = JT.prefill(jc, jp, jnp.asarray(prompt)[None], cache,
                              frames=jnp.asarray(frames))
    out = [int(jnp.argmax(lg[0]))]
    while len(out) < n:
        lg, cache, _ = JT.decode_step(jc, jp, jnp.asarray([[out[-1]]]),
                                      cache)
        out.append(int(jnp.argmax(lg[0])))
    return out


# ---------------------------------------------------------------------------
# The cross part of attention_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "bf16"])
def test_cross_attention_apply_vs_jax(mode):
    """``attention_apply`` with ``cross_p`` against JAX's on the GQA
    shape: the output (self attention plus the cross output), the self
    cache and the cross cache (written in place by prefill, read as it is
    by a one-token decode step without frames)."""
    jc, pc = STACKS["gqa"]
    bf16 = mode == "bf16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    ks = jax.random.split(jax.random.PRNGKey(5), 2)
    jp = JL.init_attention(jc, ks[0], jdt)
    jcp = JL.init_attention(jc, ks[1], jdt)
    tp, tcp = (tree_from_numpy(jax.tree.map(np.asarray, t), device="cpu")
               for t in (jp, jcp))
    rng = np.random.default_rng(6)
    b, s = 2, 1 if mode == "decode" else 13
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    frames = _frames(jc, 7, b)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32) + (9 if s == 1
                                                          else 0),
                          (b, s)).copy()
    xt, xj = torch.as_tensor(x).to(tdt), jnp.asarray(x).astype(jdt)
    kw = dict(mode="decode" if s == 1 else "prefill", window=None)
    tol = BF16_TOL if bf16 else STATE_TOL
    if mode == "train":
        y, _ = L.attention_apply(pc, tp, xt, positions=torch.as_tensor(pos),
                                 state=None, mode="train", window=None,
                                 frames=torch.as_tensor(frames),
                                 cross_p=tcp)
        jy, _, jcross = JL.attention_apply(
            jc, jp, xj, positions=jnp.asarray(pos), state=None,
            mode="train", window=None, frames=jnp.asarray(frames),
            cross_p=jcp)
        np.testing.assert_allclose(_np(y), _np(jy), **tol)
        return
    L_ = 16
    kv_shape = (b, L_, jc.n_kv_heads, jc.head_dim)
    cross_shape = (b, jc.n_frames, jc.n_kv_heads, jc.head_dim)
    if s == 1:      # a decode step over 9 cached keys and cached frames
        k0, v0 = (rng.standard_normal(kv_shape).astype(np.float32)
                  for _ in range(2))
        p0 = np.where(np.arange(L_) < 9, np.arange(L_), -1).astype(np.int32)
        ck0, cv0 = (rng.standard_normal(cross_shape).astype(np.float32)
                    for _ in range(2))
    else:
        k0 = v0 = np.zeros(kv_shape, np.float32)
        p0 = -np.ones(L_, np.int32)
        ck0 = cv0 = np.zeros(cross_shape, np.float32)
    p0 = np.broadcast_to(p0, (b, L_)).copy()
    state = {"k": torch.tensor(k0).to(tdt), "v": torch.tensor(v0).to(tdt),
             "pos": torch.tensor(p0)}
    cross = {"k": torch.tensor(ck0).to(tdt), "v": torch.tensor(cv0).to(tdt)}
    ptrs = [t.data_ptr() for t in cross.values()]
    jstate = {"k": jnp.asarray(k0).astype(jdt),
              "v": jnp.asarray(v0).astype(jdt), "pos": jnp.asarray(p0)}
    jcross = {"k": jnp.asarray(ck0).astype(jdt),
              "v": jnp.asarray(cv0).astype(jdt)}
    y, st = L.attention_apply(
        pc, tp, xt, positions=torch.as_tensor(pos), state=state,
        frames=None if s == 1 else torch.as_tensor(frames).to(tdt),
        cross_p=tcp, cross_state=cross, **kw)
    jy, jst, jnew = JL.attention_apply(
        jc, jp, xj, positions=jnp.asarray(pos), state=jstate,
        frames=None if s == 1 else jnp.asarray(frames).astype(jdt),
        cross_p=jcp, cross_state=jcross, **kw)
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(_np(st[k]), _np(jst[k]), **tol)
    assert [t.data_ptr() for t in cross.values()] == ptrs    # in place
    for k in ("k", "v"):
        assert cross[k].dtype == tdt
        np.testing.assert_allclose(_np(cross[k]), _np(jnew[k]), **tol)
    if s == 1:
        np.testing.assert_array_equal(_np(cross["k"]), ck0.astype(
            np.float32))                      # decode leaves it as it was
    with pytest.raises(ValueError, match="frames"):
        L.attention_apply(pc, tp, xt, positions=torch.as_tensor(pos),
                          state=None, mode="train", window=None,
                          cross_p=tcp)


def test_cross_chunks_equal_one_pass(stacks):
    """A 19-token prompt prefilled in two chunks (the second
    prefix-aware over the dense cache, the frames given again) equals one
    pass: last logits, self caches and cross caches."""
    jc, pc, jp, tp = stacks["gqa"]
    toks = torch.as_tensor(_tokens(pc.vocab_size, 8, 1, 19))
    fr = torch.as_tensor(_frames(pc, 8))
    one = T.init_cache(pc, 1, 32, device="cpu")
    lg_one, _, _ = T.apply(pc, tp, toks, cache=one, frames=fr,
                           mode="prefill", logits_slice="last")
    two = T.init_cache(pc, 1, 32, device="cpu")
    T.apply(pc, tp, toks[:, :8], cache=two, frames=fr, mode="prefill")
    two["lengths"] += 8
    lg_two, two, _ = T.apply(pc, tp, toks[:, 8:], cache=two, frames=fr,
                             mode="prefill", prefix_aware=True,
                             logits_slice="last")
    np.testing.assert_allclose(lg_two.numpy(), lg_one.numpy(), **STATE_TOL)
    for a, b in zip(KC._leaves(two["groups"]), KC._leaves(one["groups"])):
        np.testing.assert_allclose(_np(a), _np(b), **STATE_TOL)


# ---------------------------------------------------------------------------
# Init, caches, T.apply
# ---------------------------------------------------------------------------

def test_init_and_caches_match_jax_layouts(stacks):
    """``init`` draws JAX's tree (``cross`` and the unread ``cross_norm``
    per attention layer), ``params_from_jax`` checks it, and the blank
    dense and paged caches equal JAX's leaf for leaf: the cross K/V
    (B, n_frames, KV, D) slot-dense in the model dtype, int8 KV or not;
    ``cross_norm`` does not move the logits."""
    jc, pc, jp, tp = stacks["gqa"]
    zeros = dict(atol=0, rtol=0)
    assert_tree_close(
        T._tree_map(lambda a: np.zeros(a.shape, np.float32),
                    T.init(pc, seed=0, device="cpu")),
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jp), **zeros)
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, groups=({k: v for k, v in tree["groups"][0].items()
                              if k != "cross_norm"},))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(pc, bad, device="cpu")
    for jq, pq in ((jc, pc), (jc.with_kv_quant(), pc.with_kv_quant())):
        assert_tree_close(T.init_cache(pq, 2, 16, device="cpu"),
                          JT.init_cache(jq, 2, 16), **zeros)
        assert_tree_close(T.init_paged_cache(pq, 2, 16, 8, device="cpu"),
                          JT.init_paged_cache(jq, 2, 16, 8), **zeros)
    cache = T.init_cache(pc.with_kv_quant(), 2, 16, dtype=torch.bfloat16,
                         device="cpu")
    assert cache["groups"][0]["k"].dtype == torch.int8
    assert cache["groups"][0]["cross"]["k"].dtype == torch.bfloat16
    toks = torch.as_tensor(_tokens(pc.vocab_size, 1, 2, 7))
    fr = torch.as_tensor(_frames(pc, 1, 2))
    want, _, _ = T.apply(pc, tp, toks, frames=fr, mode="train")
    moved = dict(tp, groups=({**tp["groups"][0], "cross_norm":
                              torch.ones_like(tp["groups"][0]["cross_norm"])
                              },))
    got, _, _ = T.apply(pc, moved, toks, frames=fr, mode="train")
    assert torch.equal(got, want)


def _prefilled(pc, tp, rows, frames, max_len=32):
    """A dense cache holding each row's prompt, prefilled with its own
    frames; also the JAX copy."""
    cache = T.init_cache(pc, len(rows), max_len, device="cpu")
    for i, toks in enumerate(rows):
        one = T.init_cache(pc, 1, max_len, device="cpu")
        T.apply(pc, tp, torch.as_tensor(toks)[None], cache=one,
                frames=torch.as_tensor(frames[i:i + 1]), mode="prefill")
        KC.insert_request_state(cache, i, KC.extract_request_state(one, 0))
    return cache


def _pages(pc, dense, bs=8):
    """The dense cache in pages, every row's table covering its page
    space."""
    b = int(dense["lengths"].shape[0])
    max_len = int(dense["groups"][0]["pos"].shape[-1])
    nb = max_len // bs
    pcache = T.init_paged_cache(pc, b, max_len, bs, device="cpu")
    for row in range(b):
        st = KC.dense_state_to_paged(KC.extract_request_state(dense, row),
                                     bs)
        KC.insert_paged_state(pcache, row, st, list(
            range(1 + row * nb, 1 + row * nb + st["n_blocks"])), bs)
        pcache["block_tables"][row] = torch.arange(1 + row * nb,
                                                   1 + (row + 1) * nb)
    return pcache


@pytest.mark.parametrize("tag", list(STACKS))
def test_cross_apply_vs_jax(stacks, tag):
    """``T.apply`` against JAX's with the same frames: the stateless
    forward, a fresh prefill into a dense cache (cross K/V written), decode
    steps over pages (B1's and B5's plain versions) and over dense rows
    (B5's twice), reading the cached frames, and a resumed chunk over the
    dense cache: logits and every cache leaf."""
    jc, pc, jp, tp = stacks[tag]
    v = pc.vocab_size
    toks = _tokens(v, 3, 2, 15)
    fr = _frames(pc, 3, 2)
    got, _, _ = T.apply(pc, tp, torch.as_tensor(toks),
                        frames=torch.as_tensor(fr), mode="train")
    want, _, _ = JT.apply(jc, jp, jnp.asarray(toks), frames=jnp.asarray(fr),
                          mode="train")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)

    got, cache, _ = T.apply(pc, tp, torch.as_tensor(toks),
                            cache=T.init_cache(pc, 2, 32, device="cpu"),
                            frames=torch.as_tensor(fr), mode="prefill",
                            logits_slice="last")
    want, jcache, _ = JT.apply(jc, jp, jnp.asarray(toks),
                               cache=JT.init_cache(jc, 2, 32),
                               frames=jnp.asarray(fr), mode="prefill",
                               logits_slice="last")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert_tree_close(cache, jcache)

    dense = _prefilled(pc, tp, [_tokens(v, 5, 14), _tokens(v, 6, 5)], fr)
    for paged in (True, False):
        cache = _pages(pc, dense) if paged else T._tree_map(torch.clone,
                                                            dense)
        jcache = _to_jax(cache)
        step = _tokens(v, 7, 2, 1)
        for _ in range(3):
            got, cache, _ = T.apply(pc, tp, torch.as_tensor(step),
                                    cache=cache, mode="decode",
                                    logits_slice="last", paged_kernel=True)
            want, jcache, _ = JT.apply(jc, jp, jnp.asarray(step),
                                       cache=jcache, mode="decode",
                                       logits_slice="last")
            np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
            step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        assert_tree_close(cache, jcache)

    chunk = _tokens(v, 8, 2, 9)
    cache = T._tree_map(torch.clone, dense)
    jcache = _to_jax(cache)
    got, cache, _ = T.apply(pc, tp, torch.as_tensor(chunk), cache=cache,
                            frames=torch.as_tensor(fr), mode="prefill",
                            prefix_aware=True)
    want, jcache, _ = JT.apply(jc, jp, jnp.asarray(chunk), cache=jcache,
                               frames=jnp.asarray(fr), mode="prefill",
                               prefix_aware=True)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert_tree_close(cache, jcache)


@pytest.mark.parametrize("stack, frames", [("bfloat16", "float32"),
                                           ("float32", "bfloat16")])
def test_frames_dtype_follows_jax(stacks, stack, frames):
    """Frames of another float type than the stack, as JAX takes them:
    bf16 frames on an f32 stack are widened (JAX's einsum promotes them),
    and the logits equal JAX's at LOGIT_TOL; f32 frames on a bf16 stack
    would widen the residual stream, which JAX's layer scan refuses
    (TypeError on its carry) and the port refuses with ``ValueError``."""
    jc, pc, jp, tp = stacks["gqa"]
    sdt, fdt = getattr(torch, stack), getattr(torch, frames)
    jsdt, jfdt = getattr(jnp, stack), getattr(jnp, frames)
    jp = jax.tree.map(lambda a: a.astype(jsdt), jp)
    tp = T._tree_map(lambda a: a.to(sdt), tp)
    toks = _tokens(pc.vocab_size, 4, 2, 11)
    fr = _frames(pc, 4, 2)
    ft = torch.as_tensor(fr).to(fdt)
    fj = jnp.asarray(fr).astype(jfdt)
    if stack == "bfloat16":
        with pytest.raises(TypeError, match="carry"):
            JT.apply(jc, jp, jnp.asarray(toks), frames=fj, mode="train")
        for mode in ("train", "prefill"):
            cache = (T.init_cache(pc, 2, 16, dtype=sdt, device="cpu")
                     if mode == "prefill" else None)
            with pytest.raises(ValueError, match="widen"):
                T.apply(pc, tp, torch.as_tensor(toks), cache=cache,
                        frames=ft, mode=mode)
        return
    got, _, _ = T.apply(pc, tp, torch.as_tensor(toks), frames=ft,
                        mode="train")
    want, _, _ = JT.apply(jc, jp, jnp.asarray(toks), frames=fj,
                          mode="train")
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_kvcache_helpers_with_cross_vs_jax(stacks):
    """Every ``models/kvcache.py`` helper on a cache whose attention states
    carry nested ``cross`` dicts equals JAX's bit for bit, the cross K/V
    slot-dense and whole: dense rows (extract, insert, blank), prefix
    slices and their merge, whole-cache paging both ways, the wire format
    both ways, one slot's pages out and into another pool, a head split,
    copy-on-write page copies, store payloads (a page, a wire block, and
    payloads stacked back), and the byte counts and per-layer schedule."""
    from repro_torch.models.weights import tree_from_numpy as tfn
    jc, pc, jp, tp = stacks["gqa"]
    toks = _tokens(pc.vocab_size, 12, 2, 13)
    fr = _frames(pc, 12, 2)
    _, jcache, _ = JT.apply(jc, jp, jnp.asarray(toks),
                            cache=JT.init_cache(jc, 2, 32),
                            frames=jnp.asarray(fr), mode="prefill")
    cache = tfn(jax.tree.map(np.asarray, jcache), device="cpu")
    assert_tree_close(KC.blank_request_state(cache),
                      JKC.blank_request_state(jcache), **EXACT)
    jst, st = JKC.extract_request_state(jcache, 1), \
        KC.extract_request_state(cache, 1)
    assert_tree_close(st, jst, **EXACT)
    assert_tree_close(KC.insert_request_state(T._tree_map(torch.clone,
                                                          cache), 0, st),
                      JKC.insert_request_state(jcache, 0, jst), **EXACT)
    jsl, sl = JKC.slice_prefix_kv(jst, 8, 16), KC.slice_prefix_kv(st, 8, 16)
    assert_tree_close(sl, jsl, **EXACT)
    blank, jblank = KC.blank_request_state(cache), \
        JKC.blank_request_state(jcache)
    assert_tree_close(KC.merge_prefix_kv(blank, sl, 8),
                      JKC.merge_prefix_kv(jblank, jsl, 8), **EXACT)
    jpc, pcache = JKC.dense_to_paged(jcache, 8), KC.dense_to_paged(cache, 8)
    assert_tree_close(pcache, jpc, **EXACT)
    assert_tree_close(KC.paged_to_dense(pcache, 8),
                      JKC.paged_to_dense(jpc, 8), **EXACT)
    jw, w = JKC.dense_state_to_paged(jst, 8), KC.dense_state_to_paged(st, 8)
    assert_tree_close(w, jw, **EXACT)
    assert w["n_blocks"] == 2 and w["groups"][0]["cross"]["k"].shape == \
        (3, pc.n_frames, pc.n_kv_heads, pc.head_dim)
    assert_tree_close(KC.paged_state_to_dense(w, 8, 32),
                      JKC.paged_state_to_dense(jw, 8, 32), **EXACT)
    jx, x = JKC.extract_paged_state(jpc, 1, 8), \
        KC.extract_paged_state(pcache, 1, 8)
    assert_tree_close(x, jx, **EXACT)
    jnew = JKC.dense_to_paged(JT.init_cache(jc, 2, 32), 8)
    new = KC.dense_to_paged(T.init_cache(pc, 2, 32, device="cpu"), 8)
    assert_tree_close(KC.insert_paged_state(new, 0, x, [2, 3, 4, 5], 8),
                      JKC.insert_paged_state(jnew, 0, jx, [2, 3, 4, 5], 8),
                      **EXACT)
    assert_tree_close(KC.split_paged_state(w, 1, 8),
                      JKC.split_paged_state(jw, 1, 8), **EXACT)
    assert_tree_close(
        KC.copy_pages(T._tree_map(torch.clone, pcache), [1, 2], [5, 6],
                      block_size=8),
        JKC.copy_pages(jpc, jnp.asarray([1, 2]), jnp.asarray([5, 6]),
                       block_size=8), **EXACT)
    assert_tree_close(KC.page_payload(pcache, 2, 8),
                      JKC.page_payload(jpc, 2, 8), **EXACT)
    blocks = [KC.paged_state_block(w, j, 8) for j in range(2)]
    jblocks = [JKC.paged_state_block(jw, j, 8) for j in range(2)]
    for a, b in zip(blocks, jblocks):
        assert_tree_close(a, b, **EXACT)
    assert_tree_close(KC.pages_from_payloads(blocks, 13),
                      JKC.pages_from_payloads(jblocks, 13), **EXACT)
    assert KC.state_num_bytes(w) == JKC.state_num_bytes(jw)
    sched = KC.layer_transfer_schedule(w)
    assert sched == JKC.layer_transfer_schedule(jw)
    cross_b = 2 * pc.n_frames * pc.n_kv_heads * pc.head_dim * 4
    page_b = 2 * 8 * (2 * pc.n_kv_heads * pc.head_dim * 4 + 4)
    assert [b for _, b in sched] == [cross_b + page_b] * 3


# ---------------------------------------------------------------------------
# Serving through the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [10, None])
def test_handoff_equals_jax_prefill_engine(stacks, chunk):
    """``PrefillEngine.run(req, frames)`` and ``run_batch(reqs, frames)``
    against JAX's engine: the same waves (padded suffixes; three rows
    padded to four at ``max_batch`` 4, the dummy row on zero frames),
    each paged wire state (cross K/V slot-dense) and its logits; chunk
    resumes run over the dense wave cache, as JAX's (``_paged_inc`` off:
    B3 never runs)."""
    jc, pc, jp, tp = stacks["gqa"]
    ecfg = dataclasses.replace(ECFG, max_batch=4)
    pe = PrefillEngine(pc, tp, ecfg, device="cpu")
    je = JPrefill(jc, jp, dataclasses.replace(JECFG, max_batch=4))
    assert not pe._paged_inc and not je._paged_inc and pe._pad
    prompts = [_tokens(128, 50 + i, 23) for i in range(3)]
    fr = _frames(pc, 50, 3)
    for batch in (False, True):
        if batch:       # one wave of three rows padded to four
            got = pe.run_batch(_requests(prompts, 2),
                               frames=torch.as_tensor(fr),
                               chunk_tokens=chunk)
            want = je.run_batch([JRequest(rid=i, arrival=0.0, prompt=p,
                                          max_new_tokens=2)
                                 for i, p in enumerate(prompts)],
                                frames=jnp.asarray(fr), chunk_tokens=chunk)
        else:
            got = [pe.run_batch(_requests(prompts[:1], 2),
                                frames=torch.as_tensor(fr[:1]),
                                chunk_tokens=chunk)[0]]
            want = [je.run_batch([JRequest(rid=0, arrival=0.0,
                                           prompt=prompts[0],
                                           max_new_tokens=2)],
                                 frames=jnp.asarray(fr[:1]),
                                 chunk_tokens=chunk)[0]]
        for (pst, plg), (jst, jlg) in zip(got, want):
            np.testing.assert_allclose(plg.numpy(), jlg, **LOGIT_TOL)
            assert int(pst["n_blocks"]) == int(jst["n_blocks"]) == 3
            assert int(pst["length"]) == int(jst["length"])
            assert_tree_close({k: pst[k] for k in ("groups", "rem")},
                              {k: jst[k] for k in ("groups", "rem")})
    assert (4, 32 if chunk is None else 10, False) in pe.prefill_shapes
    assert pe.compile_report()["shapes"] == \
        sorted(je.compile_report()["shapes"])
    with pytest.raises(ValueError, match="frames batch"):
        pe.run_batch(_requests(prompts[:2], 2), frames=torch.as_tensor(fr))


def _serve_engines(pc, tp, reqs, frames, ecfg, *, pipeline=None,
                   move=None):
    """Prefill each request with its own frames (chunks of 10), insert it
    into one decode unit (a full-stack engine, or a ``DecodePipeline``
    over ``pipeline`` bounds, whose prefill is a ``PrefillPipeline`` over
    the same bounds), and step it to completion; ``move`` = (src, dst, n)
    is a live span move after the second step."""
    if pipeline is None:
        pe, de = PrefillEngine(pc, tp, ecfg, device="cpu"), \
            DecodeEngine(pc, tp, ecfg, device="cpu")
    else:
        pe = PrefillPipeline(pc, tp, ecfg, pipeline, device="cpu")
        de = DecodePipeline(pc, tp, ecfg, pipeline, device="cpu")
    for r, f in zip(reqs, frames):
        st, lg = pe.run_batch([r], frames=torch.as_tensor(f[None]),
                              chunk_tokens=10)[0]
        de.insert(r, st, int(torch.argmax(lg)))
    n, moved = 0, None
    while de.active:
        de.step()
        n += 1
        if move is not None and n == 2:
            moved = de.move_span(*move)
    return de, moved


@pytest.mark.parametrize("layout", ["paged", "dense-rows", "pipeline"])
def test_seamless_streams_equal_jax_rollout(stacks, layout):
    """Three requests, each prefilled with its own frames by
    ``PrefillEngine`` (chunks of 10) and decoded together in one batch:
    over pages (B1 and B5 plain), on dense rows (``max_len`` 60, no
    multiple of the block), and through a 2-stage ``PrefillPipeline`` and
    ``DecodePipeline`` with a live span move of one layer (its bytes
    count each resident's cross K/V).  Every stream equals JAX's rollout
    with the same frames."""
    jc, pc, jp, tp = stacks["gqa"]
    frames = [_frames(pc, 60 + i)[0] for i in range(3)]
    want = [jax_rollout(jc, jp, p, f[None], 6)
            for p, f in zip(PROMPTS, frames)]
    reqs = _requests(PROMPTS, 6)
    ecfg = dataclasses.replace(ECFG, max_len=60) \
        if layout == "dense-rows" else ECFG
    de, moved = _serve_engines(
        pc, tp, reqs, frames, ecfg,
        pipeline=[(0, 1), (1, 3)] if layout == "pipeline" else None,
        move=(1, 0, 1) if layout == "pipeline" else None)
    for r, w in zip(reqs, want):
        assert r.generated == w, r.rid
    if layout == "pipeline":
        assert de.bounds == [(0, 2), (2, 3)]
        cross_b = 2 * pc.n_frames * pc.n_kv_heads * pc.head_dim * 4
        assert moved["layers"] == 1 and moved["kv_bytes"] > 3 * cross_b
    else:
        assert de.paged == (layout == "paged")
        assert check_servable(pc, ecfg) == (64 if de.paged else None)


def test_compiled_steps_over_a_cross_cache_equal_direct_apply(
        stacks, monkeypatch):
    """Every ``CompiledStep`` call of a decode engine whose cache holds
    ``cross`` dicts equals a direct ``T.apply`` on a cloned cache bit for
    bit; the capture's restored leaves (``_state_leaves``) hold no cross
    cache (decode never writes it), and no cache tensor is rebound."""
    jc, pc, jp, tp = stacks["smoke"]
    orig = E.CompiledStep.__call__
    ptrs = {}

    def call(step, x):
        x = torch.as_tensor(x).clone()
        leaves = KC._leaves(step.cache)
        assert ptrs.setdefault(id(step), [t.data_ptr() for t in leaves]) \
            == [t.data_ptr() for t in leaves]
        assert step._state_leaves() == []
        snap = T._tree_map(lambda a: a.clone(), step.cache)
        out = orig(step, x)
        want, wcache, _ = T.apply(step.cfg, step.params, x.to(step.x.dtype),
                                  cache=snap, mode="decode",
                                  **step.apply_kw)
        assert torch.equal(out, want)
        assert torch.equal(step.cache["lengths"], wcache["lengths"])
        for got, exp in zip(KC._leaves((step.cache["groups"],
                                        step.cache["rem"])),
                            KC._leaves((wcache["groups"], wcache["rem"]))):
            assert torch.equal(got, exp)
        return out.clone()

    monkeypatch.setattr(E.CompiledStep, "__call__", call)
    prompts = [_tokens(pc.vocab_size, 70 + i, 12) for i in range(2)]
    frames = [_frames(pc, 70 + i)[0] for i in range(2)]
    reqs = _requests(prompts, 4)
    de, _ = _serve_engines(pc, tp, reqs, frames, ECFG)
    assert ptrs and all(len(r.generated) == 4 for r in reqs)
    for r, p, f in zip(reqs, prompts, frames):
        assert r.generated == jax_rollout(jc, jp, p, f[None], 4)


def test_orchestrator_refuses_cross_attention(stacks):
    """JAX's orchestrator carries no frames (``Request`` has none); the
    port's ``Orchestrator``, and so every ``Server`` over it, raises
    ``ValueError`` for a cross-attention stack before it builds any
    engine."""
    jc, pc, jp, tp = stacks["smoke"]
    with pytest.raises(ValueError, match="frames"):
        Orchestrator(pc, tp, OrchestratorConfig(n_prefill=1, n_decode=1,
                                                engine=ECFG), device="cpu")
    assert not hasattr(Request(rid=0, arrival=0.0, prompt=PROMPTS[0],
                               max_new_tokens=1), "frames")


@pytest.mark.parametrize("arch", ["gqa", "recurrentgemma-9b"])
def test_partitioned_executor_vs_jax(stacks, model_zoo, arch):
    """``PartitionedExecutor.forward`` against JAX's executor: with frames
    for the cross-attention stack, and for the hybrid family, whose
    embedding both scale by sqrt(d_model); a migrated layer span keeps
    the logits."""
    from repro.core import layer_migration as JLM
    from repro_torch.core import layer_migration as LM
    if arch == "gqa":
        jc, pc, jp, tp = stacks["gqa"]
    else:
        jc, pc = variant(arch)
        jp = model_zoo(jc)
        tp = params_from_jax(pc, jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(pc.vocab_size, 9, 2, 11)
    fr = _frames(pc, 9, 2) if pc.cross_attention else None
    where = ["p0"] * pc.n_layers
    ex = LM.PartitionedExecutor(pc, tp, where)
    jex = JLM.PartitionedExecutor(jc, jp, where)
    ex.migrate(1, pc.n_layers, "p1")
    got, _, shares = ex.forward(
        torch.as_tensor(toks, dtype=torch.long),
        frames=None if fr is None else torch.as_tensor(fr))
    want, _, _ = jex.forward(jnp.asarray(toks),
                             frames=None if fr is None else jnp.asarray(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert set(shares) == {"p0", "p1"}
