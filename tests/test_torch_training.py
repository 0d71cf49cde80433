"""The port's training path against the JAX package's (ROADMAP A10):
the data pipeline, AdamW, the LM loss and its gradients, the train step
(microbatches, remat), checkpoints in both directions, the train CLI and
the two ported examples.  ~60 s on one worker, most of it JAX's jitted
gradients and steps.

Weights come from the JAX ``init`` through ``params_from_jax``; tokens,
frames and gradients from numpy seeds.  Tolerances, float32 on both
sides:
- data batches: bit for bit (the pipeline is numpy on both sides);
- the schedule: 1e-7 relative (one f32 cos);
- AdamW on f32 trees: 1e-6 relative, 1e-7 absolute after three steps
  (f32 pow, sqrt and division in two libraries); on bf16 trees, after the
  cast, every element equal or one bf16 step apart;
- loss: 1e-6 relative; each gradient leaf: 2e-4 of the leaf's largest
  |JAX gradient| (sums in another order; the xLSTM's exponential gating
  shows the most, ~5e-5);
- train steps: loss and grad norm 1e-5 relative, parameters 1e-5
  absolute after three steps (Adam's first steps move each weight by
  ~lr, nearly independent of the gradient's size);
- microbatches 4 vs 1: JAX's own test's bounds (loss 1e-4, parameters
  rtol 2e-3, atol 2e-4); remat vs no remat: equal (the recompute is the
  same arithmetic);
- checkpoints: bit for bit.
"""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data import pipeline as JD
from repro.launch import train as JL
from repro.models import transformer as JT
from repro.models.config import Family as JFamily
from repro.models.config import ModelConfig as JModelConfig
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training import train_step as JS
from repro_torch import configs as port_configs
from repro_torch.data import pipeline as PD
from repro_torch.launch import train as PL
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as S
from repro_torch.training.tree import named_leaves

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=256)
JCFG = JModelConfig(family=JFamily.DENSE, **TINY)
PCFG = ModelConfig(family=Family.DENSE, **TINY)
ARCHS = ["llama-13b", "granite-moe-3b-a800m", "recurrentgemma-9b",
         "xlstm-350m", "seamless-m4t-large-v2"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_named(tree):
    """{name: numpy leaf} of a JAX tree, named as its checkpoint names
    them."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_named(tree):
    return {n: a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
            for n, a in named_leaves(tree)}


def bf16_steps_apart(a, b):
    """Elementwise distance in bf16 steps between two bf16 arrays (as
    float32 numpy), through the bits' monotone ordering."""
    def key(x):
        u = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(u & 0x8000, 0x8000 - (u & 0x7FFF), 0x8000 + u)
    return np.abs(key(a) - key(b))


def arch_pair(name):
    jc, pc = jax_configs.get(name).smoke(), port_configs.get(name).smoke()
    jp = JT.init(jc, jax.random.PRNGKey(0))
    pp = params_from_jax(pc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, pc, jp, pp


def tiny_pair():
    jp = JT.init(JCFG, jax.random.PRNGKey(0))
    pp = params_from_jax(PCFG, jax.tree.map(np.asarray, jp), device="cpu")
    return jp, pp


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_data_batches_equal_jax(seed):
    kw = dict(vocab_size=32000, seq_len=64, global_batch=4, seed=seed)
    j, p = iter(JD.SyntheticTokens(JD.DataConfig(**kw))), \
        iter(PD.SyntheticTokens(PD.DataConfig(**kw)))
    for _ in range(3):
        a, b = next(j)["tokens"], next(p)["tokens"]
        assert a.dtype == b.dtype == np.int32 and a.shape == (4, 65)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JD.prompt_tokens(512, 40, seed),
                                  PD.prompt_tokens(512, 40, seed))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)


def test_schedule_matches_jax():
    jc, pc = JO.AdamWConfig(**OPT), O.AdamWConfig(**OPT)
    for step in (0, 1, 2, 3, 6, 10, 12):
        want = float(JO.schedule(jc, jnp.asarray(step)))
        got = float(O.schedule(pc, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-7, abs=1e-12), step
    # JAX's own checks (tests/test_training.py), on the port
    cfg = O.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    assert float(O.schedule(cfg, 0)) == 0.0
    assert float(O.schedule(cfg, 10)) == pytest.approx(1.0)
    assert float(O.schedule(cfg, 100)) == pytest.approx(0.1)


def _opt_tree(rng, scale=1.0):
    """A tree with stacked and unstacked leaves of both ranks."""
    shapes = {"embed": (16, 8), "out_norm": (8,),
              "groups": ({"norm1": (2, 8), "w": (2, 8, 8)},),
              "rem": ({"norm1": (8,), "w": (8, 8)},)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        if isinstance(s, tuple) and isinstance(s[0], dict):
            return tuple(draw(v) for v in s)
        return (scale * rng.normal(size=s)).astype(np.float32)
    return draw(shapes)


def _to_port(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_port(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_port(v, dtype) for v in tree)
    return torch.tensor(tree).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(dtype, monkeypatch):
    """Three AdamW steps on the same numpy gradients (the second past the
    clip), with each leaf worked in slices (``CHUNK_ELEMS`` cut to 20):
    f32 trees within 1e-6, bf16 trees one bf16 step at most."""
    monkeypatch.setattr(O, "CHUNK_ELEMS", 20)
    rng = np.random.default_rng(1)
    p0 = _opt_tree(rng)
    grads = [_opt_tree(rng, scale) for scale in (0.01, 3.0, 0.1)]
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg, pcfg = JO.AdamWConfig(**OPT), O.AdamWConfig(**OPT)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    pp = _to_port(p0, pdt)
    jst, pst = JO.init_state(jp), O.init_state(pp)
    for g in grads:
        jp, jst, jm = JO.apply_updates(
            jcfg, jp, jax.tree.map(lambda a: jnp.asarray(a, jdt), g), jst)
        pp2, pst, pm = O.apply_updates(pcfg, pp, _to_port(g, pdt), pst)
        assert pp2 is pp
        assert float(pm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(pm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert int(pst["step"]) == int(jst["step"]) == 3
    assert all(a.dtype == torch.float32 for _, a in named_leaves(pst["mu"]))
    want, got = jax_named(jp), port_named(pp)
    for name, a in want.items():
        if dtype == "float32":
            np.testing.assert_allclose(got[name], a, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            assert bf16_steps_apart(got[name], a.astype(np.float32)).max() \
                <= 1, name
    for key in ("mu", "nu"):
        for name, a in jax_named(jst[key]).items():
            np.testing.assert_allclose(port_named(pst[key])[name], a,
                                       rtol=1e-5, atol=1e-9, err_msg=name)


def test_weight_decay_counts_the_stacked_axis():
    """R5: with zero gradients only weight decay moves a leaf, and it
    moves exactly the leaves of rank >= 2: the stacked norm in ``groups``
    (n_rep, d) is decayed, the ``rem`` and out norms are not; JAX does
    the same."""
    rng = np.random.default_rng(2)
    p0 = _opt_tree(rng)
    zeros = jax.tree.map(np.zeros_like, p0)
    jp, _, _ = JO.apply_updates(JO.AdamWConfig(**OPT),
                                jax.tree.map(jnp.asarray, p0),
                                jax.tree.map(jnp.asarray, zeros),
                                JO.init_state(p0))
    pp = _to_port(p0, torch.float32)
    O.apply_updates(O.AdamWConfig(**OPT), pp,
                    _to_port(zeros, torch.float32), O.init_state(pp))
    before = jax_named(p0)
    moved = {"embed", "groups/0/norm1", "groups/0/w", "rem/0/w"}
    for side in (jax_named(jp), port_named(pp)):
        changed = {n for n, a in side.items()
                   if not np.array_equal(a, before[n])}
        assert changed == moved


# ---------------------------------------------------------------------------
# The LM loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """lm_loss and every gradient leaf against ``jax.value_and_grad`` at
    the arch's smoke size (granite-moe with its load-balance loss,
    seamless with frames from a seed)."""
    jc, pc, jp, pp = arch_pair(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (2, 17)).astype(np.int32)
    frames = (rng.normal(size=(2, jc.n_frames, jc.d_model)).astype(
        np.float32) if jc.cross_attention else None)

    def loss_fn(p):
        return JS.lm_loss(jc, p, jnp.asarray(toks), frames=(
            None if frames is None else jnp.asarray(frames)))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    batch = {"tokens": torch.from_numpy(toks)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    loss, aux, grads = S.loss_and_grads(pc, pp, batch)
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    assert float(aux["nll"]) == pytest.approx(float(jaux["nll"]), rel=1e-6)
    if jc.n_experts:
        assert float(aux["lb_loss"]) == pytest.approx(
            float(jaux["lb_loss"]), rel=1e-6)
    want, got = jax_named(jg), port_named(grads)
    assert set(got) == set(want)
    for name, g in want.items():
        tol = 2e-4 * max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(got[name], g, rtol=0, atol=tol,
                                   err_msg=name)
    assert not any(a.requires_grad for _, a in named_leaves(pp))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _batches(n, batch=8, seq=32, seed=0):
    data = iter(JD.SyntheticTokens(JD.DataConfig(
        vocab_size=256, seq_len=seq, global_batch=batch, seed=seed)))
    return [next(data)["tokens"] for _ in range(n)]


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(n_steps):
    jp, pp = tiny_pair()
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstep = jax.jit(JS.make_train_step(JCFG, JO.AdamWConfig(**ocfg)))
    pstep = S.make_train_step(PCFG, O.AdamWConfig(**ocfg))
    jst, pst = JO.init_state(jp), O.init_state(pp)
    for toks in _batches(n_steps):
        jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(toks)})
        pp, pst, pm = pstep(pp, pst, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    want = jax_named(jp)
    for name, a in port_named(pp).items():
        np.testing.assert_allclose(a, want[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    assert not any(a.requires_grad for _, a in named_leaves(pp))


def test_microbatched_grads_match_full_batch():
    """JAX's ``test_microbatched_grads_match_full_batch`` on the port,
    and the port's four microbatches against JAX's."""
    jp, _ = tiny_pair()
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (8, 17), 0,
                                       256), np.int32)
    runs = {}
    for mb in (1, 4):
        _, pp = tiny_pair()
        step = S.make_train_step(PCFG, O.AdamWConfig(lr=1e-3),
                                 num_microbatches=mb)
        pp, _, m = step(pp, O.init_state(pp),
                        {"tokens": torch.from_numpy(toks)})
        runs[mb] = (port_named(pp), m)
    assert abs(float(runs[1][1]["loss"]) - float(runs[4][1]["loss"])) < 1e-4
    for name, a in runs[1][0].items():
        np.testing.assert_allclose(a, runs[4][0][name], rtol=2e-3,
                                   atol=2e-4, err_msg=name)
    jstep = JS.make_train_step(JCFG, JO.AdamWConfig(lr=1e-3),
                               num_microbatches=4)
    jp, _, jm = jstep(jp, JO.init_state(jp), {"tokens": jnp.asarray(toks)})
    for k in ("loss", "nll", "grad_norm"):
        assert float(runs[4][1][k]) == pytest.approx(float(jm[k]),
                                                     rel=1e-5), k
    with pytest.raises(ValueError, match="microbatches"):
        S.loss_and_grads(PCFG, tiny_pair()[1],
                         {"tokens": torch.from_numpy(toks[:6])},
                         num_microbatches=4)


@pytest.mark.parametrize("arch", ["llama-13b", "granite-moe-3b-a800m",
                                  "xlstm-350m"])
def test_remat_matches_no_remat(arch, monkeypatch):
    """Remat checkpoints every stacked layer's block (and only with
    ``remat``); loss and gradients are equal either way."""
    jc, pc, _, pp = arch_pair(arch)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, pc.vocab_size, (4, 17)).astype(np.int32))
    real, calls = torch.utils.checkpoint.checkpoint, []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = []
    for remat in (False, True):
        got.append(S.loss_and_grads(pc, pp, {"tokens": toks}, remat=remat))
        assert len(calls) == remat * (pc.n_layers // len(pc.block_pattern)
                                      * len(pc.block_pattern))
    assert float(got[0][0]) == float(got[1][0])
    for (name, a), (_, b) in zip(named_leaves(got[0][2]),
                                 named_leaves(got[1][2])):
        assert torch.equal(a, b), name


def test_quantized_tree_raises():
    _, pp = tiny_pair()
    step = S.make_train_step(PCFG, O.AdamWConfig())
    qp = Q.quantize_weights(pp)
    batch = {"tokens": torch.from_numpy(_batches(1)[0])}
    with pytest.raises(ValueError, match="serving-only"):
        step(qp, O.init_state(pp), batch)


def test_serving_modes_build_no_graph():
    """Prefill and decode run under no_grad even inside ``enable_grad`` on
    leaves that require grad (CUDA-graph capture and span views rely on
    it); train mode builds a graph there."""
    _, pp = tiny_pair()
    for _, a in named_leaves(pp):
        a.requires_grad_(True)
    toks = torch.from_numpy(_batches(1, batch=2, seq=7)[0])
    cache = T.init_cache(PCFG, 2, 16, device="cpu")
    with torch.enable_grad():
        lg, cache, _ = T.apply(PCFG, pp, toks[:, :6], cache=cache,
                               mode="prefill", logits_slice="last")
        assert not lg.requires_grad
        lg, cache, _ = T.decode_step(PCFG, pp, toks[:, 6:7], cache)
        assert not lg.requires_grad
        assert not any(t.requires_grad for _, t in named_leaves(cache))
        lg, _ = T.forward_train(PCFG, pp, toks)
        assert lg.requires_grad
    with torch.no_grad():
        assert not T.forward_train(PCFG, pp, toks)[0].requires_grad


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(dtype, tmp_path):
    """A JAX-saved granite-moe smoke tree (bf16 with its f32 router)
    restores into the port bit for bit."""
    jc = jax_configs.get("granite-moe-3b-a800m").smoke()
    pc = port_configs.get("granite-moe-3b-a800m").smoke()
    jp = JT.init(jc, jax.random.PRNGKey(3), dtype=getattr(jnp, dtype))
    JC.save(str(tmp_path), jp, step=5)
    want = params_from_jax(pc, jax.tree.map(np.asarray, jp), device="cpu")
    like = T.init(pc, seed=1, dtype=getattr(torch, dtype), device="cpu")
    got, step = C.restore(str(tmp_path), like)
    assert step == 5 == C.latest_step(str(tmp_path))
    for (name, a), (_, b) in zip(named_leaves(want), named_leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), name


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port-saved f32 tree restores through JAX's ``restore``; a bf16
    tree writes the same arrays (raw bf16 bits) as JAX's save of it."""
    jc = jax_configs.get("granite-moe-3b-a800m").smoke()
    pc = port_configs.get("granite-moe-3b-a800m").smoke()
    jp = JT.init(jc, jax.random.PRNGKey(4))
    pp = params_from_jax(pc, jax.tree.map(np.asarray, jp), device="cpu")
    C.save(str(tmp_path / "f32"), pp, step=2, meta={"arch": pc.name})
    back, step = JC.restore(str(tmp_path / "f32"), jp)
    assert step == 2
    for name, a in jax_named(jp).items():
        np.testing.assert_array_equal(jax_named(back)[name], a,
                                      err_msg=name)
    jb = JT.init(jc, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    pb = params_from_jax(pc, jax.tree.map(np.asarray, jb), device="cpu")
    JC.save(str(tmp_path / "jax"), jb, step=1)
    C.save(str(tmp_path / "port"), pb, step=1)
    with np.load(tmp_path / "jax" / "ckpt_1.npz") as a, \
            np.load(tmp_path / "port" / "ckpt_1.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].tobytes() == b[name].tobytes(), name
    assert (tmp_path / "port" / "ckpt_1.json").read_text() == \
        (tmp_path / "jax" / "ckpt_1.json").read_text()


# ---------------------------------------------------------------------------
# The train CLI and the examples
# ---------------------------------------------------------------------------

LOG = re.compile(r"^step +\d+  loss \d+\.\d{4}  nll \d+\.\d{4}  gnorm "
                 r"\d+\.\d{3}  lr \d\.\d\de[-+]\d\d  \(\d+ ms/step\)$")


def test_train_cli_logs_as_jax(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train`` prints JAX's lines at JAX's
    steps, and its checkpoint restores through JAX's ``restore``."""
    args = ["--arch", "llama-13b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq", "16", "--log-every", "2"]
    PL.main(args + ["--device", "cpu", "--ckpt", str(tmp_path)])
    port = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    JL.main()
    jax_out = capsys.readouterr().out.splitlines()
    assert port[0] == jax_out[0]            # arch=... params=...
    steps = [[ln.split()[1] for ln in out if ln.startswith("step")]
             for out in (port, jax_out)]
    assert steps[0] == steps[1] == ["1", "2"]
    assert all(LOG.match(ln) for ln in port if ln.startswith("step"))
    assert port[-1] == f"checkpoint -> {tmp_path}"
    jc = jax_configs.get("llama-13b").smoke()
    _, step = JC.restore(str(tmp_path), JT.init(jc, jax.random.PRNGKey(0)))
    assert step == 3


def test_train_cli_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("name,steps", [("torch_train_lm", 12),
                                        ("torch_quickstart", 10)])
def test_examples_run_on_the_cpu(name, steps, capsys):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--steps", str(steps)])
    out = capsys.readouterr().out
    assert ("improved" in out and "round-trip" in out) \
        if name == "torch_train_lm" else out.rstrip().endswith("OK")
