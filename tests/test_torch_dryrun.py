"""The port's dry run and cost tables (``launch/steps.py``,
``cost_analysis.py``, ``dryrun.py``, ``hillclimb.py``) and the kernels as
custom operators (``kernels/custom_ops.py``).

* The framework-free tables equal JAX's: ``analytical_bytes_per_chip`` and
  ``model_flops`` over the 10 assigned archs x 4 shapes x 2 meshes,
  ``VARIANTS``' keys, ``MOE_CF`` and ``TRAIN_MICROBATCHES``.  JAX's
  ``dryrun.py`` and ``hillclimb.py`` set ``XLA_FLAGS`` at import, so they
  run in a subprocess (as ``tests/test_launch.py`` runs JAX's CLI).
* ``steps.build`` applies JAX's rules: the arguments' placements are
  JAX's specs for the config JAX's ``build`` derives (``arch_for_shape``,
  ``with_kv_quant``, ``fsdp_weights`` for training unless small), the
  donated arguments, and ``ValueError`` for int8 weights in training;
  xlstm-350m's train and prefill steps build (its scans are operators).
* The fake-against-real check: on a 2 x 2 mesh, the dry run over a
  4-rank fake group (``meta`` shards) gives rank 0 the same flops,
  collective counts and bytes, resident and argument bytes as the same
  step run on values by 4 gloo ranks (``WORKER``), and its transient peak
  within 10 % (a real collective holds its buffers until waited; on a
  one-rank group the two peaks are equal), for a dense config (train,
  prefill, decode), a MoE smoke config (prefill, decode) and a narrow
  mLSTM + sLSTM stack (train, prefill: the scan operators); the gloo
  run's logits equal the plain single-process forward's.
* The depth extension (two and three repeats, extended linearly) equals
  a full-depth run at 4 repeats.
* Each custom operator on the CPU equals its plain version bit for bit,
  gives the same shapes on ``meta``, and ``FlopCounterMode`` counts its
  formula.
* The command lines: ``dryrun`` (xlstm-350m, decode_32k, single, as
  ``tests/test_launch.py``) and ``hillclimb``.

Tolerances: figures exactly, the transient peak 10 %; logits 1e-4 (float32 sums over shards in
another order).  ~50 s on one worker: the gloo spawn ~15 s, the JAX
subprocess ~10 s, the two command lines ~15 s.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.launch import specs as JS
from repro.launch import steps as JSTEPS
from repro_torch import configs
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import ref
from repro_torch.kernels import split_kv_decode as SK
from repro_torch.kernels.custom_ops import causal_pairs
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hillclimb as HC
from repro_torch.launch import specs as S
from repro_torch.launch import steps
from repro_torch.launch.mesh import axis_names, make_production_mesh
from repro_torch.models.config import Family, ModelConfig
from repro_torch.training.tree import named_leaves

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


class FakeMesh:
    """Mesh stand-in: axis name -> size (the policies and the traffic
    model read only ``shape`` and ``axis_names``)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}

JAX_TABLES = textwrap.dedent("""
    import json, sys
    from repro import configs
    from repro.launch import dryrun, hillclimb, specs as S, steps

    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape
            self.axis_names = tuple(shape)

    meshes = json.loads(sys.argv[1])
    out = {"variants": hillclimb.VARIANTS, "moe_cf": steps.MOE_CF,
           "micro": steps.TRAIN_MICROBATCHES, "rows": []}
    for arch in configs.names(assigned_only=True):
        for shape_name, shape in S.SHAPES.items():
            cfg = S.arch_for_shape(configs.get(arch), shape)
            for kind, axes in meshes.items():
                n = 1
                for v in axes.values():
                    n *= v
                out["rows"].append([
                    arch, shape_name, kind,
                    dryrun.analytical_bytes_per_chip(cfg, shape, n,
                                                     FakeMesh(axes)),
                    dryrun.model_flops(cfg, shape)])
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_tables():
    out = subprocess.run(
        [sys.executable, "-c", JAX_TABLES, json.dumps(MESHES)],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_analytical_tables_match_jax(jax_tables):
    """``analytical_bytes_per_chip`` and ``model_flops`` equal JAX's on
    every assigned arch x shape x mesh; the knobs and variants too."""
    assert len(jax_tables["rows"]) == 10 * 4 * 2
    for arch, shape_name, kind, jbytes, jflops in jax_tables["rows"]:
        shape = S.SHAPES[shape_name]
        cfg = S.arch_for_shape(configs.get(arch), shape)
        axes = MESHES[kind]
        n = int(np.prod(list(axes.values())))
        assert DR.analytical_bytes_per_chip(cfg, shape, n, FakeMesh(axes)) \
            == jbytes, (arch, shape_name, kind)
        assert DR.model_flops(cfg, shape) == jflops, (arch, shape_name)
    assert HC.VARIANTS == jax_tables["variants"]
    assert steps.MOE_CF == jax_tables["moe_cf"] == JSTEPS.MOE_CF
    assert steps.TRAIN_MICROBATCHES == jax_tables["micro"]


# ---------------------------------------------------------------------------
# steps.build against JAX's rules, on the 16 x 16 production mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def fake256():
    DR.fake_group(256)
    yield make_production_mesh()
    dist.destroy_process_group()


def _spec_of(dt, names):
    """A ``DTensor``'s placements as a JAX spec, one entry per dim."""
    out = []
    for d in range(dt.ndim):
        axes = tuple(a for a, p in zip(names, dt.placements)
                     if p.is_shard() and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch,shape_name,knobs", [
    ("llama3-405b", "train_4k", {}), ("gemma-7b", "train_4k", {}),
    ("llama3-405b", "decode_32k", {"kv_quant": True}),
    ("granite-moe-3b-a800m", "prefill_32k", {}),
    ("gemma-7b-smoke", "train_4k", {}), ("xlstm-350m", "decode_32k", {}),
    ("gemma-7b", "long_500k", {})])
def test_build_follows_jax_rules(fake256, arch, shape_name, knobs):
    """The config the step runs and every argument's placements are what
    JAX's ``steps.build`` derives: the shape's variant, int8 KV, FSDP
    weights for training unless the model replicates (a smoke-size
    model); the cache and tokens placed by the policy; params and state
    donated in training, the cache in serving."""
    shape = S.SHAPES[shape_name]
    name, smoke = arch.removesuffix("-smoke"), arch.endswith("-smoke")
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    st = steps.build(cfg, shape, fake256, **knobs)
    jcfg = JS.arch_for_shape(jcfg, JS.SHAPES[shape_name])
    if knobs.get("kv_quant"):
        jcfg = jcfg.with_kv_quant()
    if shape.kind == "train" and not jcfg.replicate_small():
        jcfg = dataclasses.replace(jcfg, fsdp_weights=True)
    assert st.cfg.name == jcfg.name
    assert st.cfg.fsdp_weights == jcfg.fsdp_weights
    assert st.cfg.kv_quant == jcfg.kv_quant
    pol = JSH.ShardingPolicy(FakeMesh(MESHES["single"]), jcfg,
                             seq_shard=shape_name == "long_500k")
    names = axis_names(fake256)
    for name, leaf in named_leaves(st.args[0]):
        want = pol.param_spec(name, tuple(leaf.shape))
        assert _spec_of(leaf, names) == _pad(want, leaf.ndim), name
    if shape.kind == "train":
        assert st.donate == (0, 1)
        tok = st.args[2]["tokens"]
    else:
        assert st.donate == (2,)
        tok = st.args[1]
        for name, leaf in named_leaves(st.args[2]):
            want = pol.cache_spec(name, tuple(leaf.shape))
            assert _spec_of(leaf, names) == _pad(want, leaf.ndim), name
    assert _spec_of(tok, names) == _pad(
        pol.tokens_spec(shape.global_batch), tok.ndim)


def test_build_refuses_int8_training_and_builds_xlstm_sequences(fake256):
    """int8 weights in training raise ``ValueError``, as JAX's; the
    xLSTM's train and prefill steps build, their recurrences one scan
    operator per layer (``kernels/xlstm_scan.py``), as JAX's ``steps.build``
    builds them."""
    with pytest.raises(ValueError, match="serving-only"):
        steps.build(configs.get("gemma-7b"), S.SHAPES["train_4k"], fake256,
                    weight_quant=True)
    cfg = configs.get("xlstm-350m")
    for shape in ("train_4k", "prefill_32k"):
        st = steps.build(cfg, S.SHAPES[shape], fake256)
        assert st.cfg.n_layers == cfg.n_layers
        # one repeat of the (mLSTM x 3, sLSTM) pattern runs on meta shards
        fig = DR.measure(steps.build(steps.with_repeats(cfg, 1),
                                     S.SHAPES[shape], fake256))
        assert fig.flops > 0 and fig.resident_bytes > 0


# ---------------------------------------------------------------------------
# The fake group against real gloo ranks
# ---------------------------------------------------------------------------

DENSE = dict(name="dense", family="DENSE", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
# the train steps' microbatches (the production count, 8, needs a batch of
# 8 rows per data rank; the tests run 2)
MICROBATCHES = 2
CASES = {   # name: (config, shape (name, seq, batch, kind))
    "dense-train": ("dense", ("train_4k", 8, 4, "train")),
    "dense-prefill": ("dense", ("prefill_32k", 32, 4, "prefill")),
    "dense-decode": ("dense", ("decode_32k", 32, 4, "decode")),
    "moe-prefill": ("moe", ("prefill_32k", 32, 4, "prefill")),
    "moe-decode": ("moe", ("decode_32k", 32, 4, "decode")),
    # a narrow mLSTM + sLSTM stack: the scan operators and their backward
    "xlstm-train": ("xlstm", ("train_4k", 8, 4, "train")),
    "xlstm-prefill": ("xlstm", ("prefill_32k", 32, 4, "prefill")),
}

WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    rank, world, store_path, out_dir, src = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as M
    from repro_torch.launch import dryrun as DR, steps
    sys.path.insert(0, out_dir)
    from cases import CASES, MICROBATCHES, config, shape, values
    steps.TRAIN_MICROBATCHES = MICROBATCHES

    torch.set_num_threads(1)
    M.init_process_group("cpu", rank=rank, world_size=world,
                         store=dist.FileStore(store_path, world))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for name, (c, sh) in CASES.items():
        cfg, spec = config(c), shape(sh)
        vals = values(cfg, spec)
        st = steps.build(cfg, spec, mesh, torch.float32, replicate=False,
                         materialize=lambda n, leaf: vals[n].clone())
        outs, fn = [], st.fn
        st.fn = lambda *a: outs.append(fn(*a)) or outs[-1]
        fig = DR.measure(st)
        res[name] = {"fig": dataclasses.asdict(fig)}
        if spec.kind != "train":
            res[name]["logits"] = outs[0][0].full_tensor().tolist()
    json.dump(res, open(f"{out_dir}/rank{rank}.json", "w"))
    dist.barrier()
    dist.destroy_process_group()
""")

CASES_PY = textwrap.dedent("""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as T
    from repro_torch.models.config import BlockKind, Family, ModelConfig
    from repro_torch.training.tree import named_leaves

    CASES = {cases!r}
    DENSE = {dense!r}
    MICROBATCHES = {micro!r}

    def config(c):
        if c == "dense":
            kw = dict(DENSE, family=Family.DENSE)
            return ModelConfig(**kw)
        if c == "xlstm":
            return dataclasses.replace(
                configs.get("xlstm-350m"), n_layers=2, d_model=64, n_heads=2,
                n_kv_heads=2, head_dim=32, vocab_size=256,
                block_pattern=(BlockKind.MLSTM, BlockKind.SLSTM))
        return dataclasses.replace(configs.get("granite-moe-3b-a800m").smoke(),
                                   vocab_size=256)

    def shape(sh):
        return S.ShapeSpec(*sh)

    def values(cfg, spec):
        \"\"\"Every named input of the step, global, from seed 0: the
        parameters, the tokens and (serving) a cache the plain prefill of
        a prompt filled.\"\"\"
        g = torch.Generator().manual_seed(0)
        params = T.init(cfg, seed=0, dtype=torch.float32, device="cpu")
        out = dict(named_leaves(params))
        b, s = spec.global_batch, spec.seq_len
        if spec.kind == "train":
            out[""] = torch.randint(0, cfg.vocab_size, (b, s + 1),
                                    generator=g, dtype=torch.int32)
            return out
        cache = T.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
        if spec.kind == "decode":
            prompt = torch.randint(0, cfg.vocab_size, (b, s // 2),
                                   generator=g, dtype=torch.int32)
            T.prefill(cfg, params, prompt, cache)
            cache["lengths"].fill_(s // 2)
            out[""] = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                                    dtype=torch.int32)
        else:
            out[""] = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                    dtype=torch.int32)
        out.update(named_leaves(cache))
        return out
""")


def _cases_module(path):
    src = CASES_PY.format(cases=CASES, micro=MICROBATCHES,
                          dense={k: v for k, v in DENSE.items()
                                 if k != "family"})
    (path / "cases.py").write_text(src)
    sys.path.insert(0, str(path))
    import importlib
    import cases
    importlib.reload(cases)
    sys.path.pop(0)
    return cases


def _spawn(run, world=4, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    logs = [open(run / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world),
         str(run / "store"), str(run), SRC],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join((run / f"rank{r}.log").read_text()[-3000:]
                              for r in bad)
    return [json.loads((run / f"rank{r}.json").read_text())
            for r in range(world)]


def test_fake_group_figures_equal_real_gloo_ranks(tmp_path, monkeypatch):
    """Rank 0's figures from the dry run on ``meta`` shards over a 4-rank
    fake group equal those of 4 gloo ranks running the same step on
    values: flops, collective counts and bytes by kind, resident and
    argument bytes; the peak within 10 %.  The gloo ranks' logits equal
    the plain single-process forward's."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import transformer as T
    cases = _cases_module(tmp_path)
    real = _spawn(tmp_path)
    monkeypatch.setattr(steps, "TRAIN_MICROBATCHES", MICROBATCHES)
    DR.fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for name, (c, sh) in CASES.items():
            cfg, spec = cases.config(c), cases.shape(sh)
            fig = dataclasses.asdict(DR.measure(steps.build(
                cfg, spec, mesh, torch.float32, replicate=False)))
            want = real[0][name]["fig"]
            # the transient peak follows the group: a real collective's
            # buffers live until its work is waited on: within 10 %
            peak, want_peak = fig.pop("peak_bytes"), want.pop("peak_bytes")
            assert abs(peak - want_peak) <= 0.1 * want_peak, (name, peak,
                                                               want_peak)
            assert fig == want, name
            assert fig["flops"] > 0 and sum(fig["collective_counts"].values()) > 0
            if spec.kind == "train":
                continue
            vals = cases.values(cfg, spec)
            tree = _tree(T.init(cfg, seed=0, device="meta"), vals)
            cache = _tree(T.init_cache(cfg, spec.global_batch, spec.seq_len,
                                       device="meta"), vals)
            with torch.no_grad():
                want, _, _ = T.apply(cfg, tree, vals[""], cache=cache,
                                     mode=spec.kind, logits_slice="last",
                                     moe_cf=steps.MOE_CF)
            for r in range(4):
                np.testing.assert_allclose(
                    np.asarray(real[r][name]["logits"]), want.numpy(),
                    atol=1e-4, rtol=1e-4, err_msg=f"{name} rank {r}")
    finally:
        dist.destroy_process_group()


def _tree(shape_tree, vals):
    from repro_torch.training.tree import map_named
    return map_named(lambda n, _: vals[n].clone(), shape_tree)


# ---------------------------------------------------------------------------
# Depth: two and three repeats, extended, equal a full-depth run
# ---------------------------------------------------------------------------

@pytest.fixture
def fake4():
    from torch.distributed.device_mesh import init_device_mesh
    DR.fake_group(4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,kind", [
    ("dense", "train"), ("dense", "prefill"), ("dense", "decode"),
    ("recurrentgemma-9b", "prefill"), ("recurrentgemma-9b", "decode")])
def test_depth_extension_equals_full_depth(fake4, monkeypatch, arch, kind):
    """At 4 repeats of the pattern (a 3-block hybrid pattern too), the
    figures extended from 2 and 3 repeats equal a run at full depth."""
    if arch == "dense":
        cfg = ModelConfig(**dict(DENSE, family=Family.DENSE, n_layers=4))
    else:
        cfg = configs.get(arch).smoke()
        cfg = dataclasses.replace(cfg, n_layers=4 * len(cfg.block_pattern))
    assert steps.n_repeats(cfg) == 4
    monkeypatch.setattr(steps, "TRAIN_MICROBATCHES", MICROBATCHES)
    spec = S.ShapeSpec(f"{kind}_x", 8 if kind == "train" else 32,
                       4, kind)

    def build(c):
        return steps.build(c, spec, fake4, torch.float32, replicate=False)
    got, _ = DR.measure_depth(build, cfg)
    assert got == DR.measure(build(cfg))


# ---------------------------------------------------------------------------
# The kernels as custom operators
# ---------------------------------------------------------------------------

def _pages(rng, b, nb, bs, kv, d, n_pages=12):
    kp = torch.from_numpy(rng.normal(size=(n_pages, bs, kv, d))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(n_pages, bs, kv, d))
                          .astype(np.float32))
    pos = torch.arange(n_pages * bs, dtype=torch.int32).reshape(n_pages, bs)
    bt = torch.from_numpy(rng.permutation(n_pages)[:b * nb].reshape(b, nb)
                          .astype(np.int32))
    return kp, vp, pos, bt


def test_custom_ops_equal_plain_versions_and_count_flops():
    """Every kernel wrapper on the CPU equals its plain version bit for
    bit, on ``meta`` gives the CPU output's shapes, and ``FlopCounterMode``
    counts its formula."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    b, s, h, kv, d = 2, 24, 4, 2, 16
    q, k, v = t(b, s, h, d), t(b, s, kv, d), t(b, s, kv, d)
    kp, vp, pos, bt = _pages(rng, b, 3, 8, kv, d)
    pos_q = torch.tensor([[20, 21], [22, 23]], dtype=torch.int32)
    valid = torch.from_numpy(rng.random((b, s)) < 0.7)
    cases = [
        (lambda: FP.flash_prefill(q, k, v, window=7),
         lambda: ref.flash_prefill_plain(q, k, v, window=7),
         4 * b * h * d * causal_pairs(s, s, 0, 7)),
        (lambda: FP.flash_prefill(q, k, v, return_partials=True,
                                  seq_offset=0),
         lambda: ref.flash_prefill_plain(q, k, v, return_partials=True),
         4 * b * h * d * causal_pairs(s, s, 0, None)),
        (lambda: FP.paged_prefix_partials(q[:, :2], kp, vp, pos, bt, pos_q,
                                          pages_per_split=2),
         lambda: ref.paged_prefix_partials_plain(q[:, :2], kp, vp, pos, bt,
                                                 pos_q, pages_per_split=2),
         4 * b * 2 * h * d * 3 * 8),
        (lambda: SK.paged_decode_partials(q[:, 0], kp, vp, pos, bt,
                                          pos_q[:, 0]),
         lambda: ref.paged_decode_partials_plain(q[:, 0], kp, vp, pos, bt,
                                                 pos_q[:, 0]),
         4 * b * h * d * 3 * 8),
        (lambda: SK.paged_verify_partials(q[:, :2], kp, vp, pos, bt, pos_q,
                                          pages_per_split=3),
         lambda: ref.paged_verify_partials_plain(q[:, :2], kp, vp, pos, bt,
                                                 pos_q, pages_per_split=3),
         4 * b * 2 * h * d * 3 * 8),
        (lambda: SK.split_kv_decode_partials(q[:, 0], k, v, valid,
                                             block_k=8),
         lambda: ref.split_kv_decode_partials_plain(q[:, 0], k, v, valid,
                                                    block_k=8),
         4 * b * h * d * s),
    ]
    for i, (kernel, plain, flops) in enumerate(cases):
        with FlopCounterMode(display=False) as fc:
            got = kernel()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), i
        for a, w in zip(got, want):
            assert torch.equal(a, w), i
        assert fc.get_total_flops() == flops, i
    # meta: shapes only, no kernel reached
    meta = [x.to("meta") for x in (q, k, v, kp, vp, pos, bt, pos_q, valid)]
    qm, km, vm, kpm, vpm, posm, btm, pqm, validm = meta
    for got, want in [
            (FP.flash_prefill(qm, km, vm), (q,)),
            (SK.paged_decode_partials(qm[:, 0], kpm, vpm, posm, btm,
                                      pqm[:, 0], pages_per_split=2),
             SK.paged_decode_partials(q[:, 0], kp, vp, pos, bt, pos_q[:, 0],
                                      pages_per_split=2)),
            (SK.split_kv_decode_partials(qm[:, 0], km, vm, validm,
                                         block_k=5),
             SK.split_kv_decode_partials(q[:, 0], k, v, valid, block_k=5))]:
        got = got if isinstance(got, tuple) else (got,)
        assert [(x.shape, x.dtype) for x in got] == \
            [(x.shape, x.dtype) for x in want]
        assert all(x.is_meta for x in got)


def test_causal_pairs_counts_the_mask():
    """The B2 formula's pair count equals the mask's, with offsets,
    windows and keys past the queries."""
    for s, length, off, win in [(7, 7, 0, None), (5, 12, 7, None),
                                (9, 9, 0, 3), (4, 10, 6, 5), (3, 2, 0, 1)]:
        qpos = np.arange(off, off + s)[:, None]
        kpos = np.arange(length)[None, :]
        mask = kpos <= qpos
        if win is not None:
            mask &= kpos > qpos - win
        assert causal_pairs(s, length, off, win) == int(mask.sum())


def test_cost_mode_counts_collectives_and_storages(fake4):
    """``CostMode`` sizes a collective by its output and tracks storages
    until their last view dies."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = DTensor.from_local(torch.empty(4, 8, device="meta"), fake4,
                           [Shard(0), Shard(1)], run_check=False)
    mode = C.CostMode()
    with mode:
        y = x.redistribute(fake4, [Shard(0), Replicate()])
        z = torch.empty(100, device="meta")
        v = z[10:]
        del z
        assert mode.live >= 400
        del v
    assert mode.collective_counts["all-gather"] == 1
    assert mode.collective_bytes["all-gather"] == 4 * 16 * 4
    assert tuple(y.to_local().shape) == (4, 16)
    assert mode.peak >= 4 * 16 * 4 + 400


# ---------------------------------------------------------------------------
# The command lines
# ---------------------------------------------------------------------------

def test_dryrun_cli_one_combo(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "done; failures: 0"
    rec = json.loads((tmp_path / "xlstm-350m__decode_32k__single.json")
                     .read_text())
    assert rec["ok"] and rec["n_chips"] == 256
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert rec["fits_hbm"] and rec["flops"] > 0
    assert rec["resident_bytes_per_chip"] <= rec["peak_bytes_per_chip"]


def test_hillclimb_variants(fake256, tmp_path):
    """``hillclimb`` on gemma-7b decode_32k: int8 KV against the baseline
    (the cache's resident bytes and the traffic model's KV reads drop),
    and its command line on the pipeline over "data" (sends between the
    stages)."""
    base, q8 = (HC.run_variant("gemma-7b", "decode_32k", v,
                               out_dir=str(tmp_path))
                for v in ("baseline", "kv_int8"))
    assert base["ok"] and q8["ok"], (base.get("error"), q8.get("error"))
    assert q8["resident_bytes_per_chip"] < base["resident_bytes_per_chip"]
    assert q8["roofline"]["hlo_bytes"] < base["roofline"]["hlo_bytes"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--arch",
         "gemma-7b", "--shape", "decode_32k", "--variant", "pipeline",
         "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads(
        (tmp_path / "gemma-7b__decode_32k__pipeline.json").read_text())
    assert rec["ok"] and rec["collective_detail"]["collective-permute"] > 0
