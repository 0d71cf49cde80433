"""The port's dry run held to the JAX package's: per-chip figures, the
training step's ``act_spec`` and the residual stream's placements.

* Figures: ``repro_torch.launch.dryrun.run_one`` against JAX's
  ``repro.launch.dryrun.run_one`` (in a subprocess: it sets ``XLA_FLAGS``
  at import) on the 16 x 16 mesh, for prefill_32k and decode_32k of
  gemma-7b and granite-8b.  Per-chip flops within 0.6-1.25x of JAX's
  (below 1x the account is the attention: B2's formula counts the pairs
  its causal mask admits, JAX's blocked attention every pair), resident
  bytes within 1 %, a bottleneck reported by both.
* ``act_spec``: the loss and gradients of smoke-size gemma-7b (dense),
  granite-moe-3b-a800m (MoE) and recurrentgemma-9b (RG-LRU and local
  attention of 4 heads over 1 kv head) in f32 on 4 gloo ranks (a 2 x 2
  data x model mesh, the weights split by the policy) with ``act_spec``
  equal those without it and JAX's ``lm_loss`` gradients with
  ``act_spec`` on a 2 x 2 mesh of ``Auto`` axes (JAX's production mesh
  has ``Explicit`` axes, on which its ``act_spec`` fails on jax 0.9.0:
  ROADMAP R8), within 1e-5.
* Placements: in a one-layer prefill step on 256 fake ranks, each
  column-parallel product (q, k, v, the MLP's gate and up) multiplies by
  its own column split, never the weight's whole width.

Time: ~90 s on one worker (the JAX dry runs ~15 s, the JAX gradients
and the gloo spawn ~60 s, the port's dry runs ~10 s).
"""
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

from repro_torch import configs
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as S
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

COMBOS = [(a, s) for a in ("gemma-7b", "granite-8b")
          for s in ("prefill_32k", "decode_32k")]

JAX_DRYRUN = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun
    combos, out = json.loads(sys.argv[1]), sys.argv[2]
    recs = [dryrun.run_one(a, s, "single", out, verbose=False)
            for a, s in combos]
    print(json.dumps([{k: r.get(k) for k in
                       ("arch", "shape", "ok", "error", "flops",
                        "resident_bytes_per_chip", "roofline")}
                      for r in recs]))
""")


@pytest.fixture(scope="module")
def jax_figures(tmp_path_factory):
    out = subprocess.run(
        [sys.executable, "-c", JAX_DRYRUN, json.dumps(COMBOS),
         str(tmp_path_factory.mktemp("jax_dryrun"))],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    recs = json.loads(out.stdout.strip().splitlines()[-1])
    return {(r["arch"], r["shape"]): r for r in recs}


@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_figures_match_jax_dryrun(jax_figures, tmp_path, arch, shape_name):
    """Per-chip flops within 0.6-1.25x of JAX's, resident bytes within
    1 %, a bottleneck from each."""
    want = jax_figures[(arch, shape_name)]
    assert want["ok"], want["error"]
    try:
        got = DR.run_one(arch, shape_name, "single", str(tmp_path),
                         verbose=False)
    finally:
        dist.destroy_process_group()
    assert got["ok"], got.get("error")
    ratio = got["flops"] / want["flops"]
    assert 0.6 <= ratio <= 1.25, (arch, shape_name, got["flops"],
                                  want["flops"])
    assert abs(got["resident_bytes_per_chip"]
               - want["resident_bytes_per_chip"]) \
        <= 0.01 * want["resident_bytes_per_chip"]
    for rec in (got, want):
        assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                                 "collective")


# ---------------------------------------------------------------------------
# act_spec on values: 4 gloo ranks against themselves and JAX
# ---------------------------------------------------------------------------

SMOKES = ("gemma-7b", "granite-moe-3b-a800m", "recurrentgemma-9b")
BATCH, SEQ = 4, 8          # tokens (BATCH, SEQ + 1)

JAX_GRADS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro import configs
    from repro.models import transformer as T
    from repro.training.train_step import lm_loss

    archs, batch, seq, out = sys.argv[1].split(","), int(sys.argv[2]), \\
        int(sys.argv[3]), sys.argv[4]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def named(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(v) for path, v in flat}
    for arch in archs:
        cfg = configs.get(arch).smoke()
        params = T.init(cfg, jax.random.PRNGKey(0), jnp.float32)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)

        def grads(p, t):
            return jax.value_and_grad(lambda q: lm_loss(
                cfg, q, t, remat=True,
                act_spec=P(("data",), None, "model")), has_aux=True)(p)
        with jax.set_mesh(mesh):
            (loss, _), g = jax.jit(grads)(params, jnp.asarray(tokens))
        res = {"tokens": tokens, "loss": np.asarray(loss)}
        res.update({"p/" + k: v for k, v in named(params).items()})
        res.update({"g/" + k: v for k, v in named(g).items()})
        np.savez(f"{out}/jax-{arch}.npz", **res)
    print("JAX_OK")
""")

WORKER = textwrap.dedent("""
    import sys
    rank, world, store_path, out_dir, src, archs = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.launch import cost_analysis as C
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as S
    from repro_torch.launch import steps
    from repro_torch.launch.sharding import ShardingPolicy, placements
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.training.tree import named_leaves

    torch.set_num_threads(1)
    M.init_process_group("cpu", rank=rank, world_size=world,
                         store=dist.FileStore(store_path, world))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    act = placements((("data",), None, "model"), mesh)
    for arch in archs.split(","):
        vals = dict(np.load(f"{out_dir}/jax-{arch}.npz"))
        cfg = configs.get(arch).smoke()
        pol = ShardingPolicy(mesh, cfg, replicate=False)
        params = steps.distribute(
            S.param_shapes(cfg, torch.float32),
            lambda n, a: pol.param_spec(n, tuple(a.shape)), mesh,
            lambda n, a: torch.from_numpy(vals["p/" + n]))
        tok = torch.from_numpy(vals["tokens"])
        tokens = steps.distribute(
            torch.empty(tok.shape, dtype=torch.int32, device="meta"),
            lambda n, a: pol.tokens_spec(tok.shape[0]), mesh,
            lambda n, a: tok)
        res = {}
        for key, spec in (("plain", None), ("act", act)):
            with implicit_replication(), C.EvenViews():
                loss, _, g = loss_and_grads(cfg, params, {"tokens": tokens},
                                            remat=True, act_spec=spec)
            res[key + "/loss"] = loss.full_tensor().numpy()
            for n, a in named_leaves(g):
                res[key + "/g/" + n] = a.full_tensor().numpy()
        if rank == 0:
            np.savez(f"{out_dir}/port-{arch}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
""")


def _spawn_port(run: Path, world=4, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    logs = [open(run / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world),
         str(run / "store"), str(run), SRC, ",".join(SMOKES)],
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


@pytest.fixture(scope="module")
def act_runs(tmp_path_factory):
    """JAX's loss and gradients of each smoke config (one subprocess),
    then the port's on 4 gloo ranks (one spawn): arch -> (port, JAX)."""
    run = tmp_path_factory.mktemp("act_spec")
    out = subprocess.run(
        [sys.executable, "-c", JAX_GRADS, ",".join(SMOKES), str(BATCH),
         str(SEQ), str(run)],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "JAX_OK" in out.stdout, \
        out.stdout[-3000:] + out.stderr[-3000:]
    _spawn_port(run)
    return {a: (dict(np.load(run / f"port-{a}.npz")),
                dict(np.load(run / f"jax-{a}.npz"))) for a in SMOKES}


@pytest.mark.parametrize("arch", SMOKES)
def test_act_spec_values_equal_plain_and_jax(act_runs, arch):
    """With ``act_spec`` the port's loss and gradients over 4 gloo ranks
    equal those without it and JAX's with it (2 x 2, ``Auto`` axes), in
    f32 within 1e-5: a dense stack, a MoE one and the hybrid."""
    got, want = act_runs[arch]
    names = sorted(k[2:] for k in want if k.startswith("g/"))
    assert names and all(f"act/g/{n}" in got for n in names)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["act/loss"], got["plain/loss"], **tol)
    np.testing.assert_allclose(got["act/loss"], want["loss"], **tol)
    for n in names:
        np.testing.assert_allclose(got[f"act/g/{n}"], got[f"plain/g/{n}"],
                                   err_msg=n, **tol)
        np.testing.assert_allclose(got[f"act/g/{n}"], want[f"g/{n}"],
                                   err_msg=n, **tol)


# ---------------------------------------------------------------------------
# The residual stream's placements: column-parallel products stay split
# ---------------------------------------------------------------------------

class _Products(C.CostMode):
    """``CostMode`` that also records each ``aten.mm`` a rank runs as
    (rows, inner, cols) of its local operands."""

    def __init__(self):
        super().__init__()
        self.mm = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and \
                func._overloadpacket is torch.ops.aten.mm and \
                not C._fake_active() and \
                not any(t.__name__ == "FakeTensor" for t in types):
            self.mm.append((args[0].shape[0], args[0].shape[1],
                            args[1].shape[1]))
        return out


def test_column_parallel_products_keep_their_split(monkeypatch):
    """In one layer of gemma-7b's prefill_32k on 256 fake ranks, q, k, v
    and the MLP's gate and up multiply each rank's whole activation rows
    by the weight's column split (a 16th of its width): no local product
    has a split weight's full width."""
    cfg = configs.get("gemma-7b")
    shape = S.SHAPES["prefill_32k"]
    DR.fake_group(256)
    try:
        mesh = make_production_mesh()
        step = steps.build(steps.with_repeats(cfg, 1), shape, mesh,
                           replicate=cfg.replicate_small())
        mode = _Products()
        monkeypatch.setattr(C, "CostMode", lambda: mode)
        DR.measure(step)
    finally:
        dist.destroy_process_group()
    d, hd = cfg.d_model, cfg.head_dim
    rows = shape.global_batch // 16 * shape.seq_len
    cols = sorted(n for m, k, n in mode.mm if m == rows and k == d)
    # q, k, v (H * hd / 16 each: gemma-7b has as many kv heads as heads),
    # gate and up (d_ff / 16)
    assert cols == sorted([cfg.n_heads * hd // 16] * 3
                          + [cfg.d_ff // 16] * 2), mode.mm
    full = {cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff, 2 * cfg.d_ff}
    assert not any(n in full for _, _, n in mode.mm), mode.mm
