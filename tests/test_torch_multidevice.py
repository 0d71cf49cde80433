"""The port's multi-device runtime against the JAX package's, over gloo
ranks on the CPU: local shards of the sharding policy, context-parallel
``sharded_decode_attention``, per-shard MoE dispatch
(``moe_apply(impl="local_sorted")``) and pipeline decode.

The port's ranks are processes that import only torch and the port
(``WORKER``), started together and joined by a ``FileStore`` under the
test's ``tmp_path`` (so parallel test workers never share a port); one
spawn of 4 ranks carries the shard, attention and MoE checks, one of 8
ranks (a 4 x 2 data x model mesh) the pipeline.  JAX's oracles on several
devices run in a subprocess with 4 host devices (``XLA_FLAGS``, as
``tests/test_pipeline_decode.py`` does).  Pipeline decode is held to
JAX's monolithic ``T.prefill`` then ``T.decode_step`` in this process:
JAX's own pipeline fails on jax 0.9.0 (ROADMAP R2), and so does its
``local_sorted`` on a data x model mesh (R6), so the MoE is held to JAX's
on data-only meshes.  Inputs come from numpy seeds, weights from JAX's
``T.init`` (through ``params_from_jax``).

Tolerances: local shards exactly; attention 1e-5 in f32 and 2e-2 in bf16
(one bf16 step of the output); MoE ``y`` 1e-4 of max|y| and
``router_load`` 1e-6; pipeline logits and K/V 1e-4 (f32 sums in another
order); the model axis's replicas bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import quant as JQ
from repro.models import transformer as JT
from repro.models.config import Family as JFamily
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax, tree_from_numpy

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

# a narrow stack with a wide FFN, so that it is not replicated whole
# (param_count * 2 bytes > 1.5 GB) and shards over a 2 x 2 mesh; only the
# sharded leaves are ever made
WIDE = dict(name="wide", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=4_000_000, vocab_size=128, fsdp_weights=True)
SHARD_LEAVES = {   # name: (kind, tree path, shape, seq_shard)
    "embed": ("param", "embed", (128, 64), False),
    "wq": ("param", "groups/0/attn/wq", (2, 64, 4, 16), False),
    "k": ("cache", "groups/0/k", (2, 4, 8, 2, 16), False),
    "k_seq": ("cache", "groups/0/k", (2, 1, 8, 2, 16), True),
}
ATTN_RANKS = (1, 2, 4)
MOE = dict(n_experts=8, top_k=3, d_model=32, d_ff=16)
MOE_CFS = (None, 1.25)
PIPE = dict(name="p", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=128)
PIPE_BATCH, PIPE_PROMPT, PIPE_CACHE = 8, 12, 32

ORACLE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.core import attention_offload as AO
    from repro.launch.sharding import ShardingPolicy
    from repro.models import layers as JL
    from repro.models.config import Family, ModelConfig

    inp, out_path, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    data = dict(np.load(inp))
    devs = np.array(jax.devices())
    assert len(devs) == 4, devs
    out = {}
    # (a) the shard each device of a 2 x 2 mesh holds
    mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
    wide = ModelConfig(family=Family.DENSE, **spec["wide"])
    for name, (kind, path, shape, seq) in spec["leaves"].items():
        pol = ShardingPolicy(mesh, wide, seq_shard=seq)
        fn = pol.param_spec if kind == "param" else pol.cache_spec
        arr = jax.device_put(data["leaf/" + name],
                             NamedSharding(mesh, fn(path, tuple(shape))))
        flat = list(mesh.devices.flat)
        for sh in arr.addressable_shards:
            out[f"shard/{name}/{flat.index(sh.device)}"] = np.asarray(sh.data)
    # (b) sharded decode attention over 1, 2 and 4 devices
    for n in spec["attn_ranks"]:
        m = Mesh(devs[:n], ("data",))
        for dt in ("float32", "bfloat16"):
            q, k, v = (jnp.asarray(data["attn/" + x]).astype(dt)
                       for x in "qkv")
            o = jax.jit(lambda *a: AO.sharded_decode_attention(m, *a))(
                q, k, v, jnp.asarray(data["attn/valid"]))
            out[f"attn/{dt}/{n}"] = np.asarray(o.astype(jnp.float32))
    # (c) local_sorted MoE on data-only meshes
    cfg = dataclasses.replace(configs.get("grok-1-314b"),
                              name="grok-1-314b-moe", **spec["moe"])
    p = {k[4:]: jnp.asarray(v) for k, v in data.items()
         if k.startswith("moe/") and k != "moe/x"}
    x = jnp.asarray(data["moe/x"])
    for n, cfs in ((4, spec["moe_cfs"]), (2, [1.25])):
        m = Mesh(devs[:n], ("data",))
        for cf in cfs:
            y, load = jax.jit(lambda p, x: JL.moe_apply(
                cfg, p, x, impl="local_sorted", capacity_factor=cf,
                mesh=m))(p, x)
            out[f"moe/{n}/{cf}/y"] = np.asarray(y)
            out[f"moe/{n}/{cf}/load"] = np.asarray(load)
    np.savez(out_path, **out)
    print("ORACLE_OK")
""")

WORKER = textwrap.dedent("""
    import sys
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_path, inp, out_dir, task = sys.argv[3:7]
    sys.path.insert(0, sys.argv[7])
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.core import attention_offload as AO
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import pipeline_decode as PD
    from repro_torch.models import layers as L

    torch.set_num_threads(1)
    M.init_process_group("cpu", rank=rank, world_size=world,
                         store=dist.FileStore(store_path, world))
    data = torch.load(inp, weights_only=False)
    res = {}
    if task == "four":
        # (a) this rank's local shards on a 2 x 2 mesh, by local_shard and
        # by DTensor's placements
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for name, (kind, path, x, seq) in data["leaves"].items():
            pol = SH.ShardingPolicy(mesh, data["wide"], seq_shard=seq)
            fn = pol.param_spec if kind == "param" else pol.cache_spec
            spec = fn(path, tuple(x.shape))
            res["shard/" + name] = SH.local_shard(x, spec, mesh).clone()
            res["dtensor/" + name] = distribute_tensor(
                x, mesh, SH.placements(spec, mesh)).to_local()
        # (b) sharded decode attention with 1, 2 and 4 ranks along "data"
        q, k, v, valid = (data["attn"][x] for x in ("q", "k", "v", "valid"))
        for n in data["attn_ranks"]:
            mesh = init_device_mesh("cpu", (n, world // n),
                                    mesh_dim_names=("data", "model"))
            j = mesh.get_local_rank("data")
            cut = slice(j * k.shape[1] // n, (j + 1) * k.shape[1] // n)
            for dt in (torch.float32, torch.bfloat16):
                o = AO.sharded_decode_attention(
                    mesh, q.to(dt), k[:, cut].to(dt), v[:, cut].to(dt),
                    valid[:, cut])
                assert o.dtype == dt, o.dtype
                res[f"attn/{str(dt)[6:]}/{n}"] = o.float()
        # (c) local_sorted MoE: each rank its batch shard; a data-only mesh
        # of 4, then 2 x 2 (data x model)
        cfg, p, x = data["moe_cfg"], data["moe_p"], data["moe_x"]
        for shape, names, cfs in (((4,), ("data",), data["moe_cfs"]),
                                  ((2, 2), ("data", "model"), [1.25])):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            n, j = shape[0], mesh.get_local_rank("data")
            rows = slice(j * x.shape[0] // n, (j + 1) * x.shape[0] // n)
            for cf in cfs:
                y, load = L.moe_apply(cfg, p, x[rows], impl="local_sorted",
                                      capacity_factor=cf, mesh=mesh)
                res[f"moe/{n}/{cf}/y"] = y
                res[f"moe/{n}/{cf}/load"] = load
    else:
        # pipeline decode on a 4 x 2 (data x model) mesh
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        cfg = data["cfg"]
        fn, per_stage, n_pad = PD.build_pipeline_decode(cfg, mesh,
                                                        batch=data["batch"])
        res["layout"] = (per_stage, n_pad, mesh.get_local_rank("data"))
        for tag, params in data["params"].items():
            cache = PD.pad_stacked_cache(
                {"lengths": data["cache"]["lengths"].clone(),
                 "groups": tuple({k: a.clone() for k, a in g.items()}
                                 for g in data["cache"]["groups"]),
                 "rem": ()}, n_pad)
            logits, new = fn(PD.pad_stacked_params(cfg, params, n_pad),
                             data["next"], cache)
            res[tag] = {"logits": logits, "lengths": new["lengths"],
                        "k": new["groups"][0]["k"].clone(),
                        "v": new["groups"][0]["v"].clone()}
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
""")


def spawn(tmp_path, task, world, data, timeout=240):
    """Run ``WORKER`` on ``world`` gloo ranks; returns each rank's
    results."""
    run = tmp_path / task
    run.mkdir()
    inp = run / "inputs.pt"
    torch.save(data, inp)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    logs = [open(run / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world),
         str(run / "store"), str(inp), str(run), task, SRC],
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
    return [torch.load(run / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Inputs, the JAX oracles, the 4-rank spawn
# ---------------------------------------------------------------------------

def _moe_cfgs():
    return tuple(dataclasses.replace(reg.get("grok-1-314b"),
                                     name="grok-1-314b-moe", **MOE)
                 for reg in (jconfigs, configs))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    leaves = {name: rng.normal(size=shape).astype(np.float32)
              for name, (_, _, shape, _) in SHARD_LEAVES.items()}
    b, length, h, d = 2, 64, 4, 16
    attn = {"q": rng.normal(size=(b, h, d)).astype(np.float32),
            "k": rng.normal(size=(b, length, h, d)).astype(np.float32),
            "v": rng.normal(size=(b, length, h, d)).astype(np.float32)}
    valid = np.arange(length)[None, :] < np.array([40, 20])[:, None]
    valid[:, 48:] = False          # the last of 4 shards: fully masked
    attn["valid"] = valid
    e, dm, f = MOE["n_experts"], MOE["d_model"], MOE["d_ff"]
    moe = {"router": rng.normal(size=(dm, e)).astype(np.float32),
           "w_gate": rng.normal(size=(e, dm, f)).astype(np.float32) * 0.2,
           "w_up": rng.normal(size=(e, dm, f)).astype(np.float32) * 0.2,
           "w_down": rng.normal(size=(e, f, dm)).astype(np.float32) * 0.2}
    x = rng.normal(size=(8, 5, dm)).astype(np.float32)
    moe["router"][:, 0] += 2.0 * np.sign(x.reshape(-1, dm).mean(0))
    return leaves, attn, moe, x


@pytest.fixture(scope="module")
def oracle(inputs, tmp_path_factory):
    """JAX's shards, attention and MoE on 4 host devices."""
    leaves, attn, moe, x = inputs
    tmp = tmp_path_factory.mktemp("oracle")
    arrays = {"leaf/" + k: a for k, a in leaves.items()}
    arrays.update({"attn/" + k: a for k, a in attn.items()})
    arrays.update({"moe/" + k: a for k, a in moe.items()})
    arrays["moe/x"] = x
    np.savez(tmp / "in.npz", **arrays)
    spec = {"wide": WIDE, "moe": MOE, "moe_cfs": list(MOE_CFS),
            "attn_ranks": list(ATTN_RANKS),
            "leaves": {k: list(v) for k, v in SHARD_LEAVES.items()}}
    out = subprocess.run(
        [sys.executable, "-c", ORACLE, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(spec)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "ORACLE_OK" in out.stdout
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def four(inputs, tmp_path_factory):
    """The port on 4 gloo ranks."""
    leaves, attn, moe, x = inputs
    data = {"wide": ModelConfig(family=Family.DENSE, **WIDE),
            "leaves": {name: (kind, path, torch.from_numpy(leaves[name]), seq)
                       for name, (kind, path, _, seq)
                       in SHARD_LEAVES.items()},
            "attn": {k: torch.from_numpy(a) for k, a in attn.items()},
            "attn_ranks": ATTN_RANKS,
            "moe_cfg": _moe_cfgs()[1],
            "moe_p": {k: torch.from_numpy(a) for k, a in moe.items()},
            "moe_x": torch.from_numpy(x), "moe_cfs": MOE_CFS}
    return spawn(tmp_path_factory.mktemp("four"), "four", 4, data)


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SHARD_LEAVES))
def test_local_shards_equal_jax_addressable_shards(oracle, four, name):
    """Each rank's ``local_shard`` of ``embed`` (model x data), a stacked
    ``wq`` (fsdp over data, heads over model), a cache ``k`` (batch over
    data, sequence over model) and a context-parallel ``k`` (sequence over
    (data, model)) equals the shard JAX places on the same device index
    of a 2 x 2 mesh; DTensor's placements cut the same shard."""
    for r, res in enumerate(four):
        want = oracle[f"shard/{name}/{r}"]
        got = res["shard/" + name]
        assert tuple(got.shape) == want.shape, (r, got.shape, want.shape)
        assert np.array_equal(got.numpy(), want), r
        assert torch.equal(res["dtensor/" + name], got), r
    shapes = {tuple(res["shard/" + name].shape) for res in four}
    full = SHARD_LEAVES[name][2]
    assert shapes != {full}, "nothing was sharded"


# ---------------------------------------------------------------------------
# Context-parallel decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n", ATTN_RANKS)
def test_sharded_decode_attention_matches_jax(oracle, four, inputs, n,
                                              dtype, tol):
    """With the sequence over 1, 2 and 4 ranks (the last of 4 shards
    fully masked, row 1 masked from key 20 on) every rank returns JAX's
    output on 4 host devices, and the reference softmax."""
    want = oracle[f"attn/{dtype}/{4}"]
    outs = [res[f"attn/{dtype}/{n}"] for res in four]
    for o in outs:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(outs[0].numpy(), oracle[f"attn/{dtype}/{n}"],
                               atol=tol, rtol=tol)
    if dtype == "float32":
        from repro_torch.core.attention_offload import reference_attention
        _, attn, _, _ = inputs
        ref = reference_attention(*(torch.from_numpy(attn[x])
                                    for x in ("q", "k", "v", "valid")))
        np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), atol=tol,
                                   rtol=tol)


# ---------------------------------------------------------------------------
# Per-shard MoE dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cf", [(4, None), (4, 1.25), (2, 1.25)])
def test_local_sorted_matches_jax(oracle, four, inputs, n, cf):
    """Each rank's ``y`` rows equal JAX's ``local_sorted`` on a data-only
    mesh of n devices (the port's n = 2 runs on a 2 x 2 data x model mesh,
    where JAX's fails: R6), and every rank's ``router_load`` is the
    shards' mean, JAX's; with a capacity factor each shard drops at its
    own capacity, so the result differs from the global sorted
    dispatch."""
    want_y, want_load = oracle[f"moe/{n}/{cf}/y"], oracle[f"moe/{n}/{cf}/load"]
    rows = want_y.shape[0] // n
    scale = float(np.abs(want_y).max())
    for r, res in enumerate(four):
        j = r if n == 4 else r // 2
        got = res[f"moe/{n}/{cf}/y"].numpy()
        np.testing.assert_allclose(got, want_y[j * rows:(j + 1) * rows],
                                   atol=1e-4 * scale, rtol=0)
        np.testing.assert_allclose(res[f"moe/{n}/{cf}/load"].numpy(),
                                   want_load, atol=1e-6, rtol=0)
    if cf is not None:
        from repro_torch.models import layers as L
        moe, x = inputs[2], inputs[3]
        pc = _moe_cfgs()[1]
        glob, _ = L.moe_apply(pc, {k: torch.from_numpy(a)
                                   for k, a in moe.items()},
                              torch.from_numpy(x), impl="sorted",
                              capacity_factor=cf)
        assert not np.allclose(glob.numpy(), want_y, atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# Pipeline decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """JAX's monolithic prefill + decode step (f32, and on JAX's int8
    tree), and the port's pipeline decode on 8 gloo ranks."""
    jc = JModelConfig(family=JFamily.DENSE, **PIPE)
    pc = ModelConfig(family=Family.DENSE, **PIPE)
    params = JT.init(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = jnp.asarray(rng.integers(0, PIPE["vocab_size"],
                                    (PIPE_BATCH, PIPE_PROMPT)), jnp.int32)
    cache = JT.init_cache(jc, PIPE_BATCH, PIPE_CACHE)
    lg, cache, _ = JT.prefill(jc, params, toks, cache)
    nxt = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    trees = {"f32": params, "int8": JQ.quantize_weights(params)}
    want = {}
    for tag, tree in trees.items():
        ref, ref_cache, _ = JT.decode_step(jc, tree, nxt, cache)
        want[tag] = {"logits": np.asarray(ref, np.float32),
                     "k": np.asarray(ref_cache["groups"][0]["k"]),
                     "v": np.asarray(ref_cache["groups"][0]["v"])}
    np_cache = jax.tree.map(np.asarray, cache)
    data = {"cfg": pc, "batch": PIPE_BATCH,
            "next": torch.from_numpy(np.array(nxt)),
            "cache": tree_from_numpy(np_cache, device="cpu"),
            "params": {tag: params_from_jax(pc, jax.tree.map(np.asarray, t),
                                            device="cpu")
                       for tag, t in trees.items()}}
    got = spawn(tmp_path_factory.mktemp("pipe"), "pipe", 8, data)
    return want, got, np_cache


@pytest.mark.parametrize("tag", ["f32", "int8"])
def test_pipeline_decode_matches_monolithic(pipeline, tag):
    """On a 4 x 2 mesh: (per_stage, n_pad) == (2, 2); every rank's logits
    equal JAX's monolithic ``T.decode_step`` (on JAX's int8 tree for
    "int8"); each stage's K/V slice equals the step's cache for its real
    layers and its padded layers write zeros; the two model-axis replicas
    of a stage agree bit for bit; lengths advance by one."""
    want, got, np_cache = pipeline
    n_layers = PIPE["n_layers"]
    for r, res in enumerate(got):
        per_stage, n_pad, stage = res["layout"]
        assert (per_stage, n_pad) == (2, 2) and stage == r // 2
        out = res[tag]
        np.testing.assert_allclose(out["logits"].numpy(), want[tag]["logits"],
                                   atol=1e-4, rtol=1e-4)
        assert torch.equal(out["lengths"], torch.from_numpy(
            np_cache["lengths"] + 1))
        lo = stage * per_stage
        for key in ("k", "v"):
            mine = out[key].numpy()
            real = max(min(n_layers - lo, per_stage), 0)
            np.testing.assert_allclose(mine[:real],
                                       want[tag][key][lo:lo + real],
                                       atol=1e-4, rtol=1e-4)
            assert not mine[real:].any()
            assert torch.equal(out[key], got[r ^ 1][tag][key])
        assert torch.equal(out["logits"], got[r ^ 1][tag]["logits"])
