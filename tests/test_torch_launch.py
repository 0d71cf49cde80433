"""The port's launch layer against the JAX package's: input shapes on the
``meta`` device, the sharding policy's specs, the production and host
meshes, ``DTensor`` placements and local shards (one process; the
multi-rank runs are ``test_torch_multidevice.py``).

The JAX side runs the unchanged ``launch/specs.py`` and
``launch/sharding.py``: ``jax.eval_shape`` trees and ``PartitionSpec``s
over a mesh stand-in (``FakeMesh``, as ``tests/test_launch.py`` uses),
which the policy reads by axis names and sizes only.  Tolerances: none;
shapes, dtypes and specs compare exactly (a ``PartitionSpec`` as a
tuple).
"""
import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.launch import specs as JS
from repro.models import quant as JQ
from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as S
from repro_torch.models import quant as Q
from repro_torch.training.tree import named_leaves


class FakeMesh:
    """Minimal mesh stand-in: axis name -> size (the policies read only
    ``shape`` and ``axis_names``)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _jax_leaves(tree):
    return sorted((JSH._path_str(p), leaf) for p, leaf in
                  jax.tree_util.tree_leaves_with_path(tree))


def _port_leaves(tree):
    return sorted(named_leaves(tree), key=lambda x: x[0])


def _same_leaves(jl, pl, what):
    """Leaf names, shapes and dtypes equal; the port's on ``meta``."""
    assert [n for n, _ in pl] == [n for n, _ in jl], what
    for (name, a), (_, b) in zip(jl, pl):
        assert b.is_meta, (what, name)
        assert tuple(b.shape) == tuple(a.shape), (what, name)
        assert str(b.dtype) == f"torch.{a.dtype}", (what, name)


# ---------------------------------------------------------------------------
# Shapes and specs, every registry config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.names())
def test_shapes_and_specs_match_jax(arch):
    """``param_shapes`` (and its int8-quantized tree), ``cache_shapes``
    and ``input_specs`` equal JAX's ``eval_shape`` trees leaf for leaf;
    then every parameter, quantized-parameter and cache leaf's spec equals
    JAX's ``PartitionSpec`` for every ``SHAPES`` entry (through
    ``arch_for_shape``, ``seq_shard`` on long_500k as JAX's
    ``steps.build`` sets it), on both meshes, with and without
    ``fsdp_weights``; ``tokens_spec`` and ``frames_spec`` too."""
    jp = _jax_leaves(JS.param_shapes(jconfigs.get(arch)))
    pp = _port_leaves(S.param_shapes(configs.get(arch)))
    _same_leaves(jp, pp, "params")
    jq = _jax_leaves(jax.eval_shape(JQ.quantize_weights,
                                    JS.param_shapes(jconfigs.get(arch))))
    pq = _port_leaves(Q.quantize_weights(S.param_shapes(configs.get(arch))))
    _same_leaves(jq, pq, "int8 params")
    assert any(n.endswith("/q") for n, _ in pq)
    n_specs = 0
    for sname, shape in JS.SHAPES.items():
        assert S.SHAPES[sname] == S.ShapeSpec(**dataclasses.asdict(shape))
        jc = JS.arch_for_shape(jconfigs.get(arch), shape)
        pc = S.arch_for_shape(configs.get(arch), S.SHAPES[sname])
        assert pc.name == jc.name and pc.sliding_window == jc.sliding_window
        jin = JS.input_specs(jc, shape)
        pin = S.input_specs(pc, S.SHAPES[sname])
        _same_leaves(_jax_leaves(jin), _port_leaves(pin), sname)
        jca = _jax_leaves(jin.get("cache", {}))
        pca = _port_leaves(pin.get("cache", {}))
        for mname, mesh in MESHES.items():
            for fsdp in (False, True):
                kw = dict(seq_shard=sname == "long_500k")
                jpol = JSH.ShardingPolicy(
                    mesh, dataclasses.replace(jc, fsdp_weights=fsdp), **kw)
                ppol = SH.ShardingPolicy(
                    mesh, dataclasses.replace(pc, fsdp_weights=fsdp), **kw)
                where = (sname, mname, fsdp)
                for (name, a), (_, b) in zip(jp + jq, pp + pq):
                    assert ppol.param_spec(name, tuple(b.shape)) == tuple(
                        jpol.param_spec(name, a.shape)), (where, name)
                for (name, a), (_, b) in zip(jca, pca):
                    assert ppol.cache_spec(name, tuple(b.shape)) == tuple(
                        jpol.cache_spec(name, a.shape)), (where, name)
                for batch in (1, 32, 128, 256, 3):
                    assert ppol.tokens_spec(batch) == tuple(
                        jpol.tokens_spec(batch))
                    assert ppol.frames_spec(batch) == tuple(
                        jpol.frames_spec(batch))
                n_specs += len(pp) + len(pq) + len(pca)
    assert n_specs > 0


def test_tree_specs_cover_every_leaf():
    """``tree_specs`` maps a tree leaf by leaf to ``param_spec`` /
    ``cache_spec`` (JAX's ``tree_shardings``); ``opt_state_specs`` mirrors
    the parameters for ``mu``/``nu`` and replicates the step."""
    cfg = configs.get("llama3-405b")
    pol = SH.ShardingPolicy(MESHES["16x16"], cfg)
    params = S.param_shapes(cfg)
    specs = SH.tree_specs(pol, params, "param")
    for name, leaf in named_leaves(params):
        spec = specs
        for key in name.split("/"):
            spec = spec[int(key)] if isinstance(spec, tuple) else spec[key]
        assert spec == pol.param_spec(name, tuple(leaf.shape))
    assert specs["groups"][0]["attn"]["wq"] == (None, "data", "model", None)
    cache = S.cache_shapes(cfg, 128, 32768)
    cspecs = SH.tree_specs(pol, cache, "cache")
    assert cspecs["groups"][0]["k"] == (None, "data", "model", None, None)
    assert cspecs["lengths"] == ("data",)
    opt = SH.opt_state_specs(pol, specs)
    assert opt["mu"] is specs and opt["nu"] is specs and opt["step"] == ()


# ---------------------------------------------------------------------------
# The rules JAX's tests/test_launch.py pins, on the port's policy
# ---------------------------------------------------------------------------

def _policy(arch, **kw):
    return SH.ShardingPolicy(MESHES["16x16"], configs.get(arch), **kw)


@pytest.mark.parametrize("arch,kind,path,shape,want", [
    ("minitron-8b", "param", "groups/0/attn/wq", (32, 4096, 32, 128),
     (None, None, "model", None)),
    ("minitron-8b", "param", "groups/0/attn/wk", (32, 4096, 8, 128),
     (None, None, None, None)),                 # kv 8 < model 16
    ("gemma-7b", "param", "groups/0/attn/wk", (28, 3072, 16, 256),
     (None, None, "model", None)),
    ("llama3-405b", "param", "groups/0/attn/wq", (126, 16384, 128, 128),
     (None, "data", "model", None)),            # fsdp
    ("xlstm-350m", "param", "groups/0/rec/wq", (6, 2048, 4, 256), ()),
    ("minitron-8b", "cache", "groups/0/k", (32, 128, 32768, 8, 128),
     (None, "data", "model", None, None)),
    ("minitron-8b", "param", "groups/0/norm1", (32, 4096), (None, None)),
    ("llama3-405b", "param", "groups/0/attn/wq/q", (126, 16384, 128, 128),
     (None, "data", "model", None)),            # int8: the parent's rule
    ("llama3-405b", "param", "groups/0/attn/wq/s", (126,), ()),
])
def test_policy_rules(arch, kind, path, shape, want):
    pol = _policy(arch)
    fn = pol.param_spec if kind == "param" else pol.cache_spec
    assert fn(path, shape) == want


def test_long_context_shards_the_sequence_over_every_axis():
    spec = _policy("minitron-8b", seq_shard=True).cache_spec(
        "groups/0/k", (32, 1, 524288, 8, 128))
    assert spec[1] is None and spec[2] == ("data", "model")
    pod = SH.ShardingPolicy(MESHES["2x16x16"], configs.get("minitron-8b"),
                            seq_shard=True)
    assert pod.cache_spec("groups/0/k", (32, 1, 524288, 8, 128))[2] == (
        "pod", "data", "model")
    # a singleton axis tuple is a bare name; an indivisible dim replicates
    assert SH._maybe(MESHES["16x16"], ("data",), 32) == "data"
    assert SH._maybe(MESHES["16x16"], ("data", "model"), 100) is None


def test_specs_and_input_specs():
    cfg = configs.get("gemma-7b")
    tr = S.input_specs(cfg, S.SHAPES["train_4k"])
    assert tr["batch"]["tokens"].shape == (256, 4097)
    pf = S.input_specs(cfg, S.SHAPES["prefill_32k"])
    assert pf["cache"]["groups"][0]["k"].shape == (28, 32, 32768, 16, 256)
    assert S.input_specs(cfg, S.SHAPES["decode_32k"])["tokens"].shape == (
        128, 1)
    var = S.arch_for_shape(configs.get("llama3-405b"), S.SHAPES["long_500k"])
    assert var.sliding_window == S.LONG_WINDOW == 8192
    ins = S.input_specs(var, S.SHAPES["long_500k"])
    assert ins["cache"]["groups"][0]["k"].shape[2] == S.LONG_WINDOW
    rg = configs.get("recurrentgemma-9b")
    assert S.arch_for_shape(rg, S.SHAPES["long_500k"]) is rg
    audio = S.input_specs(configs.get("seamless-m4t-large-v2"),
                          S.SHAPES["prefill_32k"])
    assert audio["frames"].shape == (32, 512, 1024)


# ---------------------------------------------------------------------------
# Meshes, placements, local shards
# ---------------------------------------------------------------------------

def test_production_meshes_over_a_fake_group():
    """``make_production_mesh`` over a placeholder group of 256 and 512
    ranks: JAX's axis names and sizes, the policy reads it as it reads the
    stand-in, and ``placements`` puts a ("pod", "data") split on the
    multi-pod mesh's one dim that flattens the two, pod-major."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = configs.get("llama3-405b")
    params = S.param_shapes(cfg)
    for multi, world, stand_in in ((False, 256, "16x16"),
                                   (True, 512, "2x16x16")):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = M.make_production_mesh(multi_pod=multi)
            assert M.axis_sizes(mesh) == MESHES[stand_in].shape
            assert M.data_axes(mesh) == (("pod", "data") if multi
                                         else ("data",))
            real = SH.tree_specs(SH.ShardingPolicy(mesh, cfg), params,
                                 "param")
            fake = SH.tree_specs(SH.ShardingPolicy(MESHES[stand_in], cfg),
                                 params, "param")
            assert real == fake
            spec = real["groups"][0]["attn"]["wq"]
            assert spec == (None, ("pod", "data") if multi else "data",
                            "model", None)
            assert SH.placements(spec, mesh) == [Shard(1), Shard(2)]
            assert SH.placements((None,) * 4, mesh) == [Replicate()] * 2
            assert M.mesh_dims(mesh) == (
                {"pod": 0, "data": 0, "model": 1} if multi
                else {"data": 0, "model": 1})
            if multi:
                assert tuple(mesh.shape) == (32, 16)
                assert SH.placements((("pod", "data", "model"),), mesh) \
                    == [Shard(0), Shard(0)]
                with pytest.raises(ValueError, match="part of the mesh"):
                    SH.placements(("data",), mesh)
        finally:
            dist.destroy_process_group()


def test_host_mesh_and_process_group_on_the_cpu():
    """``init_process_group("cpu")`` starts a one-rank gloo group with no
    rendezvous; ``make_host_mesh`` is 1 x 1 over it, and every local
    shard is the whole tensor."""
    dev = M.init_process_group("cpu")
    try:
        assert dev.type == "cpu" and dist.get_backend() == "gloo"
        mesh = M.make_host_mesh()
        assert M.axis_sizes(mesh) == {"data": 1, "model": 1}
        x = torch.arange(24.0).reshape(2, 3, 4)
        assert torch.equal(SH.local_shard(x, ("data", "model"), mesh), x)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="init_method or a store"):
        M.init_process_group("cpu", rank=0, world_size=2)


def test_process_group_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_process_group()
    assert not dist.is_initialized()


def test_local_shard_is_pod_major():
    """A dimension split over ("pod", "data") is cut into pod x data
    blocks, the rank at (pod p, data d) taking block p * data + d; the
    result is a view."""
    mesh = FakeMesh({"pod": 2, "data": 3, "model": 2})
    x = torch.arange(12 * 4.0).reshape(12, 4)
    spec = (("pod", "data"), "model")
    for p in range(2):
        for d in range(3):
            for m in range(2):
                got = SH.local_shard(x, spec, mesh,
                                     {"pod": p, "data": d, "model": m})
                blk = p * 3 + d
                assert torch.equal(got, x[2 * blk:2 * blk + 2,
                                          2 * m:2 * m + 2])
                assert got.data_ptr() == x[2 * blk, 2 * m].data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        SH.local_shard(torch.zeros(5, 4), spec, mesh,
                       {"pod": 0, "data": 0, "model": 0})
