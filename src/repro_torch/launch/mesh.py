"""Process groups and device meshes (the JAX package's ``launch/mesh.py``).

JAX builds a ``jax.sharding.Mesh`` over the devices one process sees; the
port runs one process per device and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the process group in
place, with JAX's axis names.  Functions, not module constants: importing
this module starts no process group.

``init_process_group`` starts the group for a device: NCCL for ``cuda``,
gloo for ``cpu``.  The backend follows the device asked for; without a
card, ``cuda`` raises (``device.resolve``), nothing moves to the CPU.

The sharding policy reads only axis names and sizes (``axis_names``,
``axis_sizes``), so a stand-in with ``shape`` (name -> size) and
``axis_names``, as JAX's ``tests/test_launch.py`` uses, works too.

The multi-pod mesh keeps JAX's three axes (pod=2, data=16, model=16) as
names, but its ``DeviceMesh`` has two dims: ("pod", "data") flattened
pod-major into one dim of 32, then "model".  Rank r sits at the same
place in both (pod r // 256, data r // 16 % 16, model r % 16), so every
rank keeps JAX's shard, and ``DTensor`` plans each redistribution over
two dims, not three (the policy names "pod" only beside "data").  Such a
mesh carries its axes as ``logical_axes`` (per mesh dim, its axes' names
and sizes, major first); ``axis_names``, ``axis_sizes`` and ``mesh_dims``
read them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import device as D

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_process_group(device: D.DeviceLike = None, *, rank: int = 0,
                       world_size: int = 1,
                       init_method: Optional[str] = None,
                       store: Optional[dist.Store] = None) -> torch.device:
    """Start the default process group for ``device`` (default the CUDA
    card): NCCL on ``cuda`` (this rank's card is ``rank`` modulo the cards
    the process sees), gloo on ``cpu``.  The caller gives the rendezvous
    (``init_method``, e.g. ``tcp://localhost:<port>`` or ``file://...``,
    or a ``store``); a single rank needs none.  Returns the rank's
    device."""
    dev = D.resolve(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if init_method is None and store is None:
        if world_size != 1:
            raise ValueError("a group of more than one rank needs an "
                             "init_method or a store")
        store = dist.HashStore()
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            store=store, rank=rank, world_size=world_size,
                            **kw)
    return dev


def _mesh_device_type() -> str:
    """The device type of the process group in place: ``cuda`` for NCCL,
    ``cpu`` otherwise (gloo, or a fake group of placeholder ranks)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         flat: bool = True) -> DeviceMesh:
    """Single pod: (data=16, model=16), 256 ranks.  Multi pod: (pod=2,
    data=16, model=16), 512 ranks, over two mesh dims (("pod", "data")
    flattened, then "model") unless ``flat`` is False (three dims: the
    decode pipeline's stages take the "data" dim's group).  Over the
    process group in place, whose world size must match."""
    if not multi_pod:
        return init_device_mesh(_mesh_device_type(), (16, 16),
                                mesh_dim_names=("data", "model"))
    if not flat:
        return init_device_mesh(_mesh_device_type(), (2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))
    mesh = init_device_mesh(_mesh_device_type(), (32, 16),
                            mesh_dim_names=("pod_data", "model"))
    mesh.logical_axes = ((("pod", 2), ("data", 16)), (("model", 16),))
    return mesh


def make_host_mesh() -> DeviceMesh:
    """A 1 x 1 (data, model) mesh over a one-rank group."""
    return init_device_mesh(_mesh_device_type(), (1, 1),
                            mesh_dim_names=("data", "model"))


def _logical(mesh) -> Tuple[Tuple[Tuple[str, int], ...], ...]:
    """Per mesh dim, the (name, size) of each axis it carries, major
    first: a ``DeviceMesh``'s ``logical_axes``, else one axis a dim."""
    flat = getattr(mesh, "logical_axes", None)
    if flat is not None:
        return flat
    if isinstance(mesh, DeviceMesh):
        return tuple(((n, int(k)),) for n, k in zip(mesh.mesh_dim_names,
                                                    mesh.shape))
    return tuple(((a, int(mesh.shape[a])),) for a in mesh.axis_names)


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (JAX's), in mesh order."""
    return tuple(a for dim in _logical(mesh) for a, _ in dim)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a stand-in whose
    ``shape`` maps names to sizes (as a JAX ``Mesh``'s does)."""
    return {a: k for dim in _logical(mesh) for a, k in dim}


def mesh_dims(mesh) -> Dict[str, int]:
    """Axis name -> the index of the mesh dim that carries it."""
    return {a: i for i, dim in enumerate(_logical(mesh)) for a, _ in dim}


def coordinates(mesh) -> Dict[str, int]:
    """Axis name -> this process's index along it on the ``DeviceMesh``
    (a flattened dim's index split major axis first)."""
    out = {}
    for dim, c in zip(_logical(mesh), mesh.get_coordinate()):
        for a, k in reversed(dim):
            out[a], c = c % k, c // k
    return out


def data_axes(mesh) -> tuple:
    """The batch-sharding axes: ("pod", "data") on multi-pod meshes."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
