"""Meshes and the card's peaks, the reference's ``launch/mesh.py``.

``make_production_mesh`` and ``make_mesh_for`` return stand-ins: the axis
names, a ``shape`` mapping and the ``size``, which is all that
``distributed/sharding.py``'s rules, ``lm_rules``, ``gnn_rules``,
``recsys_rules`` and ``cell_of`` read.  ``make_fake_mesh`` builds a real
``DeviceMesh`` of any shape over torch's ``fake`` process group, whose
collectives move nothing: the dry run (``launch/dryrun.py``) runs each
cell's step on DTensors over it, as rank 0, on the ``meta`` device.
``make_smoke_mesh`` is a real 1 x 1 ``DeviceMesh`` on a world of one rank.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

# NVIDIA H100 SXM 80 GB, from NVIDIA's data sheet
# (https://www.nvidia.com/en-us/data-center/h100/): the roofline's peaks
HW = {
    "peak_flops_bf16": 989e12,   # dense bf16 tensor-core FLOP/s
    "peak_flops_fp32": 67e12,    # float32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,           # HBM3 bytes/s
    "hbm_bytes": 80e9,           # HBM3 capacity
    "nvlink_bw": 900e9,          # NVLink bytes/s
    # the collective roofline's link: one 400 Gb/s ConnectX-7 NIC a GPU
    # (NVIDIA DGX H100 data sheet), 50e9 bytes/s, the same figure as the
    # reference's ``ici_bw``.  Not NVLink's 900e9: every production mesh
    # axis of 16 spans two 8-GPU nodes, so its rings cross the network.
    "link_bw": 50e9,
}


#: GPUs a node (DGX H100), which NVLink joins
GPUS_PER_NODE = 8


def peak_flops(dtype) -> float:
    """The peak for products in ``dtype`` (a torch dtype or its name):
    bf16 on the tensor cores; float32 outside them, since the port runs
    no TF32 (``device.resolve_device``)."""
    name = str(dtype).replace("torch.", "")
    return HW["peak_flops_bf16"] if name in ("bfloat16", "float16") \
        else HW["peak_flops_fp32"]


def stand_in(axis_names: Tuple[str, ...], shape: Tuple[int, ...]
             ) -> SimpleNamespace:
    """A mesh of named axes with no devices behind it."""
    return SimpleNamespace(axis_names=tuple(axis_names),
                           shape=dict(zip(axis_names, shape)),
                           size=math.prod(shape))


def make_production_mesh(*, multi_pod: bool = False) -> SimpleNamespace:
    """The reference's production meshes: (data 16, model 16), or (pod 2,
    data 16, model 16) across pods."""
    if multi_pod:
        return stand_in(("pod", "data", "model"), (2, 16, 16))
    return stand_in(("data", "model"), (16, 16))


def make_mesh_for(n_devices: int, *, model_parallel: int = 1
                  ) -> SimpleNamespace:
    """Elastic mesh: whatever devices survive, factored (data, model)."""
    assert n_devices % model_parallel == 0
    return stand_in(("data", "model"),
                    (n_devices // model_parallel, model_parallel))


#: one device with the smoke mesh's axes, for rules and bundles
ONE = stand_in(("data", "model"), (1, 1))


def make_smoke_mesh(device: DeviceLike = None):
    """A 1 x 1 ``DeviceMesh`` named ("data", "model") on the card (NCCL),
    or on the CPU (gloo) when ``device`` names it.  Without a default
    process group it starts one of one rank over an in-process store (no
    file, no network); with one, it must be of one rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        # NCCL's communicator takes this card
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"make_smoke_mesh: the process group holds "
                           f"{dist.get_world_size()} ranks, not 1")
    return DeviceMesh(dev.type, torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))


def make_fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``names`` on the ``meta`` device
    over a ``fake`` process group of prod(shape) ranks, this process rank
    0.  Its collectives run
    no communication and return tensors of their results' shapes, so a
    step on meta DTensors runs through them.  A process holds one default
    group: with a live one (of any backend) this raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "make_fake_mesh: a default process group is already live "
            f"({dist.get_backend()}, {dist.get_world_size()} ranks); the "
            "fake group needs a process of its own")
    from torch.distributed.device_mesh import _mesh_resources

    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    # DTensor's redistribution cost model asks the mesh's device type for
    # its devices a host, which "meta" cannot say: the H100 nodes' 8
    _mesh_resources.num_devices_per_host = lambda device_type: GPUS_PER_NODE
    # a "meta" mesh: what DTensor makes on the mesh's device (masks,
    # all-to-all's buffers) is meta too, and its shard-to-shard moves are
    # all-to-alls (a "cpu" mesh takes gloo's all-gather in their place)
    return DeviceMesh("meta", torch.arange(n).reshape(*shape),
                      mesh_dim_names=tuple(names))


def mesh_size(mesh: Optional[object]) -> int:
    """The devices of a mesh or a stand-in."""
    from repro_torch.distributed.sharding import mesh_axes
    return math.prod(mesh_axes(mesh).values())
