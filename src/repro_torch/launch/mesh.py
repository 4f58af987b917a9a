"""The production mesh on one NVIDIA H100: (data, model) = (1, 1).

The port of `repro.launch.mesh`.  The reference lays a TPU v5e pod out
as a 16 x 16 (data, model) mesh, or 2 x 16 x 16 with a pod axis; the
port runs on one card, so its mesh is one device under the same axis
names, and everything that shards over it (`sharding`, `core.dist`)
sees axis sizes of 1.  A world size above 1 raises: nothing here runs
more than one process.

`make_production_mesh` is a function, not a module constant: importing
this module starts no process group.  It initialises a world-size-1
group itself (NCCL on the card, gloo when the caller passes
``device="cpu"``) over a `FileStore` in a temporary directory, never a
TCP port; `destroy_production_mesh` tears it down.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Mapping, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# NVIDIA H100 SXM (data sheet, dense rates at the 700 W limit): the
# constants of the roofline tables (`launch.roofline`)
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s
ICI_BW = 450e9                  # bytes/s: NVLink 4, 450 GB/s each way a card
HBM_BYTES = 80 * 2**30          # 85,899,345,920: the card's memory

AXES = ("data", "model")
#: the production mesh's axis sizes, for code that needs no process group
PRODUCTION_AXES = {"data": 1, "model": 1}
ONE_CARD = ("the port runs on one card: world size 1, mesh (data, model) "
            "= (1, 1); the reference's 16 x 16 and 2 x 16 x 16 TPU meshes "
            "have no counterpart here")

_STORE_DIRS: list[str] = []     # FileStore directories of groups made here


def _backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_one_card(data: int, model: int) -> None:
    """Raise unless (data, model) is the one-card mesh (1, 1)."""
    if (data, model) != (1, 1):
        raise ValueError(f"mesh (data, model) = ({data}, {model}): {ONE_CARD}")


def make_mesh(data: int = 1, model: int = 1, *,
              device: str = "cuda") -> DeviceMesh:
    """A (data, model) DeviceMesh of `device`; only (1, 1) exists here.
    Starts a world-size-1 process group if none is running."""
    check_one_card(data, model)
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise ValueError(f"world size {dist.get_world_size()}: {ONE_CARD}")
    else:
        path = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        _STORE_DIRS.append(path)
        dist.init_process_group(
            _backend(device), store=dist.FileStore(
                os.path.join(path, "store"), 1), rank=0, world_size=1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    return DeviceMesh(torch.device(device).type,
                      torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """The production mesh: one card, axes ("data", "model")."""
    if multi_pod:
        raise ValueError(f"--multi-pod: {ONE_CARD}")
    return make_mesh(1, 1, device=device)


def destroy_production_mesh() -> None:
    """Tear down the process group and the store a mesh started."""
    if dist.is_initialized():
        dist.destroy_process_group()
    while _STORE_DIRS:
        shutil.rmtree(_STORE_DIRS.pop(), ignore_errors=True)


def axis_sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a mapping given as one
    (the sharding rules take either, so they can be evaluated for the
    reference's 16 x 16 topology without its devices)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def num_clients(mesh) -> int:
    """FedNC 'clients' = data-parallel groups: 1 on one card."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in batch_axes(sizes):
        n *= sizes[a]
    return n
