"""Device meshes over ``torch.distributed`` (the port of
``tiler_tpu/parallel/mesh.py``).

The JAX package runs one controller over every device of a
``jax.sharding.Mesh``. The port runs SPMD, PyTorch's idiom: one process
a device, every rank runs the whole encoder on the same clip and
settings, and the sharded stages split their work by the rank's
coordinate on a ``DeviceMesh`` and exchange results through collectives
(``parallel/collectives.py``), so that after each stage every rank holds
the same state. Two named axes, as in the JAX package:

  - "corpus": the tile corpus (the KNN dataset, the k-means points) is
    sharded; distances are computed shard-locally and the candidates or
    partial sums are gathered;
  - "data": frames are data-parallel (the motion search).

A node of several cards runs
``torchrun --nproc-per-node N -m tiler_tpu_torch encode ... --mesh auto``.
A mesh spans every rank of the default process group.
"""
from __future__ import annotations

import math
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_dims(n: int, axis_names: Sequence[str] = ("corpus",)) -> tuple:
    """The JAX package's split of n devices: one axis holds them all; two
    axes make a near-square (d, n // d) grid, d = floor(sqrt(n)) lowered
    until it divides n."""
    if len(axis_names) == 1:
        return (n,)
    if len(axis_names) != 2:
        raise ValueError(f"a mesh has one or two axes, not {tuple(axis_names)}")
    d = math.isqrt(n)
    while n % d:
        d -= 1
    return (d, n // d)


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: the CPU, or the card ``LOCAL_RANK`` names (0
    without the variable) for ``cuda``."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: a mesh is of 'cuda' or 'cpu' devices")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise RuntimeError(f"rank with LOCAL_RANK={local} needs CUDA card {local}, and "
                           f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", local)


def free_port() -> int:
    """A free TCP port on localhost, for ``tcp://127.0.0.1:<port>`` when a
    group is started without torchrun (one process, or spawned ranks)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def init_process_group(device_type: str = "cuda"):
    """Initialize the default process group from torchrun's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) unless one
    is: NCCL for ``cuda`` (after selecting this rank's card), gloo for
    ``cpu``. Raises when ``cuda`` is asked for and no card is visible."""
    if dist.is_initialized():
        return
    dev = rank_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(BACKENDS[dev.type], init_method="env://")


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("corpus",),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of every rank of the initialized default group,
    shaped by :func:`mesh_dims`, its dims named ``axis_names``. For
    ``cuda`` each rank takes ``cuda:{LOCAL_RANK}``. ``n_devices``, when
    given, must be the world size: every rank is one device of the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.mesh.init_process_group under torchrun)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a group of {world} ranks: "
                         "every rank is one device of the mesh")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return init_device_mesh(device_type, mesh_dims(n, axis_names),
                            mesh_dim_names=tuple(axis_names))


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
