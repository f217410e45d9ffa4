"""Meshes of devices and of processes (counterpart of
exavatar_release_tpu/parallel/mesh.py).

The JAX package has one kind of mesh, ``jax.sharding.Mesh``, and two kinds of
entry point over it: standalone renders that own a ``shard_map`` over the
devices of one process, and code that runs once per device inside one. The
port keeps the two apart as two kinds of mesh:

- ``LocalMesh`` (``make_mesh``): ``torch.device``s of the calling process.
  The standalone renders run each rank's work in turn and do the
  collectives as tensor operations in the process. A device may repeat
  (``cuda:0`` four times), as JAX's ``--xla_force_host_platform_device_count``
  makes devices: that is how one card holds several row bands.
- ``ProcessMesh`` (``init_distributed`` + ``make_host_mesh``): one rank per
  process over ``torch.distributed`` (NCCL on cards, gloo on the CPU), named
  axes ``("data", "tile")``. The in-context renders and the data x tile
  train steps take its process groups. NCCL refuses two ranks on one card,
  and gloo runs neither ``all_gather`` nor ``all_to_all`` on CUDA tensors,
  so D > 1 bands on one card are a local mesh.
"""
from __future__ import annotations

import math
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Device = Union[str, torch.device]


class LocalMesh:
    """Devices of this process laid out on named axes."""

    def __init__(self, devices: List, axis_names: Tuple[str, ...], axis_sizes: Tuple[int, ...]):
        self.devices = devices  # flat, row-major over the axes
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, axis_sizes))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        stride = math.prod(self.shape[a] for a in self.axis_names[k + 1:])
        return [self.devices[i * stride] for i in range(self.shape[axis])]

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape}, {[str(d) for d in self.devices]})"


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence[Device]] = None) -> LocalMesh:
    """Mesh over the first prod(axis_sizes) of ``devices`` (default: the
    visible cards; raises where there is none). Typical layouts:
    ``make_mesh((D,), ("tile",))`` shards image rows over D bands,
    ``make_mesh((4,), ("tile",), ["cuda:0"] * 4)`` puts four on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * n) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = math.prod(axis_sizes)
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    return LocalMesh(devices[:n], tuple(axis_names), tuple(int(s) for s in axis_sizes))


class ProcessMesh:
    """This process's place in a ``torch.distributed`` device mesh: the
    process group of each named axis, this rank's index along it, and the
    rank's device."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = {a: device_mesh.size(i)
                                      for i, a in enumerate(self.axis_names)}

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of one axis, or of several: all of them is the
        world."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if set(axes) == set(self.axis_names):
            return dist.group.WORLD
        assert len(axes) == 1, f"a group over {axes} of {self.axis_names}"
        return self.device_mesh.get_group(axes[0])

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank {dist.get_rank()}, {self.device})"


def _multi(var: str, sep: str = ",") -> bool:
    return len(os.environ.get(var, "").split(sep)) > 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Device = "cuda") -> None:
    """Join this process to a ``torch.distributed`` world, once per process,
    before any collective. Initializes when

    - explicit arguments are given (``coordinator_address`` host:port, the
      world size and this rank), or
    - ``COORDINATOR_ADDRESS`` is set (this package's launcher convention;
      the world size and rank from ``NUM_PROCESSES`` / ``PROCESS_ID``, else
      ``WORLD_SIZE`` / ``RANK``), or
    - ``torchrun`` started the process (``RANK``, ``WORLD_SIZE`` and
      ``MASTER_ADDR`` set), or
    - a SLURM job spans several nodes (``SLURM_PROCID``, ``SLURM_NTASKS``,
      and ``MASTER_ADDR`` / ``MASTER_PORT``, which the job script exports).

    No-op for a plain single-process run, and when a world already exists.
    The JAX version also reads a TPU pod's variables (``TPU_WORKER_HOSTNAMES``,
    ``MEGASCALE_COORDINATOR_ADDRESS``); they mean nothing to a GPU cluster and
    are not read here. The backend is NCCL when ``device`` is a CUDA device
    (each rank takes the card ``LOCAL_RANK``) and gloo for the CPU."""
    if dist.is_initialized():
        return
    env = os.environ
    dev = torch.device(device)
    explicit = coordinator_address is not None or num_processes is not None
    slurm = env.get("SLURM_JOB_NUM_NODES", "1") not in ("", "1") or _multi("SLURM_JOB_NODELIST")
    torchrun = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if not (explicit or "COORDINATOR_ADDRESS" in env or torchrun or slurm):
        return  # single process: nothing to initialize
    if explicit or "COORDINATOR_ADDRESS" in env:
        addr = coordinator_address or env["COORDINATOR_ADDRESS"]
        world = num_processes if num_processes is not None else int(
            env.get("NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
        rank = process_id if process_id is not None else int(
            env.get("PROCESS_ID", env.get("RANK", "0")))
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif torchrun:
        world, rank, init_method = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    else:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError("init_distributed: a multi-node SLURM job needs MASTER_ADDR and "
                               "MASTER_PORT exported (the first node's address and a free port)")
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        env.setdefault("LOCAL_RANK", env.get("SLURM_LOCALID", "0"))
        env.setdefault("LOCAL_WORLD_SIZE", env.get("SLURM_NTASKS_PER_NODE", "1").split("(")[0])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' for gloo")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")) if dev.index is None
                              else dev.index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def make_host_mesh(d_tile: Optional[int] = None, data_axis: str = "data",
                   tile_axis: str = "tile") -> ProcessMesh:
    """(world / d_tile, d_tile) -> ("data", "tile") process mesh with the TILE
    axis laid out within each node's processes and the DATA axis across
    nodes.

    The tile axis carries the heavy per-step collectives (the band
    all_gather forward and the pixel cotangents' reduce-scatter backward, or
    the Gaussian exchange's all_to_all), so it must stay on NVLink; the data
    axis all-reduces the gradients once per step. Ranks are numbered
    node-major (torchrun, SLURM), so a row-major (data, tile) layout keeps
    every tile group inside one node whenever d_tile divides the processes
    per node (``LOCAL_WORLD_SIZE``). A world of one needs no launcher."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no torch.distributed world; call init_distributed "
                           "under torchrun (or with explicit arguments) first")
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if d_tile is None:
        d_tile = local
    assert local % d_tile == 0 or d_tile % local == 0, (
        f"tile axis {d_tile} must nest within/across whole nodes ({local} processes/node)")
    assert world % d_tile == 0, (
        f"tile axis {d_tile} must divide the world size {world} (a partial node cannot form "
        f"a rectangular (data, tile) mesh)")
    if d_tile > local:
        warnings.warn(f"tile axis {d_tile} spans {d_tile // local} nodes ({local} processes "
                      f"each): the per-step band all_gather / all_to_all will leave NVLink",
                      stacklevel=2)
    cuda = dist.get_backend() == "nccl"
    device = (torch.device("cuda", torch.cuda.current_device()) if cuda
              else torch.device("cpu"))
    dm = init_device_mesh("cuda" if cuda else "cpu", (world // d_tile, d_tile),
                          mesh_dim_names=(data_axis, tile_axis))
    return ProcessMesh(dm, device)
