"""Grids of ranks with named axes over `torch.distributed`.

Counterpart of the JAX package's `parallel/mesh.py` (`make_mesh`,
`local_mesh`). A JAX mesh is a grid of devices that one controller drives.
Here each rank is a process of one `torch.distributed` world, and a `Mesh`
is that rank's view of the world as a grid of ranks laid out row-major: the
size of each axis, the rank's coordinate on it, the process group of the
ranks that differ from it only along that axis, and the rank's device (on
the card, the one the launcher set: card local rank % cards). The
reference's `local_mesh(axis, n)` takes the first n devices; here the world
is the mesh, so a mesh of n ranks is a world of n (`launch.run_ranks`).

The groups are `dist.new_group`s of the world's backend rather than those
of `init_device_mesh`, which sets the CUDA device from LOCAL_RANK itself
and on NCCL may split its groups off the default communicator: here the
rank's device and the backend (`backend_for`, chosen from the layout by the
launcher) are explicit.

Every collective of the distributed modules goes through `Mesh.all_to_all`,
`Mesh.all_gather` and `Mesh.all_gather_object`, which count the bytes this
rank sends to the others (`sent_bytes`; an object's bytes are its
pickle's). On an axis of one rank they return their input without a
collective. The tensors are int32 limbs, which the backends move as bytes:
nothing here reduces (no all_reduce).
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device_type: str, local_ranks: int, cards: int) -> str:
    """The backend of a world with `local_ranks` ranks on each host of
    `cards` cards: gloo on the CPU; on CUDA, NCCL where every rank has a
    card of its own, and gloo where ranks share a card (NCCL refuses two
    ranks of one communicator on one GPU; gloo stages CUDA tensors through
    the host)."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no backend for device type {device_type!r}")
    if cards < 1:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain versions")
    return "nccl" if local_ranks <= cards else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: the CPU, or the card the launcher set."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"no {dev.type} device: pass device='cpu' to run the plain versions")
    return torch.device("cuda", torch.cuda.current_device())


class Mesh:
    """The world's ranks as a row-major grid of `shape`, with one name per
    axis. Every rank constructs it (group creation is collective)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...], device="cuda"):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ in length")
        size = math.prod(shape)
        world, rank = dist.get_world_size(), dist.get_rank()
        if size != world:
            raise ValueError(f"a mesh of {size} ranks in a world of {world}")
        self.shape = dict(zip(axis_names, shape))
        self.coords = dict(zip(axis_names, np.unravel_index(rank, shape)))
        grid = np.arange(size).reshape(shape)
        self._groups = {}
        for i, name in enumerate(axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]).tolist():
                group = dist.new_group(line)
                if rank in line:
                    self._groups[name] = group
        self.device = rank_device(device)
        self.backend = dist.get_backend()
        self.sent_bytes = {"all_to_all": 0, "all_gather": 0}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along the axis."""
        return int(self.coords[axis])

    def group(self, axis: str):
        return self._groups[axis]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x split into size(axis) equal blocks along dim 0; block j goes
        to the rank of coordinate j. -> the blocks received, in order of
        their source's coordinate."""
        s = self.size(axis)
        if x.shape[0] % s:
            raise ValueError(f"{x.shape[0]} rows do not split over {s} ranks")
        if s == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axis))
        self.sent_bytes["all_to_all"] += x.nbytes * (s - 1) // s
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """-> every rank's x along the axis, in order of coordinate."""
        s = self.size(axis)
        if s == 1:
            return [x]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(s)]
        dist.all_gather(out, x, group=self.group(axis))
        self.sent_bytes["all_gather"] += x.nbytes * (s - 1)
        return out

    def all_gather_object(self, obj, axis: str) -> list:
        """-> every rank's picklable obj along the axis, in order of
        coordinate."""
        s = self.size(axis)
        if s == 1:
            return [obj]
        out = [None] * s
        dist.all_gather_object(out, obj, group=self.group(axis))
        self.sent_bytes["all_gather"] += len(pickle.dumps(obj)) * (s - 1)
        return out


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device="cuda") -> Mesh:
    """Mesh of the world's ranks as a grid of `shape` (its product the
    world's size)."""
    return Mesh(tuple(shape), tuple(axis_names), device)


def local_mesh(axis_name: str = "shard", device="cuda") -> Mesh:
    """1-D mesh over the world's ranks."""
    return Mesh((dist.get_world_size(),), (axis_name,), device)
