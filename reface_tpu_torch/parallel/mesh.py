"""Process group, mesh and placement (port of reface_tpu/parallel/mesh.py).

The reference trains with PyTorch-Lightning DDP over NCCL; the JAX package
puts one jax.sharding.Mesh with a `data` axis (DP) and a `model` axis (TP of
the UNet, parallel/tp.py) over its devices and lets XLA insert the
collectives. Here every rank is one process with one device, the mesh is a
(data, model) grid of the ranks of torch.distributed's world (rank = data
index * n_model + model index, the JAX mesh's row-major layout), and the
collectives are explicit: the training step averages the gradients over
the data group (pipelines/train.py), the TP layers communicate over the
model group (parallel/tp.py).

One process with no process group is a 1 x 1 mesh whose groups are None:
every collective is then skipped, and the step is the plain one. NCCL
serves CUDA devices, gloo the CPU; gloo also takes CUDA tensors (two ranks
sharing one card, which NCCL refuses), every collective used here included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "init_distributed",
    "create_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "shard_params",
    "all_reduce",
    "all_gather",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _torchrun_env() -> Optional[tuple[int, int, str, int]]:
    """(rank, world, "host:port", local rank) from torchrun's environment,
    or None where it is not set."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return None
    rank = int(env["RANK"])
    return (rank, int(env["WORLD_SIZE"]), f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env.get("LOCAL_RANK", rank)))


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device=None,
    backend: Optional[str] = None,
) -> tuple[int, int]:
    """Join the process group; returns (rank, world size). Idempotent.

    The three flags of the JAX driver: `coordinator` "host:port" (or an
    init-method URL such as "file:///path/store"), `num_processes` and
    `process_id`. Where they are absent, torchrun's RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT / LOCAL_RANK are read (the port's form of the
    pods' auto-detection). One process with no coordinator and no such
    environment returns (0, 1) at once and starts no group.

    Each rank's device is cuda:LOCAL_RANK (cuda:process_id without torchrun,
    modulo the visible cards) unless `local_device` names another, or the
    CPU where there is no card; the backend is nccl for a CUDA device and
    gloo for the CPU unless `backend` says otherwise (gloo on a card: two
    ranks on one device, which NCCL refuses). A CUDA device becomes the
    process's current device.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = _torchrun_env()
    if coordinator is None and num_processes in (None, 0, 1) and process_id in (None, 0) \
            and env is None:
        return 0, 1
    local = None
    if env is not None:
        e_rank, e_world, e_coord, local = env
        coordinator = coordinator or e_coord
        num_processes = num_processes if num_processes is not None else e_world
        process_id = process_id if process_id is not None else e_rank
    if coordinator is None:
        raise ValueError("multi-process training needs --coordinator host:port "
                         "(or torchrun's environment)")
    if num_processes is None or process_id is None:
        raise ValueError(f"--coordinator {coordinator} needs --num-processes and "
                         f"--process-id (or torchrun's RANK and WORLD_SIZE)")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is outside the "
                         f"{num_processes} processes")
    if local_device is not None:
        dev = torch.device(local_device)
    elif torch.cuda.is_available():
        dev = torch.device("cuda", (process_id if local is None else local)
                           % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    return process_id, num_processes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of the world's ranks: this rank's place in it,
    its device and its two groups (None without a process group)."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def data_src(self) -> int:
        """The global rank of data index 0 in this rank's data group."""
        return self.model_rank


def create_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """Build a (data, model) mesh over the world's ranks.

    Defaults to all ranks on the data axis (pure DP, the reference's
    strategy). The axis sizes must multiply to the world size. Every rank
    calls this in the same order (it creates the groups). `device` is the
    rank's (default: the current card, else the CPU)."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(1, 1, 0, dev)
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(n_model):  # every rank creates every group, in one order
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Mesh(n_data, n_model, rank, dev, data_group, model_group)


def batch_sharding(mesh: Mesh) -> tuple:
    """The placement of a batch: its leading dim split over the data axis
    (the JAX package's P("data"))."""
    return (DATA_AXIS,)


def replicated(mesh: Mesh) -> tuple:
    """The placement of a replicated tensor (the JAX package's P())."""
    return ()


def shard_batch(batch, mesh: Mesh):
    """A dict (nested allowed) of (B_local, ...) arrays on the rank's device.

    The loader already gives each process its slice of the global batch
    (B_local = B_global / process count), so this is a device move: the
    slices together are the global batch of the JAX package's shard_batch.
    """
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(mesh.device, non_blocking=True)
    return batch


def _modules(modules) -> list:
    if hasattr(modules, "towers"):
        return list(modules.towers().values())
    if isinstance(modules, dict):
        return list(modules.values())
    return [modules]


@torch.no_grad()
def shard_params(modules, mesh: Mesh):
    """Every parameter and buffer of `modules` (a SwapModules, a dict of
    modules or one module) broadcast from data index 0 over the data group:
    the port's form of "every process holds identical values" (the JAX
    package places the local copies as one replicated array). Returns
    `modules`."""
    group = mesh.data_group
    if group is None:
        return modules
    for m in _modules(modules):
        for t in list(m.parameters()) + list(m.buffers()):
            dist.broadcast(t.data, src=mesh.data_src(), group=group)
    return modules


# ------------------------------------------------------------ collectives

def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of `t` over `group`; nothing without a group."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order."""
    if group is None:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)
