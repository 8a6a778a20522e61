"""Data-parallel process groups (port of ``aicity_action_tpu/parallel/
mesh.py:27-57, 142-159``; reference: slowfast/utils/{multiprocessing,
distributed}.py).

PyTorch's idiom is one process per card. A job of ``NUM_SHARDS`` hosts with
``NUM_GPUS`` cards each has ``world = NUM_SHARDS * NUM_GPUS`` ranks, and the
process driving card ``local_rank`` of host ``SHARD_ID`` is rank
``SHARD_ID * NUM_GPUS + local_rank``. Where the JAX package shards a host's
batch over its chips inside ``jit`` (``batch_sharding``), the port gives
each rank its slice of the host's batch and lets
``DistributedDataParallel`` average the gradients.

- :func:`init_distributed` joins the group: ``DIST_BACKEND`` (``nccl``, the
  default and the only backend a card run takes unless ``gloo`` is named)
  at ``INIT_METHOD`` (``tcp://host:port``).
- :func:`all_reduce_sum` is a differentiable all-reduce (the cross-rank
  BatchNorm statistics); :func:`gather_rows` assembles the global batch
  from every rank's rows with one all-reduce (gloo reduces CUDA tensors but
  does not gather them).
- :func:`process_allgather` is the JAX package's ragged host-side gather;
  :func:`allgather_objects` gathers any picklable object.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    """Ranks of the initialized group, 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def world_size(cfg) -> int:
    """``NUM_SHARDS * NUM_GPUS``: the ranks a config asks for."""
    return max(cfg.NUM_SHARDS, 1) * max(cfg.NUM_GPUS, 1)


def global_rank(cfg, local_rank: int) -> int:
    return cfg.SHARD_ID * max(cfg.NUM_GPUS, 1) + local_rank


def check_card_count(cfg, device: str | torch.device) -> None:
    """Raise before any rank is spawned where a card run asks for more
    ranks on this host (``NUM_GPUS``, one a card) than the host has cards.
    Taking fewer ranks instead would change each rank's share of the
    global batch. CPU (gloo) runs are not limited."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count()
    if cfg.NUM_GPUS > have:
        raise RuntimeError(
            f"NUM_GPUS={cfg.NUM_GPUS} asks for {cfg.NUM_GPUS} ranks on this "
            f"host, one a card, but torch.cuda.device_count() is {have}: "
            f"pass NUM_GPUS {have} (e.g. NUM_GPUS 1 on a one-card host) and "
            f"a TRAIN.BATCH_SIZE that divides by it")


def init_distributed(cfg, local_rank: int = 0, *,
                     device: str | torch.device = "cuda",
                     force: bool = False) -> bool:
    """Join the process group of ``cfg`` as card ``local_rank`` of host
    ``SHARD_ID``. At world 1 this does nothing unless ``force`` (a one-rank
    group, so that a card's world-1 run goes through DDP). On the card the
    backend is ``DIST_BACKEND`` as named; ``nccl`` is never swapped for
    another. A CPU run takes ``gloo``, the only backend there. Returns
    whether a group is up."""
    world = world_size(cfg)
    if world == 1 and not force:
        return False
    if is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already up; the config asks for {world}")
        return True
    dev = torch.device(device)
    backend = cfg.DIST_BACKEND
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(
                f"DIST_BACKEND {backend!r} does not run on the CPU; set "
                f"DIST_BACKEND gloo for a CPU data-parallel run")
    elif backend not in ("nccl", "gloo"):
        raise ValueError(f"DIST_BACKEND {backend!r} is not supported")
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else local_rank)
    dist.init_process_group(
        backend=backend, init_method=cfg.INIT_METHOD, world_size=world,
        rank=global_rank(cfg, local_rank))
    return True


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group's ranks, differentiably (the gradient is
    the sum over ranks of the gradients: every rank's loss depends on each
    rank's share); ``x`` itself at world 1."""
    if get_world_size() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch ``[world * b, ...]`` from every rank's ``[b, ...]``
    rows, rank-major (no gradient): one all-reduce of a zero-padded
    buffer, which both gloo and NCCL take for CUDA tensors."""
    world = get_world_size()
    if world == 1:
        return x
    b = x.shape[0]
    buf = torch.zeros((world * b, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    r = get_rank()
    buf[r * b:(r + 1) * b] = x
    dist.all_reduce(buf)
    return buf


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's ``[b, ...]`` slice of a global ``[world * b, ...]``."""
    world = get_world_size()
    if world == 1:
        return x
    b = x.shape[0] // world
    r = get_rank()
    return x[r * b:(r + 1) * b]


def dp_rand(shape: tuple, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """Uniform draws for this rank's ``shape[0]`` rows of the global batch:
    every rank draws the whole global batch's values from ``generator``
    and keeps its own rows, so that a data-parallel step masks each row as
    the one-process step on the global batch does."""
    world = get_world_size()
    full = torch.rand((shape[0] * world, *shape[1:]), generator=generator,
                      device=device)
    return local_rows(full)


def allgather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    group)."""
    if get_world_size() == 1:
        return [obj]
    out: list = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def process_allgather(x) -> list:
    """Host-side gather of per-process arrays: a list with one entry per
    rank, which callers ``np.concatenate``. Ragged leading axes are
    allowed, as in the JAX package; the arrays travel pickled
    (``all_gather_object``)."""
    x = np.asarray(x)
    if get_world_size() == 1:
        return [x]
    out: list = [None] * get_world_size()
    dist.all_gather_object(out, x)
    return [np.asarray(o) for o in out]
