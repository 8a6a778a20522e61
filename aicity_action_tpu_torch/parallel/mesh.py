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

Named axes (the JAX ``make_mesh``, :func:`make_mesh` from ``TPU.MESH_SHAPE``
/ ``TPU.MESH_AXES``): :class:`Mesh` lays the ranks out row-major on the
axes and makes one process group a line of each axis with
``dist.new_group`` (not ``init_device_mesh``, which binds rank r to card r:
two gloo ranks may share one card). By default every rank holds its own
rows of a step's batch; a step whose batch is sharded over one axis alone
(a tensor-parallel step: the model axis's ranks see the same rows) is
given that axis's :func:`data_ranks` and hands them to :func:`gather_rows`
and :func:`local_rows`, and to :func:`dp_rand` on its step's generator
(:class:`RowGenerator`).

The collectives along an axis (:func:`axis_all_gather`,
:func:`axis_all_to_all`, :func:`halo_exchange`, :func:`axis_all_reduce`)
are differentiable, and each is one all-reduce of a zero-padded buffer, in
the forward and in the backward: gloo reduces CUDA tensors but neither
gathers nor exchanges them, and NCCL refuses two ranks on one card, so
this one form serves both backends on CPU and CUDA tensors. Its cost is
the axis size times the bytes a gather or exchange would move.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


class DataRanks(NamedTuple):
    """The ranks over which a step's batch is sharded: their process group
    (None: the whole group), their number and this rank's index."""

    group: object
    size: int
    index: int


def data_ranks(m: Optional["Mesh"] = None, axis: str = "data") -> DataRanks:
    """The ranks of ``m``'s ``axis``; every rank of the group without a
    mesh."""
    if m is None:
        return DataRanks(None, get_world_size(), get_rank())
    return DataRanks(m.group(axis), m.size(axis), m.index(axis))


class RowGenerator(torch.Generator):
    """A ``torch.Generator`` that carries the :class:`DataRanks` of its
    step's batch (None: every rank), for :func:`dp_rand`."""

    def __new__(cls, device="cpu", data: Optional[DataRanks] = None):
        self = super().__new__(cls, device=device)
        self.data = data
        return self


def gather_rows(x: torch.Tensor,
                data: Optional[DataRanks] = None) -> torch.Tensor:
    """The global batch ``[size * b, ...]`` from the ``data`` ranks'
    ``[b, ...]`` rows (every rank's by default), rank-major (no gradient):
    one all-reduce of a zero-padded buffer, which both gloo and NCCL take
    for CUDA tensors."""
    group, world, r = data or data_ranks()
    if world == 1:
        return x
    b = x.shape[0]
    buf = torch.zeros((world * b, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[r * b:(r + 1) * b] = x
    dist.all_reduce(buf, group=group)
    return buf


def local_rows(x: torch.Tensor,
               data: Optional[DataRanks] = None) -> torch.Tensor:
    """This rank's ``[b, ...]`` slice of a global ``[size * b, ...]``."""
    _, world, r = data or data_ranks()
    if world == 1:
        return x
    b = x.shape[0] // world
    return x[r * b:(r + 1) * b]


def dp_rand(shape: tuple, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """Uniform draws for this rank's ``shape[0]`` rows of the global batch:
    every rank draws the whole global batch's values from ``generator``
    and keeps its own rows, so that a data-parallel step masks each row as
    the one-process step on the global batch does. The batch is sharded
    over the generator's :attr:`RowGenerator.data` ranks, every rank's
    without them."""
    data = getattr(generator, "data", None) or data_ranks()
    full = torch.rand((shape[0] * data.size, *shape[1:]),
                      generator=generator, device=device)
    return local_rows(full, data)


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


class Mesh:
    """The group's ranks on named axes (the JAX ``make_mesh``): rank ``r``
    sits at ``np.unravel_index(r, shape)``; :meth:`group` is the process
    group of this rank's line along an axis (None for an axis of size 1).
    Every rank must build the mesh, in the same order as its other
    groups (``dist.new_group`` is collective)."""

    def __init__(self, shape, axes):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes}")
        world, rank = get_world_size(), get_rank()
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                             f"ranks; the group has {world}")
        self.shape = dict(zip(axes, shape))
        self.coords = dict(zip(axes, (int(c) for c in
                                      np.unravel_index(rank, shape))))
        self._groups: dict = {}
        grid = np.arange(world).reshape(shape)
        for i, a in enumerate(axes):
            if shape[i] == 1:
                self._groups[a] = None
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                g = dist.new_group([int(v) for v in line])
                if rank in line:
                    self._groups[a] = g

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]


def make_mesh(cfg) -> Mesh:
    """The mesh of ``cfg.TPU.MESH_SHAPE`` / ``MESH_AXES``; without a shape,
    every rank on the first axis (``data``)."""
    if cfg.TPU.MESH_SHAPE:
        return Mesh(cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES)
    return Mesh((get_world_size(),), tuple(cfg.TPU.MESH_AXES)[:1])


def _reduce(buf: torch.Tensor, group) -> torch.Tensor:
    """``buf`` summed over ``group`` in place. A bf16 or f16 buffer
    travels as f32 (exact: every element sums one value and zeros), which
    every gloo build reduces, so that one path serves both backends."""
    if buf.dtype in (torch.bfloat16, torch.float16):
        wide = buf.float()
        dist.all_reduce(wide, group=group)
        return buf.copy_(wide)
    dist.all_reduce(buf, group=group)
    return buf


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, r):
        ctx.args = dim, group, n, r
        c = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * c
        buf = x.new_zeros(shape)
        buf.narrow(dim, r * c, c).copy_(x)
        return _reduce(buf, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, r = ctx.args
        c = g.shape[dim] // n
        g = _reduce(g.contiguous().clone(), group)
        return g.narrow(dim, r * c, c), None, None, None, None


def axis_all_gather(x: torch.Tensor, m: Mesh, axis: str,
                    dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in rank
    order (JAX ``all_gather(tiled=True)``); the backward sums the ranks'
    gradients of each piece (``psum_scatter``)."""
    n = m.size(axis)
    if n == 1:
        return x
    return _AllGather.apply(x.contiguous(), dim, m.group(axis), n,
                            m.index(axis))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group, n, r):
        ctx.args = split, concat, group, n, r
        return _all_to_all(x, split, concat, group, n, r)

    @staticmethod
    def backward(ctx, g):
        split, concat, group, n, r = ctx.args
        return (_all_to_all(g.contiguous(), concat, split, group, n, r),
                None, None, None, None, None)


def _all_to_all(x, split, concat, group, n, r):
    """Piece ``j`` of ``x`` along ``split`` goes to rank ``j``, which
    stacks what it gets on ``concat`` in rank order: the whole
    ``[..., n * split piece, ..., n * concat piece, ...]`` tensor is
    assembled by one all-reduce and each rank keeps its ``split`` piece."""
    c = x.shape[concat]
    shape = list(x.shape)
    shape[concat] = n * c
    buf = x.new_zeros(shape)
    buf.narrow(concat, r * c, c).copy_(x)
    s = x.shape[split] // n
    return _reduce(buf, group).narrow(split, r * s, s).contiguous()


def axis_all_to_all(x: torch.Tensor, m: Mesh, axis: str, split: int,
                    concat: int) -> torch.Tensor:
    """JAX ``all_to_all(split_axis=split, concat_axis=concat,
    tiled=True)`` along ``axis``; its backward is the exchange back."""
    n = m.size(axis)
    if n == 1:
        return x
    if x.shape[split] % n:
        raise ValueError(f"dimension {split} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    return _AllToAll.apply(x.contiguous(), split, concat, m.group(axis), n,
                           m.index(axis))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, halo, fill, group, n, r):
        ctx.args = x.shape, dim, halo, group, n, r
        L = x.shape[dim]
        buf = x.new_zeros((n, 2, *_halo_shape(x.shape, dim, halo)))
        buf[r, 0] = x.narrow(dim, 0, halo)
        buf[r, 1] = x.narrow(dim, L - halo, halo)
        _reduce(buf, group)
        above = buf[r - 1, 1] if r > 0 else torch.full_like(buf[r, 0], fill)
        below = (buf[r + 1, 0] if r < n - 1
                 else torch.full_like(buf[r, 0], fill))
        return above.contiguous(), below.contiguous()

    @staticmethod
    def backward(ctx, g_above, g_below):
        shape, dim, halo, group, n, r = ctx.args
        buf = g_above.new_zeros((n, 2, *g_above.shape))
        if r > 0:
            buf[r - 1, 1] = g_above
        if r < n - 1:
            buf[r + 1, 0] = g_below
        _reduce(buf, group)
        dx = g_above.new_zeros(shape)
        dx.narrow(dim, 0, halo).add_(buf[r, 0])
        dx.narrow(dim, shape[dim] - halo, halo).add_(buf[r, 1])
        return dx, None, None, None, None, None, None


def _halo_shape(shape, dim, halo):
    out = list(shape)
    out[dim] = halo
    return out


def halo_exchange(x: torch.Tensor, m: Mesh, axis: str, dim: int,
                  halo: int = 1, fill: float = 0.0) -> tuple:
    """``(above, below)``: the ``halo`` slices on ``dim`` of the ranks
    before and after this one along ``axis`` (its trailing and leading
    ones), ``fill`` past the ends of the axis (0 for a convolution's zero
    padding, ``-inf`` for a max pool's). The JAX ``sp.halo_exchange``."""
    n = m.size(axis)
    if x.shape[dim] < halo:
        raise ValueError(f"a halo of {halo} from {x.shape[dim]} rows")
    if n == 1:
        edge = torch.full_like(x.narrow(dim, 0, halo), fill)
        return edge, edge.clone()
    return _Halo.apply(x.contiguous(), dim, halo, fill, m.group(axis), n,
                       m.index(axis))


def axis_all_reduce(x: torch.Tensor, m: Mesh, axis: str) -> torch.Tensor:
    """``x`` summed along ``axis``, differentiably (JAX ``psum``)."""
    if m.size(axis) == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=m.group(axis))


def sharded_grad_norm(params, sharded: set, m: Mesh, axis: str):
    """L2 norm over the gradients of ``params`` where the parameters whose
    ``id`` is in ``sharded`` hold one piece each along ``axis`` (each piece
    counted once) and the others are replicated (counted once)."""
    own = [p.grad.float().pow(2).sum() for p in params
           if p.grad is not None and id(p) in sharded]
    rep = [p.grad.float().pow(2).sum() for p in params
           if p.grad is not None and id(p) not in sharded]
    zero = torch.zeros((), device=params[0].device)
    sq = torch.stack(own).sum() if own else zero
    if m.size(axis) > 1:
        dist.all_reduce(sq, group=m.group(axis))
    return torch.sqrt(sq + (torch.stack(rep).sum() if rep else zero))
