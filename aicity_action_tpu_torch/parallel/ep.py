"""Expert parallelism for the MoE banks (port of ``aicity_action_tpu/
parallel/ep.py``).

The batch is sharded over the ranks; each rank routes its own samples
(routing is per sample, so it does not depend on the sharding), builds its
experts' inputs over the whole expert axis, then

    expert_in [E, B_l, C, D]
      -- all-to-all (split E, concatenate the batch) -->
    [E_l, n B_l, C, D]  -- this rank's experts -->  [E_l, n B_l, C, O]
      -- all-to-all back (split the batch, concatenate E) -->
    out [E, B_l, C, O]  -- combine --> y [B_l, L, O]

(:func:`ep_moe_apply`), equal to the dense layer. Rank ``r`` of the axis
holds experts ``[r E/n, (r+1) E/n)`` of the bank leaves
(:func:`shard_experts`, the counterpart of ``moe_param_shardings``), so an
optimizer built after it keeps their moments on that rank alone
(:func:`ep_state_placements`).

The gradients of a step (:func:`ep_grad_sync`): an expert slice's gradient
comes back through the all-to-all's backward summed over the losses of
every rank that routed to it, so it is summed over the data axis's
replicas of the slice and divided by the ranks, giving the global batch's
mean; every replicated leaf (router, norms, the rest of the model) is
averaged over the ranks, as ``DistributedDataParallel`` would. Gradient
clipping counts each slice once (:func:`ep_grad_norm`).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..models.moe import (BANK_LEAVES, MoEMlp, MoESpec, combine, dispatch,
                          moe_ffn, pre_ln, route)
from . import mesh as pmesh


def ep_moe_apply(params: dict, x: torch.Tensor, m: pmesh.Mesh, axis: str, *,
                 top_k: int, capacity_factor: float, ln_eps: float = 1e-6,
                 dtype: torch.dtype | None = None):
    """The MoE MLP on this rank's samples ``x [B_l, L, D]`` with this
    rank's expert slice in ``params`` (``fc*`` leaves ``[E/n, ...]``; the
    router and norm whole) -> ``(y [B_l, L, O], aux)``, ``aux`` the mean
    over the axis's ranks (differentiable)."""
    dt = dtype or x.dtype
    n = m.size(axis)
    E = params["fc1_weight"].shape[0] * n
    if params["router"].shape[0] != E:
        raise ValueError(f"a router of {params['router'].shape[0]} experts "
                         f"over {n} ranks of {E // n}")
    xn = pre_ln(x, params["ln_weight"], params["ln_bias"], ln_eps)
    r = route(xn, params["router"], top_k,
              MoESpec(E, top_k, capacity_factor).capacity(x.shape[1]))
    ei = pmesh.axis_all_to_all(dispatch(xn.to(dt), r), m, axis, split=0,
                               concat=1)
    out = moe_ffn(ei, params["fc1_weight"], params["fc1_bias"],
                  params["fc2_weight"], params["fc2_bias"])
    out = pmesh.axis_all_to_all(out, m, axis, split=1, concat=0)
    return combine(out, r), pmesh.axis_all_reduce(r.aux, m, axis) / n


def ep_moe_mlp(m: pmesh.Mesh, axis: str, params: dict, x: torch.Tensor, *,
               top_k: int, capacity_factor: float, ln_eps: float = 1e-6,
               dtype: torch.dtype | None = None):
    """One MoE layer expert-parallel from whole params and the whole batch
    ``x [B, L, D]`` (``B`` divisible by the ranks): this rank's samples
    and experts through :func:`ep_moe_apply`; returns this rank's ``(y,
    aux)``."""
    n, i = m.size(axis), m.index(axis)
    local = {k: (v.chunk(n, 0)[i] if k in BANK_LEAVES else v)
             for k, v in params.items()}
    return ep_moe_apply(local, x.chunk(n, 0)[i], m, axis, top_k=top_k,
                        capacity_factor=capacity_factor, ln_eps=ln_eps,
                        dtype=dtype)


def moe_param_placements(model: torch.nn.Module, n: int) -> dict:
    """``{name: 0}`` for each bank leaf sharded on its expert axis over
    ``n`` ranks, ``{name: None}`` for every other (replicated) parameter
    (the JAX ``moe_param_shardings``)."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = (0 if leaf in BANK_LEAVES and isinstance(
            model.get_submodule(name.rsplit(".", 1)[0]), MoEMlp)
            and p.shape[0] % n == 0 else None)
    return out


def shard_experts(model: torch.nn.Module, m: pmesh.Mesh,
                  axis: str = "ep") -> set:
    """Keep this rank's expert slice of every MoE bank of ``model`` (each
    bank leaf replaced by its ``[E/n, ...]`` rows) and switch the banks to
    :func:`ep_moe_apply` over ``axis``. Returns the slices' ids, for
    :func:`ep_grad_sync`. Build the optimizer after this call."""
    n, i = m.size(axis), m.index(axis)
    sharded = set()
    for mod in model.modules():
        if not isinstance(mod, MoEMlp):
            continue
        if mod.num_experts % n:
            raise ValueError(f"{mod.num_experts} experts over {n} ranks")
        for leaf in BANK_LEAVES:
            p = torch.nn.Parameter(
                getattr(mod, leaf).detach().chunk(n, 0)[i].clone())
            setattr(mod, leaf, p)
            sharded.add(id(p))
        mod.moe_fn = functools.partial(ep_moe_apply, m=m, axis=axis)
    return sharded


def ep_state_placements(optimizer, model: torch.nn.Module,
                        sharded: set) -> dict:
    """``{parameter name: {state key: "expert slice" or "replicated"}}``
    of a torch optimizer built over an expert-sharded ``model``: a
    moment follows its parameter (the JAX ``ep_state_shardings``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for p, state in optimizer.state.items():
        kind = "expert slice" if id(p) in sharded else "replicated"
        out[names[id(p)]] = {k: kind for k, v in state.items()
                             if torch.is_tensor(v) and v.dim() > 0}
    return out


def ep_grad_sync(model: torch.nn.Module, m: pmesh.Mesh, axis: str,
                 sharded: set) -> None:
    """After the backward of a step whose batch is sharded over every
    rank: each expert slice's gradient summed over the replicas of the
    other axes and divided by the ranks; every other gradient averaged
    over the ranks."""
    world = pmesh.get_world_size()
    others = [a for a in m.shape if a != axis and m.size(a) > 1]
    for p in model.parameters():
        if p.grad is None:
            continue
        if id(p) in sharded:
            for a in others:
                dist.all_reduce(p.grad, group=m.group(a))
        elif world > 1:
            dist.all_reduce(p.grad)
        p.grad.div_(world)


def ep_grad_norm(m: pmesh.Mesh, axis: str, sharded: set):
    """The global gradient norm of an expert-sharded model (each expert
    slice counted once), for ``TrainOptimizer.norm_fn``."""
    return lambda params: pmesh.sharded_grad_norm(params, sharded, m, axis)
