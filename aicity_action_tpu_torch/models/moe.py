"""Mixture-of-Experts MLP of MViT blocks (port of ``aicity_action_tpu/
models/moe.py``; the V-MoE / Switch recipe).

The routing is the JAX package's: per sample, a pre-LN in f32 (the block's
norm2 parameters), router logits ``xn W_r``, softmax, the top-k experts of
each token with their gates renormalized over the k, and a fixed capacity
``C = ceil(k L cf / E)`` per expert and sample filled slot-major (every
token's first choice before any token's second choice, token order within
a slot). A (token, slot) past its expert's capacity is dropped: it adds
nothing to the output, so its token rides the residual. The load-balance
loss is Switch's ``E sum_e f_e p_e`` (``f_e`` the share of tokens whose
top-1 pick is ``e``, ``p_e`` the mean router probability), averaged over
the batch.

Where the JAX package holds the routing as one-hot tensors (``dispatch``
and ``combine`` of shape ``[L, E, C]``, and ``[k L, E, C]`` on the way:
12.6 GB a sample at the first MoE block at 448), the port holds it as
indices (:class:`Routing`): for each (token, slot) an expert, a position
and a gate. The experts' inputs ``[E, B, C, D]`` are built by one scatter
per slot (:func:`dispatch`) and the output by a gather
(:func:`combine`); at 448, block 1, that input is 24 MB a sample in bf16.
:func:`dense_routing` expands the index form into the JAX tensors, for
tests at tiny sizes.

The expert FFN (:func:`moe_ffn`) is two batched products over the experts
(``torch.baddbmm``) with the erf GELU between them (``F.gelu``, one pass
over the ``[E, N C, H]`` hidden), as the JAX package computes it outside
any Pallas kernel; the pre-LN is plain ``F.layer_norm``
in f32 as there. An MoE block therefore runs no LN+MLP kernel (row 10) and
no LN+MLP backward (row 11).

Parameters (torch's ``[out, in]`` layout, the expert on axis 0):
``router [E, D]``, ``fc1_weight [E, H, D]``, ``fc1_bias [E, H]``,
``fc2_weight [E, O, H]``, ``fc2_bias [E, O]``. Under expert parallelism
(``parallel/ep.py``) a rank holds its ``E / n`` experts of the four bank
leaves and the router whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BANK_LEAVES = ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias")


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Static MoE configuration (``MVIT.MOE``); ``num_experts`` 0 = off.
    ``layers`` lists the blocks whose MLP is an expert bank
    (``build_mvit_spec`` resolves an empty list to every other block)."""

    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    layers: tuple = ()

    def capacity(self, n_tokens: int) -> int:
        c = int(np.ceil(self.top_k * n_tokens * self.capacity_factor
                        / self.num_experts))
        return max(1, min(c, n_tokens))


@dataclasses.dataclass
class Routing:
    """One batch's routing, ``[B, k, L]`` per (token, slot): ``expert``
    (int64), ``pos`` its place in that expert's capacity (int64), ``keep``
    whether ``pos < C``, ``gate`` the renormalized gate (f32, with the
    router's gradient); ``aux`` the batch-mean load-balance loss, ``E`` and
    ``C`` the bank's experts and capacity."""

    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    E: int
    C: int


def pre_ln(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-6) -> torch.Tensor:
    """The MoE block's pre-LN in f32 (the JAX ``route_tokens``)."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps)


def route(xn: torch.Tensor, router: torch.Tensor, top_k: int,
          capacity: int) -> Routing:
    """Route every sample of ``xn [B, L, D]`` (f32) over ``router [E, D]``
    with ``capacity`` slots an expert (the JAX ``router_dispatch``, per
    sample, in index form)."""
    B, L, _ = xn.shape
    E = router.shape[0]
    probs = torch.softmax(xn.float() @ router.float().t(), dim=-1)
    gate, expert = probs.topk(top_k, dim=-1)  # [B, L, k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # slot-major priority: slot 0 of every token, then slot 1, ...; a
    # (token, slot)'s place is the count of earlier ones on its expert: a
    # scan along the last dim of [B, E, k L] (torch's scan over an outer
    # dim, [B, k L, E], is the slow one on the card)
    expert = expert.transpose(1, 2)  # [B, k, L]
    flat = expert.reshape(B, 1, top_k * L)
    onehot = (flat == torch.arange(E, device=xn.device).view(1, E, 1)).to(
        torch.int32)
    pos = (onehot.cumsum(-1, dtype=torch.int32).gather(1, flat).long()
           - 1).reshape(B, top_k, L)
    # Switch load balance: top-1 share times mean probability
    f = onehot[:, :, :L].float().mean(-1)
    aux = (E * (f * probs.mean(1)).sum(-1)).mean()
    return Routing(expert, pos, pos < capacity, gate.transpose(1, 2), aux,
                   E, capacity)


def dispatch(xn: torch.Tensor, r: Routing) -> torch.Tensor:
    """The experts' inputs ``[E, B, C, D]``: row ``(e, b, p)`` is the token
    that took place ``p`` of expert ``e`` in sample ``b``, zero where no
    token did. One scatter a slot; a dropped (token, slot) writes to a
    spare row that is cut off."""
    B, k, L = r.expert.shape
    D = xn.shape[-1]
    n = r.E * B * r.C
    b = torch.arange(B, device=xn.device).view(B, 1)
    buf = xn.new_zeros(n + 1, D)
    rows = xn.reshape(B * L, D)
    for s in range(k):
        idx = (r.expert[:, s] * B + b) * r.C + r.pos[:, s]
        idx = torch.where(r.keep[:, s], idx, n)
        buf = buf.index_copy(0, idx.reshape(-1), rows)
    return buf[:n].view(r.E, B, r.C, D)


def combine(out: torch.Tensor, r: Routing) -> torch.Tensor:
    """``y [B, L, O]``: each token's kept slots' expert outputs ``out [E,
    B, C, O]`` weighted by their gates, summed in f32 and returned in
    ``out``'s type (the JAX ``einsum("blec,beco->blo", combine, out)``)."""
    E, B, C, O = out.shape
    k, L = r.expert.shape[1:]
    b = torch.arange(B, device=out.device).view(B, 1, 1)
    idx = torch.where(r.keep, (r.expert * B + b) * C + r.pos, 0)
    rows = out.reshape(E * B * C, O).index_select(0, idx.reshape(-1))
    w = (r.gate * r.keep).to(out.dtype).float()
    y = (rows.view(B, k, L, O).float() * w[..., None]).sum(1)
    return y.to(out.dtype)


def moe_ffn(expert_in: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: ``expert_in [E, N, C, D]``, ``w1 [E, H, D]``,
    ``w2 [E, O, H]`` -> ``[E, N, C, O]`` in ``expert_in``'s type."""
    E, N, C, D = expert_in.shape
    dt = expert_in.dtype
    x = expert_in.reshape(E, N * C, D)
    h = torch.baddbmm(b1.to(dt)[:, None], x, w1.to(dt).transpose(1, 2))
    h = F.gelu(h)  # erf GELU, one op: f32 inside for bf16, rounded once
    y = torch.baddbmm(b2.to(dt)[:, None], h, w2.to(dt).transpose(1, 2))
    return y.view(E, N, C, -1)


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, ln_eps: float = 1e-6,
              dtype: torch.dtype | None = None):
    """The whole pre-LN MoE MLP on ``x [B, L, D]`` with ``params``
    ``{ln_weight, ln_bias, router, fc1_weight, fc1_bias, fc2_weight,
    fc2_bias}`` -> ``(y [B, L, O], aux)``, ``y`` in ``dtype`` (default
    ``x``'s). ``parallel/ep.py:ep_moe_apply`` is its expert-parallel
    form."""
    dt = dtype or x.dtype
    E = params["router"].shape[0]
    xn = pre_ln(x, params["ln_weight"], params["ln_bias"], ln_eps)
    r = route(xn, params["router"], top_k,
              MoESpec(E, top_k, capacity_factor).capacity(x.shape[1]))
    out = moe_ffn(dispatch(xn.to(dt), r), params["fc1_weight"],
                  params["fc1_bias"], params["fc2_weight"],
                  params["fc2_bias"])
    return combine(out, r), r.aux


def dense_routing(r: Routing) -> tuple:
    """The JAX form of ``r``: ``(dispatch, combine)`` one-hots ``[B, L, E,
    C]`` (f32). For tests at tiny sizes only."""
    B, k, L = r.expert.shape
    disp = torch.zeros(B, L, r.E, r.C + 1)
    comb = torch.zeros(B, L, r.E, r.C + 1)
    b = torch.arange(B).view(B, 1).expand(B, L)
    t = torch.arange(L).view(1, L).expand(B, L)
    for s in range(k):
        pos = torch.where(r.keep[:, s], r.pos[:, s], r.C)
        disp[b, t, r.expert[:, s], pos] = 1.0
        comb[b, t, r.expert[:, s], pos] = r.gate[:, s].detach().float()
    return disp[..., :r.C], comb[..., :r.C]


class MoEMlp(nn.Module):
    """Pre-LN MoE MLP in place of a block's ``FusedMlp`` (blocks whose
    attention output keeps its width). ``forward(x, norm)`` takes the
    block's norm2 for the pre-LN and returns ``(y, aux)`` through
    :attr:`moe_fn`, :func:`moe_apply` unless expert parallelism
    (``parallel/ep.py:shard_experts``) leaves the bank this rank's experts
    and puts its expert-parallel form there."""

    def __init__(self, dim: int, hidden: int, dim_out: int, spec: MoESpec):
        super().__init__()
        E = spec.num_experts
        self.top_k = spec.top_k
        self.capacity_factor = spec.capacity_factor
        self.num_experts = E
        self.router = nn.Parameter(torch.zeros(E, dim))
        self.fc1_weight = nn.Parameter(torch.zeros(E, hidden, dim))
        self.fc1_bias = nn.Parameter(torch.zeros(E, hidden))
        self.fc2_weight = nn.Parameter(torch.zeros(E, dim_out, hidden))
        self.fc2_bias = nn.Parameter(torch.zeros(E, dim_out))
        self.moe_fn = moe_apply

    def params(self, norm) -> dict:
        return {"ln_weight": norm.weight, "ln_bias": norm.bias,
                "router": self.router,
                **{k: getattr(self, k) for k in BANK_LEAVES}}

    def forward(self, x: torch.Tensor, norm) -> tuple:
        return self.moe_fn(self.params(norm), x, top_k=self.top_k,
                           capacity_factor=self.capacity_factor,
                           ln_eps=norm.eps)

