"""Ranks of the port's CPU data-parallel tests: ``torch.multiprocessing.
spawn`` of gloo ranks that import torch and the port only (no JAX).

    python tests/torch_dp_worker.py JOB.pkl

``JOB.pkl`` holds ``{"kind", "world", "init_method", "out", ...}``; each
rank ``r`` writes what it saw to ``out/rank{r}.pkl``. Kinds:

- ``"loop"``: ``runs``, a list of ``(name, cfg)`` of the port's config,
  each trained (``engine/train_loop.train``) where ``TRAIN.ENABLE`` and
  tested where ``TEST.ENABLE``; then the ragged ``process_allgather`` and, for each cfg of
  ``loaders``, the clip indices of every batch this rank's train loader
  gives.
- ``"step"``: ``cases``, each a conv net's ``cfg``, a ``state`` of f64
  tensors, an SGD ``lr`` and a global ``batch`` ``(inputs, labels)``: one
  f64 train step under DDP on this rank's rows; the loss, gradient norm,
  gradients and ``state_dict`` after (BatchNorm statistics included).
- ``"contrastive"``: an ActionCLIP ``cfg`` (MoCo per ``TRAIN.USE_MOCO``),
  its ``state``, an SGD ``lr``, ``steps`` and a global ``batch`` of
  ``inputs``, ``tokens``, ``labels`` and ``n_valid`` real rows: the
  contrastive train steps under DDP on this rank's rows (its real ones
  first); each step's loss and temperature, the parameters and the
  momentum weights after.
- ``"scoring"``: ``cases``, each ``(name, cfg, streaming)``, scored on the
  view ``video`` by ``WindowScorer`` (:func:`score_cases`): every rank's
  windows (the whole video's, after the gather), its model forwards and
  the per-rank split.
- ``"ep_tp"``: expert and tensor parallelism on a ``Mesh``: ``moe``, one
  MoE layer's ``params`` and a global ``x`` and cotangent ``cot`` through
  ``ep_moe_mlp`` (this rank's output, load-balance loss and gradients of
  ``sum(y cot) + aux``); ``ep_step``, an MoE ``cfg`` and ``state`` (f64)
  taking one SGD step with its experts sharded (its loss, gradients and
  the optimizer's placements); ``tp_step``, a ``cfg`` and ``state`` taking
  one AdamW step with the weights split over ``model`` on a ``(1,
  world)`` mesh (loss, gradient norm, the parameters after, the
  placements of the parameters and moments); ``half``, bf16 rows through
  the gather, the all-to-all and the halo exchange.
- ``"sp"``: sequence parallelism on a ``(world,)`` mesh: ``pools``, each
  ``(mode, kernel, stride, shard_dim, x, weight)`` of a channel-major
  volume pooled from this rank's shard (its output shard); ``attention``,
  ``sp_pooled_attention`` on this rank's H shard; ``models``, each ``(name,
  cfg, state, clip, shard_axis)`` scored by ``sp_apply`` (the logits).
- ``"multihead"``: a multi-head MViT ``cfg``, its ``state``, an SGD ``lr``,
  ``steps`` and a global ``batch`` of ``inputs``, one-hot ``labels``,
  ``dataset_idx`` and ``n_valid`` real rows: the multi-head train steps
  under DDP on this rank's rows; each step's loss, the gradients of the
  last step and the parameters after.
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from aicity_action_tpu_torch.parallel import mesh  # noqa: E402


def _numpy_state(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _loop(rank, job):
    from aicity_action_tpu_torch.data.loader import construct_loader
    from aicity_action_tpu_torch.engine.test_loop import test
    from aicity_action_tpu_torch.engine.train_loop import train

    out = {"runs": {}, "loaders": []}
    for name, cfg in job["runs"]:
        res = {}
        if cfg.TRAIN.ENABLE:
            run = train(cfg, device="cpu")
            res = {
                "start_epoch": run.start_epoch,
                "losses": [e["losses"] for e in run.epochs],
                "val": [e["val"] for e in run.epochs],
                "count": run.optimizer.count,
                "zero": run.optimizer.zero,
                "params": {k: v.detach().numpy().copy()
                           for k, v in run.model.named_parameters()},
            }
        res["test"] = test(cfg, device="cpu") if cfg.TEST.ENABLE else None
        out["runs"][name] = res
    out["allgather"] = mesh.process_allgather(
        np.arange(rank * 10, rank * 10 + rank + 1))
    for cfg in job["loaders"]:
        cfg = cfg.clone()
        cfg.SHARD_ID = rank // cfg.NUM_GPUS  # hosts of NUM_GPUS ranks
        loader = construct_loader(cfg, "train")
        loader.set_epoch(1)
        out["loaders"].append([b["index"].tolist() for b in loader])
    return out


def _step(rank, job):
    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.engine.train_loop import wrap_ddp
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer

    out = []
    for case in job["cases"]:
        cfg = case["cfg"]
        model = build_model(cfg, device="cpu").double()
        model.compute_dtype = torch.float64
        model.load_state_dict(case["state"])
        ddp = wrap_ddp(model, torch.device("cpu"))
        lr = case["lr"]
        opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=lr),
                             lambda step: lr)
        step = make_train_step(ddp, opt, cfg.MODEL.LOSS_FUNC)
        inputs, labels = case["batch"]
        b = labels.shape[0] // job["world"]
        rows = slice(rank * b, (rank + 1) * b)
        xs = [torch.from_numpy(x[rows]) for x in inputs]
        metrics, _ = step({"inputs": xs if len(xs) > 1 else xs[0],
                           "labels": torch.from_numpy(labels[rows])})
        out.append({"loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "grads": {n: p.grad.numpy().copy()
                              for n, p in model.named_parameters()},
                    "state": _numpy_state(model)})
    return out


def _contrastive(rank, job):
    from aicity_action_tpu_torch.engine import contrastive as con
    from aicity_action_tpu_torch.engine.train_loop import wrap_ddp
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer

    cfg, lr = job["cfg"], job["lr"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(job["state"])
    momentum = con.make_momentum_model(model) if cfg.TRAIN.USE_MOCO \
        else None
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=lr),
                         lambda step: lr)
    step = con.make_contrastive_train_step(
        wrap_ddp(model, torch.device("cpu")), opt,
        use_moco=cfg.TRAIN.USE_MOCO, moco_momentum=cfg.TRAIN.MOCO_MOMENTUM,
        momentum_model=momentum)
    batch = job["batch"]
    b = batch["labels"].shape[0] // job["world"]
    rows = slice(rank * b, (rank + 1) * b)
    n_valid = int(np.clip(batch["n_valid"] - rank * b, 0, b))
    out = {"loss": [], "logit_scale": []}
    for _ in range(job["steps"]):
        metrics, _ = step({
            "inputs": torch.from_numpy(batch["inputs"][rows]),
            "tokens": torch.from_numpy(batch["tokens"][rows]),
            "labels": torch.from_numpy(batch["labels"][rows]),
            "n_valid": n_valid})
        out["loss"].append(float(metrics["loss"]))
        out["logit_scale"].append(float(metrics["logit_scale"]))
    out["params"] = {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}
    if momentum is not None:
        out["ema"] = {n: p.detach().numpy().copy()
                      for n, p in momentum.named_parameters()}
    return out


def score_cases(cases, video: str, chunk: int) -> dict:
    """Each ``(name, cfg, streaming)`` of ``cases``: the tiny model of
    ``cfg`` (weights from ``RNG_SEED``) scores ``video`` (4-frame windows
    at 32 px, batches of 3, ``chunk``-frame chunks) through
    ``WindowScorer.score_video``; returns per case the windows, the model's
    forward calls and ``last_timers``."""
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowDataset, WindowScorer)

    out = {}
    for name, cfg, streaming in cases:
        model = build_model(cfg, device="cpu")
        calls = []
        model.register_forward_hook(lambda *_: calls.append(1))
        scorer = WindowScorer(model, batch_size=3, num_workers=0,
                              chunk_frames=chunk,
                              detection=cfg.DETECTION.ENABLE)
        ds = WindowDataset(video, frame_length=4, frame_size=32)
        preds = scorer.score_video(ds, streaming=streaming)
        out[name] = {"preds": preds, "forwards": len(calls),
                     "timers": scorer.last_timers}
    return out


def _scoring(rank, job):
    return score_cases(job["cases"], job["video"], job["chunk"])


def _multihead(rank, job):
    from aicity_action_tpu_torch.engine.steps import (
        make_multihead_train_step, multihead_step_kwargs)
    from aicity_action_tpu_torch.engine.train_loop import wrap_ddp
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer

    cfg, lr = job["cfg"], job["lr"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(job["state"])
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=lr),
                         lambda step: lr)
    step = make_multihead_train_step(wrap_ddp(model, torch.device("cpu")),
                                     opt, **multihead_step_kwargs(cfg))
    batch = job["batch"]
    b = batch["labels"].shape[0] // job["world"]
    rows = slice(rank * b, (rank + 1) * b)
    n_valid = int(np.clip(batch["n_valid"] - rank * b, 0, b))
    out = {"loss": []}
    for _ in range(job["steps"]):
        metrics, _ = step({
            "inputs": torch.from_numpy(batch["inputs"][rows]),
            "labels": torch.from_numpy(batch["labels"][rows]),
            "dataset_idx": torch.from_numpy(batch["dataset_idx"][rows]),
            "n_valid": n_valid})
        out["loss"].append(float(metrics["loss"]))
    out["grads"] = {n: p.grad.numpy().copy()
                    for n, p in model.named_parameters()
                    if p.grad is not None}
    out["params"] = {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}
    return out


def _ep_moe(rank, case):
    from aicity_action_tpu_torch.parallel import ep

    m = mesh.Mesh((case["world"],), ("ep",))
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_()
    y, aux = ep.ep_moe_mlp(m, "ep", params, x, top_k=case["top_k"],
                           capacity_factor=case["cf"])
    n, b = case["world"], case["x"].shape[0] // case["world"]
    cot = torch.from_numpy(case["cot"][rank * b:(rank + 1) * b])
    ((y * cot).sum() + aux).backward()
    return {"y": y.detach().numpy(), "aux": float(aux),
            "dx": x.grad.numpy()[rank * b:(rank + 1) * b],
            "grads": {k: v.grad.numpy() for k, v in params.items()}}


def _ep_step(rank, case):
    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.parallel import ep
    from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer

    cfg, lr = case["cfg"], case["lr"]
    model = build_model(cfg, device="cpu").double()
    model.compute_dtype = torch.float64
    model.load_state_dict(case["state"])
    m = mesh.Mesh((case["world"],), ("ep",))
    sharded = ep.shard_experts(model, m, "ep")
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=lr,
                                         momentum=0.9),
                         lambda step: lr, clip_l2norm=case["clip"])
    opt.norm_fn = ep.ep_grad_norm(m, "ep", sharded)
    step = make_train_step(
        model, opt, "cross_entropy", moe_aux_weight=case["aux_weight"],
        grad_sync=lambda: ep.ep_grad_sync(model, m, "ep", sharded))
    inputs, labels = case["batch"]
    b = labels.shape[0] // case["world"]
    rows = slice(rank * b, (rank + 1) * b)
    metrics, _ = step({"inputs": torch.from_numpy(inputs[rows]),
                       "labels": torch.from_numpy(labels[rows])})
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()},
            "params": _numpy_state(model),
            "placements": ep.moe_param_placements(model, 1),
            "state": ep.ep_state_placements(opt.opt, model, sharded)}


def _tp_step(rank, case):
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.parallel import tp as ptp
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(case["state"])
    mcfg = cfg.clone()
    mcfg.TPU.MESH_SHAPE, mcfg.TPU.MESH_AXES = [1, case["world"]], [
        "data", "model"]
    m = mesh.make_mesh(mcfg)
    tp = ptp.TensorParallel(model, m)
    opt = construct_optimizer(cfg, tp, case["steps_per_epoch"])
    opt.norm_fn = tp.grad_norm
    step = ptp.make_tp_train_step(tp, opt, cfg.MODEL.LOSS_FUNC,
                                  num_classes=cfg.MODEL.NUM_CLASSES)
    inputs, labels = case["batch"]
    metrics, _ = step({"inputs": torch.from_numpy(inputs),
                       "labels": torch.from_numpy(labels)})
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {n: p.detach().numpy().copy()
                       for n, p in tp.named_parameters()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in tp.named_parameters()},
            "whole_at_rest": {n: tuple(p.shape) for n, p in tp.whole.items()},
            "state": ptp.state_placements(opt.opt, tp)}


def _half(rank, case):
    """bf16 through the collectives (they reduce it as f32): this rank's
    gather, exchange and halos of ``x``'s rows ``[rank::world]``."""
    n = case["world"]
    m = mesh.Mesh((n,), ("ax",))
    x = torch.from_numpy(case["x"][rank::n]).to(torch.bfloat16)
    above, below = mesh.halo_exchange(x, m, "ax", 0, 1, float("-inf"))
    return {k: v.float().numpy() for k, v in (
        ("gather", mesh.axis_all_gather(x, m, "ax", 0)),
        ("all_to_all", mesh.axis_all_to_all(x, m, "ax", 1, 0)),
        ("above", above), ("below", below))}


def _ep_tp(rank, job):
    out = {}
    for kind, fn in (("moe", _ep_moe), ("ep_step", _ep_step),
                     ("tp_step", _tp_step), ("half", _half)):
        if kind in job:
            out[kind] = fn(rank, dict(job[kind], world=job["world"]))
    return out


def _sp(rank, job):
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.parallel import sp, sp_model

    n = job["world"]
    m = mesh.Mesh((n,), ("sp",))
    out = {"pools": [], "models": {}}
    for mode, kernel, stride, dim, x, w in job["pools"]:
        local = torch.from_numpy(x).chunk(n, dim)[rank]
        out["pools"].append(sp.sp_pool_volume(
            local, m, "sp", mode=mode, kernel=kernel, stride=stride,
            conv_weight=None if w is None else torch.from_numpy(w),
            shard_dim=dim).numpy())
    x, params = job["attention"]
    local = torch.from_numpy(x).chunk(n, 2)[rank]
    out["attention"] = sp.sp_pooled_attention(
        local, {k: torch.from_numpy(v) for k, v in params.items()}, m, "sp",
        stride_q=1, stride_kv=4).numpy()
    for name, cfg, state, clip, shard_axis in job["models"]:
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        with torch.no_grad():
            out["models"][name] = sp_model.sp_apply(
                model, torch.from_numpy(clip), m, "sp",
                shard_axis=shard_axis).numpy()
    return out


_KINDS = {"loop": _loop, "step": _step, "contrastive": _contrastive,
          "scoring": _scoring, "multihead": _multihead, "ep_tp": _ep_tp,
          "sp": _sp}


def _rank(rank, job):
    torch.set_num_threads(1)
    cfg = {"loop": lambda: job["runs"][0][1],
           "step": lambda: job["cases"][0]["cfg"],
           "contrastive": lambda: job["cfg"],
           "scoring": lambda: job["cases"][0][1],
           "multihead": lambda: job["cfg"],
           "ep_tp": lambda: job["cfg"],
           "sp": lambda: job["models"][0][1]}[job["kind"]]()
    cfg = cfg.clone()
    cfg.NUM_SHARDS, cfg.NUM_GPUS = 1, job["world"]
    cfg.DIST_BACKEND, cfg.INIT_METHOD = "gloo", job["init_method"]
    mesh.init_distributed(cfg, rank, device="cpu")
    try:
        res = _KINDS[job["kind"]](rank, job)
    finally:
        mesh.destroy()
    with open(os.path.join(job["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def main(path):
    with open(path, "rb") as f:
        job = pickle.load(f)
    mp.spawn(_rank, args=(job,), nprocs=job["world"], join=True)


if __name__ == "__main__":
    main(sys.argv[1])
