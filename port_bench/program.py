"""What the benchmark takes from the program under test,
``aicity_action_tpu_torch``: its configuration, its model with the
benchmark's weights loaded, and its window scorer and train step, which
the drivers call as a user would. Imported by the drivers only, so that
the reference and the arithmetic never load the program.
"""

from __future__ import annotations

import torch


def port_cfg(config: dict):
    """The port's config: the function of its ``config.defaults`` that the
    file names under ``defaults``, with the file's ``cfg`` table merged
    over it (the file is what runs)."""
    from aicity_action_tpu_torch.config import CfgNode, defaults

    cfg = getattr(defaults, config["defaults"])()
    cfg.merge_from_other_cfg(CfgNode(config["cfg"]))
    return cfg


def port_model(cfg, params: dict, device) -> torch.nn.Module:
    """The port's ``MViT`` for ``cfg`` on ``device``, made without
    initialising (``meta``), holding ``params`` (every parameter by name;
    a missing or extra one raises)."""
    from aicity_action_tpu_torch.device import compute_dtype
    from aicity_action_tpu_torch.models.mvit import MViT, build_mvit_spec

    with torch.device("meta"):
        model = MViT(build_mvit_spec(cfg), compute_dtype(cfg.TPU.COMPUTE_DTYPE))
    model = model.to_empty(device=device)
    model.load_state_dict(params, strict=True)
    return model
