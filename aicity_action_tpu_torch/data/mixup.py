"""Batch-level MixUp / CutMix (port of ``aicity_action_tpu/data/mixup.py``;
reference: slowfast/datasets/mixup.py).

One draw per batch: each sample is mixed with the batch-reversed sample,
and the labels become smoothed one-hot soft targets mixed by the same
lambda. The draw (:class:`MixupDraw`: whether to mix, which branch, the two
lambdas, the CutMix box centre) comes from an explicit numpy generator and
can be passed in instead, so that a test can hold the port against the JAX
package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    """Smoothed one-hot (mixup.py:convert_to_one_hot / mixup_target): int
    labels ``[B]`` or multi-hot ``[B, C]`` to f32 ``[B, C]``."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    if labels.dim() == 1:
        hot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
        return hot * (on - off) + off
    labels = labels.float()
    return labels * on + (1 - labels) * off


@dataclasses.dataclass(frozen=True)
class MixupDraw:
    """The random choices of one batch's mixing."""

    apply: bool  # mix at all (probability MIXUP.PROB)
    use_cutmix: bool  # CutMix rather than MixUp
    lam_mix: float  # MixUp lambda ~ Beta(alpha, alpha)
    lam_cut: float  # CutMix lambda before the box correction
    cy: int  # CutMix box centre, in [0, H)
    cx: int  # and [0, W)


def cutmix_box(hw: tuple[int, int], lam: float, cy: int, cx: int):
    """The CutMix box ``(yl, yh, xl, xh)`` of area ratio ``1 - lam`` around
    ``(cy, cx)``, clipped to the frame, and lambda corrected by the clipped
    area (mixup.py:get_cutmix_bbox)."""
    H, W = hw
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(H) * ratio)
    cut_w = int(np.float32(W) * ratio)
    yl = int(np.clip(cy - cut_h // 2, 0, H))
    yh = int(np.clip(cy + cut_h // 2, 0, H))
    xl = int(np.clip(cx - cut_w // 2, 0, W))
    xh = int(np.clip(cx + cut_w // 2, 0, W))
    lam_corr = 1.0 - ((yh - yl) * (xh - xl)) / float(H * W)
    return (yl, yh, xl, xh), lam_corr


def make_mixup_fn(*, num_classes: int, mixup_alpha: float = 0.8,
                  cutmix_alpha: float = 1.0, mix_prob: float = 1.0,
                  switch_prob: float = 0.5,
                  label_smoothing: float = 0.1) -> Callable:
    """Returns ``fn(inputs, labels, rng, draw=None) -> (mixed, targets)``.

    ``inputs`` is a ``[B, T, H, W, C]`` clip or a list of pathway clips (all
    mixed with the same lambda and box); ``rng`` a ``numpy.random.Generator``
    the draw comes from unless ``draw`` is given. ``fn.draw(rng, hw)`` makes
    a draw alone."""
    use_cut_branch = cutmix_alpha > 0.0
    use_mix_branch = mixup_alpha > 0.0

    def make_draw(rng: np.random.Generator,
                  hw: tuple[int, int]) -> MixupDraw:
        H, W = hw
        return MixupDraw(
            apply=bool(rng.random() < mix_prob),
            use_cutmix=(bool(rng.random() < switch_prob)
                        if use_cut_branch and use_mix_branch
                        else use_cut_branch),
            lam_mix=(float(rng.beta(mixup_alpha, mixup_alpha))
                     if use_mix_branch else 1.0),
            lam_cut=(float(rng.beta(cutmix_alpha, cutmix_alpha))
                     if use_cut_branch else 1.0),
            cy=int(rng.integers(0, H)), cx=int(rng.integers(0, W)))

    def fn(inputs, labels, rng=None, draw: MixupDraw | None = None):
        is_list = isinstance(inputs, (list, tuple))
        xs = list(inputs) if is_list else [inputs]
        hw = (xs[0].shape[-3], xs[0].shape[-2])
        d = draw if draw is not None else make_draw(rng, hw)
        (yl, yh, xl, xh), lam_cut = cutmix_box(hw, d.lam_cut, d.cy, d.cx)
        lam = lam_cut if d.use_cutmix else d.lam_mix
        if not d.apply:
            lam = 1.0
        out = []
        for x in xs:
            flipped = torch.flip(x, (0,))
            if d.apply and d.use_cutmix:
                x = x.clone()
                x[:, :, yl:yh, xl:xh] = flipped[:, :, yl:yh, xl:xh]
            else:
                x = x * lam + flipped * (1 - lam)
            out.append(x)
        t1 = one_hot_smooth(labels, num_classes, label_smoothing)
        targets = t1 * lam + torch.flip(t1, (0,)) * (1 - lam)
        return (out if is_list else out[0]), targets

    fn.draw = make_draw
    return fn


def build_mixup_from_cfg(cfg):
    if not cfg.MIXUP.ENABLE:
        return None
    return make_mixup_fn(
        num_classes=cfg.MODEL.NUM_CLASSES,
        mixup_alpha=cfg.MIXUP.ALPHA,
        cutmix_alpha=cfg.MIXUP.CUTMIX_ALPHA,
        mix_prob=cfg.MIXUP.PROB,
        switch_prob=cfg.MIXUP.SWITCH_PROB,
        label_smoothing=cfg.MIXUP.LABEL_SMOOTH_VALUE,
    )
