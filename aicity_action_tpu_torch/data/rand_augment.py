"""RandAugment for video frames (port of
``aicity_action_tpu/data/rand_augment.py``; policy strings as the
reference's vendored timm implementation, datasets/rand_augment.py).

Supports the policy grammar used by the configs (e.g.
``rand-m9-mstd0.5-inc1`` — AUG.AA_TYPE, defaults.py:116): ``m`` magnitude,
``n`` ops per image, ``mstd`` magnitude noise, ``inc`` increasing-severity
transform set, ``p`` op probability. Operates on lists of PIL images (all
frames of a clip get the SAME sampled ops/magnitudes, like the reference's
per-clip application through create_random_augment).
"""

from __future__ import annotations

import random
import re

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

_MAX_LEVEL = 10.0
_FILL = (124, 116, 104)


def _rotate(img, deg):
    return img.rotate(deg, fillcolor=_FILL)


def _shear_x(img, f):
    return img.transform(img.size, Image.AFFINE, (1, f, 0, 0, 1, 0),
                         fillcolor=_FILL)


def _shear_y(img, f):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, f, 1, 0),
                         fillcolor=_FILL)


def _translate_x(img, f):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, f * img.size[0], 0, 1, 0), fillcolor=_FILL)


def _translate_y(img, f):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, 0, 0, 1, f * img.size[1]), fillcolor=_FILL)


def _posterize(img, bits):
    return ImageOps.posterize(img, max(1, int(bits)))


def _solarize(img, thresh):
    return ImageOps.solarize(img, int(thresh))


def _solarize_add(img, add, thresh=128):
    arr = np.asarray(img).astype(np.int64)
    arr = np.where(arr < thresh, np.clip(arr + int(add), 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


# name -> (fn, level->arg mapping); "inc" variants grow severity with level
def _enhance_factor(level):
    # inc1: factor = 1 + 0.9*level/10 in a random direction
    mag = 0.9 * level / _MAX_LEVEL
    if random.random() < 0.5:
        mag = -mag
    return 1.0 + mag


_OPS_INC = {
    "AutoContrast": (lambda im, _: ImageOps.autocontrast(im), None),
    "Equalize": (lambda im, _: ImageOps.equalize(im), None),
    "Invert": (lambda im, _: ImageOps.invert(im), None),
    "Rotate": (_rotate, lambda l: (l / _MAX_LEVEL) * 30
               * (1 if random.random() < 0.5 else -1)),
    "Posterize": (_posterize, lambda l: 4 - (l / _MAX_LEVEL) * 3),
    "Solarize": (_solarize, lambda l: 256 - (l / _MAX_LEVEL) * 256),
    "SolarizeAdd": (_solarize_add, lambda l: (l / _MAX_LEVEL) * 110),
    "Color": (lambda im, f: ImageEnhance.Color(im).enhance(f),
              _enhance_factor),
    "Contrast": (lambda im, f: ImageEnhance.Contrast(im).enhance(f),
                 _enhance_factor),
    "Brightness": (lambda im, f: ImageEnhance.Brightness(im).enhance(f),
                   _enhance_factor),
    "Sharpness": (lambda im, f: ImageEnhance.Sharpness(im).enhance(f),
                  _enhance_factor),
    "ShearX": (_shear_x, lambda l: (l / _MAX_LEVEL) * 0.3
               * (1 if random.random() < 0.5 else -1)),
    "ShearY": (_shear_y, lambda l: (l / _MAX_LEVEL) * 0.3
               * (1 if random.random() < 0.5 else -1)),
    "TranslateX": (_translate_x, lambda l: (l / _MAX_LEVEL) * 0.45
                   * (1 if random.random() < 0.5 else -1)),
    "TranslateY": (_translate_y, lambda l: (l / _MAX_LEVEL) * 0.45
                   * (1 if random.random() < 0.5 else -1)),
}


class RandAugment:
    def __init__(self, num_ops=2, magnitude=9, mstd=0.5, prob=0.5):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.mstd = mstd
        self.prob = prob
        self.op_names = list(_OPS_INC)

    def __call__(self, frames: list[Image.Image]) -> list[Image.Image]:
        """Apply the SAME sampled ops to every frame of the clip."""
        chosen = [random.choice(self.op_names) for _ in range(self.num_ops)]
        plan = []
        for name in chosen:
            if random.random() > self.prob:
                continue
            level = self.magnitude
            if self.mstd > 0:
                level = random.gauss(level, self.mstd)
            level = min(max(level, 0), _MAX_LEVEL)
            fn, level_fn = _OPS_INC[name]
            arg = level_fn(level) if level_fn else None
            plan.append((fn, arg))
        out = []
        for img in frames:
            for fn, arg in plan:
                img = fn(img, arg) if arg is not None else fn(img, None)
            out.append(img)
        return out


def rand_augment_transform(config_str: str):
    """Parse a timm-style policy string → RandAugment
    (e.g. ``rand-m9-n2-mstd0.5-inc1``)."""
    assert config_str.startswith("rand"), config_str
    magnitude, num_ops, mstd, prob = 9, 2, 0.0, 0.5
    for part in config_str.split("-")[1:]:
        m = re.match(r"([a-z]+)([\d.]+)", part)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if key == "m":
            magnitude = int(val)
        elif key == "n":
            num_ops = int(val)
        elif key == "mstd":
            mstd = float(val)
        elif key == "p":
            prob = float(val)
        # "inc1" selects increasing-severity ops (the only set implemented)
    return RandAugment(num_ops=num_ops, magnitude=magnitude, mstd=mstd,
                       prob=prob)


class RandomErasing:
    """Per-frame random erasing (reference: datasets/random_erasing.py,
    timm). Operates on a float numpy clip [T, H, W, C]."""

    def __init__(self, probability=0.25, min_area=0.02, max_area=1 / 3,
                 min_aspect=0.3, mode="pixel", max_count=1):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        self.log_aspect = (np.log(min_aspect), np.log(1 / min_aspect))
        self.mode = mode
        self.max_count = max_count

    def __call__(self, clip: np.ndarray,
                 rng: random.Random | None = None) -> np.ndarray:
        r = rng or random
        if r.random() > self.probability:
            return clip
        T, H, W, C = clip.shape
        out = clip.copy()
        count = r.randint(1, self.max_count)
        for _ in range(count):
            for _attempt in range(10):
                area = H * W * r.uniform(self.min_area, self.max_area) / count
                aspect = np.exp(r.uniform(*self.log_aspect))
                h = int(round(np.sqrt(area * aspect)))
                w = int(round(np.sqrt(area / aspect)))
                if h < H and w < W:
                    y = r.randint(0, H - h)
                    x = r.randint(0, W - w)
                    if self.mode == "pixel":
                        noise = np.random.randn(h, w, C).astype(clip.dtype)
                        out[:, y:y + h, x:x + w] = noise
                    else:
                        out[:, y:y + h, x:x + w] = 0
                    break
        return out
