"""Host-side video transforms in numpy and cv2 (port of
``aicity_action_tpu/data/transform.py``; reference: datasets/transform.py
and datasets/utils.py).

Frames are uint8 RGB ``[T, H, W, C]`` until normalization, which gives
float32 channels-last, the model's input layout. Random draws come from the
caller's ``random.Random`` (the module's ``random`` where none is given) in
the JAX package's order, so a seeded draw crops and flips the same. ``cv2``
is imported only where a frame is resized.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

import numpy as np


def random_short_side_scale_jitter(
    frames: np.ndarray,
    min_size: int,
    max_size: int,
    inverse_uniform_sampling: bool = False,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Scale so the short side equals a random size in [min, max]
    (reference: transform.py:41-96)."""
    r = rng or random
    if inverse_uniform_sampling:
        size = int(round(1.0 / r.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(r.uniform(min_size, max_size)))
    return short_side_scale(frames, size)


def short_side_scale(frames: np.ndarray, size: int) -> np.ndarray:
    import cv2

    t, h, w = frames.shape[:3]
    if (w <= h and w == size) or (h <= w and h == size):
        return frames
    if w < h:
        new_w, new_h = size, int(math.floor(h / w * size))
    else:
        new_w, new_h = int(math.floor(w / h * size)), size
    out = np.empty((t, new_h, new_w, frames.shape[3]), dtype=frames.dtype)
    for i in range(t):
        out[i] = cv2.resize(frames[i], (new_w, new_h),
                            interpolation=cv2.INTER_LINEAR)
    return out


def random_crop(
    frames: np.ndarray, size: int, rng: Optional[random.Random] = None
) -> np.ndarray:
    """Random spatial crop (reference: transform.py:117-160)."""
    r = rng or random
    h, w = frames.shape[1:3]
    if h == size and w == size:
        return frames
    y = r.randint(0, max(h - size, 0)) if h > size else 0
    x = r.randint(0, max(w - size, 0)) if w > size else 0
    return frames[:, y:y + size, x:x + size, :]


def uniform_crop(frames: np.ndarray, size: int, spatial_idx: int) -> np.ndarray:
    """Deterministic left/center/right (or top/center/bottom) crop
    (reference: transform.py:200-250)."""
    assert spatial_idx in (0, 1, 2)
    h, w = frames.shape[1:3]
    y = int(math.ceil((h - size) / 2))
    x = int(math.ceil((w - size) / 2))
    if h > w:
        y = 0 if spatial_idx == 0 else (h - size if spatial_idx == 2 else y)
    else:
        x = 0 if spatial_idx == 0 else (w - size if spatial_idx == 2 else x)
    return frames[:, y:y + size, x:x + size, :]


def horizontal_flip(
    prob: float, frames: np.ndarray, rng: Optional[random.Random] = None
) -> np.ndarray:
    r = rng or random
    if r.random() < prob:
        return frames[:, :, ::-1, :]
    return frames


def random_resized_crop(
    frames: np.ndarray,
    target_height: int,
    target_width: int,
    scale: Sequence[float] = (0.08, 1.0),
    ratio: Sequence[float] = (3.0 / 4.0, 4.0 / 3.0),
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Inception-style crop (reference: transform.py:538-589)."""
    import cv2

    r = rng or random
    t, height, width = frames.shape[:3]
    area = height * width
    for _ in range(10):
        target_area = area * r.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(r.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            x = r.randint(0, width - w)
            y = r.randint(0, height - h)
            crop = frames[:, y:y + h, x:x + w, :]
            break
    else:  # fallback: center crop at clamped aspect
        in_ratio = width / height
        if in_ratio < ratio[0]:
            w, h = width, int(round(width / ratio[0]))
        elif in_ratio > ratio[1]:
            h, w = height, int(round(height * ratio[1]))
        else:
            w, h = width, height
        x, y = (width - w) // 2, (height - h) // 2
        crop = frames[:, y:y + h, x:x + w, :]
    out = np.empty((t, target_height, target_width, frames.shape[3]),
                   dtype=frames.dtype)
    for i in range(t):
        out[i] = cv2.resize(crop[i], (target_width, target_height),
                            interpolation=cv2.INTER_LINEAR)
    return out


def color_jitter(
    frames: np.ndarray,
    img_brightness: float = 0,
    img_contrast: float = 0,
    img_saturation: float = 0,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Randomly-ordered brightness/contrast/saturation jitter on float
    frames [T, H, W, C] in [0, 1] (reference: transform.py:311-410)."""
    r = rng or random
    jitter = []
    if img_brightness != 0:
        jitter.append("brightness")
    if img_contrast != 0:
        jitter.append("contrast")
    if img_saturation != 0:
        jitter.append("saturation")
    order = list(np.random.permutation(len(jitter))) if jitter else []
    out = frames.astype(np.float32)
    for idx in order:
        kind = jitter[idx]
        if kind == "brightness":
            alpha = 1.0 + r.uniform(-img_brightness, img_brightness)
            out = out * alpha
        elif kind == "contrast":
            alpha = 1.0 + r.uniform(-img_contrast, img_contrast)
            gray_mean = (0.299 * out[..., 0] + 0.587 * out[..., 1]
                         + 0.114 * out[..., 2]).mean()
            out = out * alpha + gray_mean * (1 - alpha)
        elif kind == "saturation":
            alpha = 1.0 + r.uniform(-img_saturation, img_saturation)
            gray = (0.299 * out[..., 0] + 0.587 * out[..., 1]
                    + 0.114 * out[..., 2])[..., None]
            out = out * alpha + gray * (1 - alpha)
    return out


def lighting_jitter(
    frames: np.ndarray,
    alphastd: float,
    eigval,
    eigvec,
) -> np.ndarray:
    """AlexNet-style PCA lighting noise (reference: transform.py:412-451)."""
    if alphastd == 0:
        return frames
    alpha = np.random.normal(0, alphastd, size=3)
    rgb = (np.asarray(eigvec) * alpha * np.asarray(eigval)).sum(axis=1)
    return frames + rgb.astype(frames.dtype)


def tensor_normalize(
    frames: np.ndarray, mean: Sequence[float], std: Sequence[float]
) -> np.ndarray:
    """uint8 [0,255] → float32 normalized (reference: utils.py:277-295)."""
    x = frames.astype(np.float32) / 255.0
    x -= np.asarray(mean, np.float32)
    x /= np.asarray(std, np.float32)
    return x


def spatial_sampling(
    frames: np.ndarray,
    spatial_idx: int = -1,
    min_scale: int = 256,
    max_scale: int = 320,
    crop_size: int = 224,
    random_horizontal_flip: bool = True,
    inverse_uniform_sampling: bool = False,
    aspect_ratio: Optional[Sequence[float]] = None,
    scale: Optional[Sequence[float]] = None,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Train/test spatial sampling dispatch (reference: utils.py:111-182)."""
    assert spatial_idx in (-1, 0, 1, 2)
    if spatial_idx == -1:
        if aspect_ratio is None and scale is None:
            frames = random_short_side_scale_jitter(
                frames, min_scale, max_scale, inverse_uniform_sampling, rng
            )
            frames = random_crop(frames, crop_size, rng)
        else:
            frames = random_resized_crop(
                frames, crop_size, crop_size, scale=scale,
                ratio=aspect_ratio, rng=rng,
            )
        if random_horizontal_flip:
            frames = horizontal_flip(0.5, frames, rng)
    else:
        assert min_scale == max_scale
        frames = short_side_scale(frames, min_scale)
        frames = uniform_crop(frames, crop_size, spatial_idx)
    return np.ascontiguousarray(frames)


def pack_pathway_output(frames: np.ndarray, arch_pathways: int, alpha: int):
    """Split into SlowFast pathways (reference: utils.py:75-108).

    ``frames``: ``[T, H, W, C]``. Returns list of pathway tensors.
    """
    if arch_pathways == 1:
        return [frames]
    fast = frames
    t = frames.shape[0]
    # reference uses linspace (endpoints included), not stride-alpha slicing
    idx = np.linspace(0, t - 1, t // alpha).astype(np.int64)
    slow = frames[idx]
    return [slow, fast]
