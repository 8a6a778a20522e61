"""Host-side (numpy/cv2) image + box transform surface (port of
``aicity_action_tpu/data/cv2_transform.py``; cv2 is imported in the
functions that resize or flip with it).

Drop-in behavioral equivalent of the reference's
``slowfast/datasets/cv2_transform.py`` (797 LoC, reference lines cited per
function). Only the AVA keyframe path uses these in-tree (``data/ava.py``
inlines its subset), but the full surface is public API for anyone porting
reference preprocessing code, so every function is provided with identical
semantics — including the ``np.random`` draw ORDER, so seeded pipelines
reproduce bit-identically (tests/test_cv2_transform.py asserts this against
the reference module directly).

Implementation notes (ours, not the reference's):
- list ops stack to one ndarray and run a single vectorized numpy op where
  the math allows (flip, blend, normalization); ``cv2.resize`` stays
  per-image (cv2 has no batched resize).
- box helpers return NEW arrays; the reference mutates its inputs in place
  and returns them. Call sites that use the return value (all of them in
  the reference tree) behave identically.
- images are float32 HWC-BGR unless a function takes ``order=``; grayscale
  coefficients index BGR like the reference (B=channel 0).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "clip_boxes_to_image", "random_short_side_scale_jitter_list", "scale",
    "scale_boxes", "horizontal_flip_list", "spatial_shift_crop_list",
    "CHW2HWC", "HWC2CHW", "color_jitter_list", "lighting_list",
    "color_normalization", "pad_image", "horizontal_flip", "flip_boxes",
    "crop_boxes", "random_crop_list", "center_crop", "random_scale_jitter",
    "random_scale_jitter_list", "random_sized_crop", "lighting",
    "random_sized_crop_list", "blend", "grayscale", "saturation",
    "brightness", "contrast", "saturation_list", "brightness_list",
    "contrast_list", "color_jitter", "revert_scaled_boxes",
]


# ---------------------------------------------------------------- boxes

def clip_boxes_to_image(boxes, height, width):
    """Clamp [x1 y1 x2 y2] boxes into the image (ref cv2_transform.py:9)."""
    out = np.asarray(boxes).copy()
    out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0.0, width - 1.0)
    out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0.0, height - 1.0)
    return out


def flip_boxes(boxes, im_width):
    """Mirror boxes horizontally (ref cv2_transform.py:365)."""
    out = np.asarray(boxes).copy()
    out[:, 0::4] = im_width - boxes[:, 2::4] - 1
    out[:, 2::4] = im_width - boxes[:, 0::4] - 1
    return out


def crop_boxes(boxes, x_offset, y_offset):
    """Shift boxes into crop coordinates (ref cv2_transform.py:381)."""
    out = np.asarray(boxes).copy()
    out[:, [0, 2]] -= x_offset
    out[:, [1, 3]] -= y_offset
    return out


def scale_boxes(size, boxes, height, width):
    """Scale boxes by the short-side-to-``size`` ratio
    (ref cv2_transform.py:106)."""
    if (width <= height and width == size) or (
            height <= width and height == size):
        return boxes
    if width < height:
        new_height = int(math.floor((float(height) / width) * size))
        return boxes * (float(new_height) / height)
    new_width = int(math.floor((float(width) / height) * size))
    return boxes * (float(new_width) / width)


def revert_scaled_boxes(size, boxes, img_height, img_width):
    """Map boxes from the scaled image back to original pixels
    (ref cv2_transform.py:783)."""
    return boxes * (np.min([img_height, img_width]) / size)


# ---------------------------------------------------------------- layout

def CHW2HWC(image):
    """(ref cv2_transform.py:216)"""
    return image.transpose([1, 2, 0])


def HWC2CHW(image):
    """(ref cv2_transform.py:228)"""
    return image.transpose([2, 0, 1])


def pad_image(image, pad_size, order="CHW"):
    """Zero-pad H and W by ``pad_size`` (ref cv2_transform.py:319)."""
    if order == "CHW":
        pads = ((0, 0), (pad_size, pad_size), (pad_size, pad_size))
    else:
        pads = ((pad_size, pad_size), (pad_size, pad_size), (0, 0))
    return np.pad(image, pads, mode="constant")


# ---------------------------------------------------------------- scaling

def _short_side_dims(height, width, size):
    """New (h, w) with the short side at ``size``; None if already there."""
    if (width <= height and width == size) or (
            height <= width and height == size):
        return None
    if width < height:
        return int(math.floor((float(height) / width) * size)), size
    return size, int(math.floor((float(width) / height) * size))


def scale(size, image):
    """Short-side scale one HWC image, INTER_LINEAR
    (ref cv2_transform.py:77)."""
    import cv2

    dims = _short_side_dims(image.shape[0], image.shape[1], size)
    if dims is None:
        return image
    new_h, new_w = dims
    return cv2.resize(image, (new_w, new_h),
                      interpolation=cv2.INTER_LINEAR).astype(np.float32)


def random_short_side_scale_jitter_list(images, min_size, max_size,
                                        boxes=None):
    """Inverse-uniform short-side jitter over a clip
    (ref cv2_transform.py:29). One scale drawn for the whole list."""
    import cv2

    size = int(round(1.0 / np.random.uniform(1.0 / max_size, 1.0 / min_size)))
    height, width = images[0].shape[0], images[0].shape[1]
    dims = _short_side_dims(height, width, size)
    if dims is None:
        return images, boxes
    new_h, new_w = dims
    if boxes is not None:
        ratio = (float(new_h) / height) if width < height \
            else (float(new_w) / width)
        boxes = [proposal * ratio for proposal in boxes]
    return [
        cv2.resize(im, (new_w, new_h),
                   interpolation=cv2.INTER_LINEAR).astype(np.float32)
        for im in images
    ], boxes


def random_scale_jitter(image, min_size, max_size):
    """ResNet-style inverse-uniform scale jitter (ref cv2_transform.py:477)."""
    img_scale = int(
        round(1.0 / np.random.uniform(1.0 / max_size, 1.0 / min_size)))
    return scale(img_scale, image)


def random_scale_jitter_list(images, min_size, max_size):
    """Shared-scale jitter over a list (ref cv2_transform.py:495)."""
    img_scale = int(
        round(1.0 / np.random.uniform(1.0 / max_size, 1.0 / min_size)))
    return [scale(img_scale, image) for image in images]


# ---------------------------------------------------------------- cropping

def center_crop(size, image):
    """Center crop an HWC image (ref cv2_transform.py:458)."""
    height, width = image.shape[0], image.shape[1]
    y0 = int(math.ceil((height - size) / 2))
    x0 = int(math.ceil((width - size) / 2))
    cropped = image[y0:y0 + size, x0:x0 + size, :]
    assert cropped.shape[0] == size and cropped.shape[1] == size
    return cropped


def spatial_shift_crop_list(size, images, spatial_shift_pos, boxes=None):
    """Left/center/right (or top/center/bottom) crop of a clip
    (ref cv2_transform.py:166)."""
    assert spatial_shift_pos in [0, 1, 2]
    height, width = images[0].shape[0], images[0].shape[1]
    y0 = int(math.ceil((height - size) / 2))
    x0 = int(math.ceil((width - size) / 2))
    if height > width:
        if spatial_shift_pos == 0:
            y0 = 0
        elif spatial_shift_pos == 2:
            y0 = height - size
    else:
        if spatial_shift_pos == 0:
            x0 = 0
        elif spatial_shift_pos == 2:
            x0 = width - size
    cropped = [im[y0:y0 + size, x0:x0 + size, :] for im in images]
    assert cropped[0].shape[0] == size and cropped[0].shape[1] == size
    if boxes is not None:
        boxes = [crop_boxes(b, x0, y0) for b in boxes]
    return cropped, boxes


def random_crop_list(images, size, pad_size=0, order="CHW", boxes=None):
    """Shared random crop over a clip, optional pre-pad
    (ref cv2_transform.py:394). Draw order: y then x, each only when the
    axis is larger than ``size``."""
    if pad_size > 0:
        images = [pad_image(im, pad_size, order=order) for im in images]
    hw_axes = (1, 2) if order == "CHW" else (0, 1)
    height = images[0].shape[hw_axes[0]]
    width = images[0].shape[hw_axes[1]]
    if height == size and width == size:
        return images, boxes
    y0 = int(np.random.randint(0, height - size)) if height > size else 0
    x0 = int(np.random.randint(0, width - size)) if width > size else 0
    if order == "CHW":
        cropped = [im[:, y0:y0 + size, x0:x0 + size] for im in images]
    else:
        cropped = [im[y0:y0 + size, x0:x0 + size, :] for im in images]
    if boxes is not None:
        boxes = [crop_boxes(b, x0, y0) for b in boxes]
    return cropped, boxes


def _try_inception_geometry(height, width, area_frac):
    """One Inception-crop attempt; returns (y0, x0, h, w) or None.

    Matches the reference's draw order exactly: area, aspect, maybe-swap,
    then y/x randints gated on exact-fit (ref cv2_transform.py:524-544)."""
    area = height * width
    target_area = np.random.uniform(area_frac, 1.0) * area
    aspect_ratio = np.random.uniform(3.0 / 4.0, 4.0 / 3.0)
    w = int(round(math.sqrt(float(target_area) * aspect_ratio)))
    h = int(round(math.sqrt(float(target_area) / aspect_ratio)))
    if np.random.uniform() < 0.5:
        w, h = h, w
    if h <= height and w <= width:
        y0 = 0 if height == h else int(np.random.randint(0, height - h))
        x0 = 0 if width == w else int(np.random.randint(0, width - w))
        return y0, x0, h, w
    return None


def random_sized_crop(image, size, area_frac=0.08):
    """Inception-style random sized crop of one image
    (ref cv2_transform.py:513)."""
    import cv2

    for _ in range(10):
        geom = _try_inception_geometry(image.shape[0], image.shape[1],
                                       area_frac)
        if geom is not None:
            y0, x0, h, w = geom
            cropped = image[y0:y0 + h, x0:x0 + w, :]
            return cv2.resize(cropped, (size, size),
                              interpolation=cv2.INTER_LINEAR
                              ).astype(np.float32)
    return center_crop(size, scale(size, image))


def random_sized_crop_list(images, size, crop_area_fraction=0.08):
    """Shared Inception-style crop over a clip (ref cv2_transform.py:582)."""
    import cv2

    for _ in range(10):
        geom = _try_inception_geometry(images[0].shape[0], images[0].shape[1],
                                       crop_area_fraction)
        if geom is not None:
            y0, x0, h, w = geom
            return [
                cv2.resize(im[y0:y0 + h, x0:x0 + w, :], (size, size),
                           interpolation=cv2.INTER_LINEAR).astype(np.float32)
                for im in images
            ]
    return [center_crop(size, scale(size, image)) for image in images]


# ---------------------------------------------------------------- flipping

def horizontal_flip(prob, image, order="CHW"):
    """Flip one image with probability ``prob`` (ref cv2_transform.py:344)."""
    assert order in ["CHW", "HWC"], f"order {order} is not supported"
    if np.random.uniform() < prob:
        image = image[:, :, ::-1] if order == "CHW" else image[:, ::-1, :]
    return image


def horizontal_flip_list(prob, images, order="CHW", boxes=None):
    """Flip a clip (shared coin) and its boxes (ref cv2_transform.py:134)."""
    import cv2

    width = images[0].shape[1]
    if np.random.uniform() < prob:
        if boxes is not None:
            boxes = [flip_boxes(b, width) for b in boxes]
        if order == "CHW":
            return [im[:, :, ::-1] for im in images], boxes
        elif order == "HWC":
            return [cv2.flip(im, 1) for im in images], boxes
    return images, boxes


# ---------------------------------------------------------------- color

def blend(image1, image2, alpha):
    """(ref cv2_transform.py:632)"""
    return image1 * alpha + image2 * (1 - alpha)


def grayscale(image):
    """CHW BGR -> 3-channel gray (Rec.601 weights)
    (ref cv2_transform.py:636)."""
    gray = 0.299 * image[2] + 0.587 * image[1] + 0.114 * image[0]
    return np.broadcast_to(gray, image.shape).astype(image.dtype).copy()


def saturation(var, image):
    """(ref cv2_transform.py:654)"""
    img_gray = grayscale(image)
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(image, img_gray, alpha)


def brightness(var, image):
    """(ref cv2_transform.py:668)"""
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(image, np.zeros_like(image), alpha)


def contrast(var, image):
    """Blend toward the mean gray level (ref cv2_transform.py:682)."""
    img_gray = grayscale(image)
    img_gray[:] = np.mean(img_gray[0])
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(image, img_gray, alpha)


def saturation_list(var, images):
    """Shared-alpha saturation over a clip (ref cv2_transform.py:697)."""
    alpha = 1.0 + np.random.uniform(-var, var)
    return [blend(im, grayscale(im), alpha) for im in images]


def brightness_list(var, images):
    """Shared-alpha brightness over a clip (ref cv2_transform.py:715)."""
    alpha = 1.0 + np.random.uniform(-var, var)
    return [blend(im, np.zeros_like(im), alpha) for im in images]


def contrast_list(var, images):
    """Shared-alpha contrast over a clip (ref cv2_transform.py:733)."""
    alpha = 1.0 + np.random.uniform(-var, var)
    out = []
    for im in images:
        img_gray = grayscale(im)
        img_gray[:] = np.mean(img_gray[0])
        out.append(blend(im, img_gray, alpha))
    return out


def _jitter_ops(img_brightness, img_contrast, img_saturation):
    ops = []
    if img_brightness != 0:
        ops.append("brightness")
    if img_contrast != 0:
        ops.append("contrast")
    if img_saturation != 0:
        ops.append("saturation")
    return ops


def color_jitter(image, img_brightness=0, img_contrast=0, img_saturation=0):
    """Randomly-ordered brightness/contrast/saturation
    (ref cv2_transform.py:752)."""
    ops = _jitter_ops(img_brightness, img_contrast, img_saturation)
    if ops:
        order = np.random.permutation(np.arange(len(ops)))
        for idx in range(len(ops)):
            op = ops[order[idx]]
            if op == "brightness":
                image = brightness(img_brightness, image)
            elif op == "contrast":
                image = contrast(img_contrast, image)
            elif op == "saturation":
                image = saturation(img_saturation, image)
    return image


def color_jitter_list(images, img_brightness=0, img_contrast=0,
                      img_saturation=0):
    """Clip version of :func:`color_jitter` (ref cv2_transform.py:240)."""
    ops = _jitter_ops(img_brightness, img_contrast, img_saturation)
    if ops:
        order = np.random.permutation(np.arange(len(ops)))
        for idx in range(len(ops)):
            op = ops[order[idx]]
            if op == "brightness":
                images = brightness_list(img_brightness, images)
            elif op == "contrast":
                images = contrast_list(img_contrast, images)
            elif op == "saturation":
                images = saturation_list(img_saturation, images)
    return images


def _pca_rgb_shift(alphastd, eigval, eigvec):
    """Per-channel additive shift for AlexNet PCA lighting."""
    alpha = np.random.normal(0, alphastd, size=(1, 3))
    eig_vec = np.array(eigvec)
    eig_val = np.reshape(eigval, (1, 3))
    return np.sum(eig_vec * np.repeat(alpha, 3, axis=0)
                  * np.repeat(eig_val, 3, axis=0), axis=1)


def lighting(img, alphastd, eigval, eigvec):
    """AlexNet PCA jitter, CHW BGR (rgb[2-idx] indexing matches the
    reference's BGR layout) (ref cv2_transform.py:556)."""
    if alphastd == 0:
        return img
    rgb = _pca_rgb_shift(alphastd, eigval, eigvec)
    return img + rgb[::-1].reshape(3, 1, 1).astype(img.dtype)


def lighting_list(imgs, alphastd, eigval, eigvec, alpha=None):
    """Shared-draw PCA jitter over a clip (ref cv2_transform.py:273).
    ``alpha`` is accepted-and-ignored exactly like the reference."""
    if alphastd == 0:
        return imgs
    rgb = _pca_rgb_shift(alphastd, eigval, eigvec)
    shift = rgb[::-1].reshape(3, 1, 1)
    return [img + shift.astype(img.dtype) for img in imgs]


def color_normalization(image, mean, stddev):
    """Per-channel (x - mean) / std, CHW (ref cv2_transform.py:302)."""
    assert len(mean) == image.shape[0], "channel mean not computed properly"
    assert len(stddev) == image.shape[0], \
        "channel stddev not computed properly"
    mean = np.asarray(mean, dtype=image.dtype).reshape(-1, 1, 1)
    stddev = np.asarray(stddev, dtype=image.dtype).reshape(-1, 1, 1)
    return (image - mean) / stddev
