"""The port's ``data/cv2_transform.py`` and ``data/frame_datasets.py``
against the JAX package's modules, on the CPU: every public transform
under the same ``np.random`` seed (outputs equal), and the val and test
items of Ssv2 (video files), Charades (frame lists, video-level multi-hot
labels), Ssv2_frames (the official json pair) and Imagenet (a class tree)
equal on data written in code."""

import json
import os

import numpy as np
import pytest

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.data import cv2_transform as jct
from aicity_action_tpu.data import frame_datasets as jfd
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data import cv2_transform as tct
from aicity_action_tpu_torch.data import frame_datasets as tfd
from aicity_action_tpu_torch.data.datasets import build_dataset
from torch_port_helpers import write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

_RNG = np.random.default_rng(0)
HWC = [_RNG.uniform(0, 255, (20, 30, 3)).astype(np.float32)
       for _ in range(3)]
CHW = [np.ascontiguousarray(im.transpose(2, 0, 1)) for im in HWC]
BOXES = np.array([[2.0, 3.0, 17.0, 15.0], [0.0, 0.0, 29.0, 19.0]],
                 np.float32)
EIGVAL = [0.2175, 0.0188, 0.0045]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]

CALLS = {
    "clip_boxes_to_image": lambda m: m.clip_boxes_to_image(
        BOXES + 5, 20, 30),
    "flip_boxes": lambda m: m.flip_boxes(BOXES, 30),
    "crop_boxes": lambda m: m.crop_boxes(BOXES, 3, 4),
    "scale_boxes": lambda m: m.scale_boxes(16, BOXES, 20, 30),
    "revert_scaled_boxes": lambda m: m.revert_scaled_boxes(16, BOXES, 20,
                                                           30),
    "CHW2HWC": lambda m: m.CHW2HWC(CHW[0]),
    "HWC2CHW": lambda m: m.HWC2CHW(HWC[0]),
    "pad_image": lambda m: m.pad_image(CHW[0], 2),
    "scale": lambda m: m.scale(16, HWC[0]),
    "random_short_side_scale_jitter_list": lambda m:
        m.random_short_side_scale_jitter_list(HWC, 16, 24, boxes=BOXES),
    "random_scale_jitter": lambda m: m.random_scale_jitter(HWC[0], 16, 24),
    "random_scale_jitter_list": lambda m: m.random_scale_jitter_list(
        HWC, 16, 24),
    "center_crop": lambda m: m.center_crop(12, HWC[0]),
    "spatial_shift_crop_list": lambda m: [
        m.spatial_shift_crop_list(12, HWC, p, boxes=[BOXES])
        for p in (0, 1, 2)],
    "random_crop_list": lambda m: (
        m.random_crop_list(CHW, 12, pad_size=2, order="CHW",
                           boxes=[BOXES]),
        m.random_crop_list(HWC, 12, order="HWC", boxes=[BOXES])),
    "random_sized_crop": lambda m: m.random_sized_crop(HWC[0], 12),
    "random_sized_crop_list": lambda m: m.random_sized_crop_list(HWC, 12),
    "horizontal_flip": lambda m: m.horizontal_flip(1.0, CHW[0]),
    "horizontal_flip_list": lambda m: (
        m.horizontal_flip_list(1.0, CHW, boxes=[BOXES]),
        m.horizontal_flip_list(1.0, HWC, order="HWC", boxes=[BOXES])),
    "blend": lambda m: m.blend(CHW[0], CHW[1], 0.3),
    "grayscale": lambda m: m.grayscale(CHW[0]),
    "saturation": lambda m: m.saturation(0.4, CHW[0]),
    "brightness": lambda m: m.brightness(0.4, CHW[0]),
    "contrast": lambda m: m.contrast(0.4, CHW[0]),
    "saturation_list": lambda m: m.saturation_list(0.4, CHW),
    "brightness_list": lambda m: m.brightness_list(0.4, CHW),
    "contrast_list": lambda m: m.contrast_list(0.4, CHW),
    "color_jitter": lambda m: m.color_jitter(CHW[0], 0.4, 0.4, 0.4),
    "color_jitter_list": lambda m: m.color_jitter_list(CHW, 0.4, 0.4, 0.4),
    "lighting": lambda m: m.lighting(CHW[0], 0.1, EIGVAL, EIGVEC),
    "lighting_list": lambda m: m.lighting_list(CHW, 0.1, EIGVAL, EIGVEC),
    "color_normalization": lambda m: m.color_normalization(
        CHW[0], [0.45] * 3, [0.225] * 3),
}


def _assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_the_table_covers_every_public_transform():
    assert set(CALLS) == set(jct.__all__) == set(tct.__all__)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cv2_transform_matches_jax(name):
    np.random.seed(7)
    want = CALLS[name](jct)
    np.random.seed(7)
    got = CALLS[name](tct)
    _assert_same(got, want)


def _write_frames(root, video, n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    os.makedirs(os.path.join(root, video), exist_ok=True)
    for i in range(n):
        name = f"{video}/{i:05d}.jpg"
        cv2.imwrite(os.path.join(root, name),
                    rng.integers(0, 256, (36, 48, 3), np.uint8))
        rows.append((video, i, name))
    return rows


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Video files (Ssv2), frame lists with per-frame labels (Charades), the
    Something-Something json pair (Ssv2_frames) and a class tree of
    images (Imagenet), under one directory."""
    d = str(tmp_path_factory.mktemp("frames"))
    rows = _write_frames(d, "v1", 12, 1) + _write_frames(d, "v2", 9, 2)
    for split in ("train", "val", "test"):
        with open(os.path.join(d, f"{split}.csv"), "w") as f:
            f.write("original_vido_id video_id frame_id path labels\n")
            for vid, i, name in rows:
                labels = f"{i % 3},{(i + 1) % 5}" if vid == "v1" else ""
                f.write(f"{vid} 0 {i} {name} \"{labels}\"\n")
    with open(os.path.join(d, "something-something-v2-labels.json"),
              "w") as f:
        json.dump({"Pushing something": "0", "Lifting something": "1"}, f)
    for split in ("train", "validation"):
        with open(os.path.join(d, f"something-something-v2-{split}.json"),
                  "w") as f:
            json.dump([{"id": "v1", "template": "Pushing [something]"},
                       {"id": "v2", "template": "Lifting [something]"}], f)
    os.makedirs(os.path.join(d, "videos"))
    for k in range(2):
        write_mp4(os.path.join(d, "videos", f"c{k}.mp4"), num_frames=20 + k,
                  size=(48, 36), seed=k)
    return d


def _cfg(get, root, name):
    cfg = get()
    cfg.DATA.PATH_TO_DATA_DIR = root
    cfg.DATA.PATH_PREFIX = root
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 40]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.MODEL.NUM_CLASSES = 5
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    if name == "Ssv2":
        cfg.DATA.PATH_TO_DATA_DIR = os.path.join(root, "ssv2")
        cfg.DATA.PATH_PREFIX = os.path.join(root, "videos")
    if name == "Imagenet":
        cfg.DATA.PATH_TO_DATA_DIR = os.path.join(root, "imagenet")
    return cfg


@pytest.fixture(scope="module")
def lists(data_root):
    """The Ssv2 video csvs and the Imagenet class tree."""
    os.makedirs(os.path.join(data_root, "ssv2"), exist_ok=True)
    for split in ("train", "val", "test"):
        with open(os.path.join(data_root, "ssv2", f"{split}.csv"), "w") as f:
            f.write("c0.mp4 1\nc1.mp4 0\n")
    rng = np.random.default_rng(3)
    for split in ("val", "test"):
        for cls in ("n01", "n02"):
            p = os.path.join(data_root, "imagenet", split, cls)
            os.makedirs(p, exist_ok=True)
            for k in range(2):
                cv2.imwrite(os.path.join(p, f"{k}.jpg"),
                            rng.integers(0, 256, (40, 50, 3), np.uint8))
    return data_root


@pytest.mark.parametrize("name,cls", [
    ("Ssv2", "Ssv2"), ("Charades", "Charades"),
    ("Ssv2_frames", "Ssv2Frames"), ("Imagenet", "Imagenet")])
@pytest.mark.parametrize("mode", ["val", "test"])
def test_frame_dataset_items_equal_jax(lists, name, cls, mode):
    ds = build_dataset(name, _cfg(get_cfg, lists, name), mode)
    assert type(ds) is getattr(tfd, cls)
    ref = getattr(jfd, cls)(_cfg(jax_get_cfg, lists, name), mode)
    assert len(ds) == len(ref) > 0 and ds.num_videos == ref.num_videos
    for i in range(len(ds)):
        (gx, gl, gi, gm), (wx, wl, wi, wm) = ds[i], ref[i]
        assert gi == wi and gm == wm == {} and len(gx) == len(wx)
        for a, b in zip(gx, wx):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gl, wl)


def test_multi_dataset_seq_still_raises(lists):
    """Multi_dataset_seq no longer raises: it is ported. Two Ssv2 datasets
    of the frame lists, one after the other, equal the JAX package's."""
    cfgs = [_cfg(get, lists, "Ssv2") for get in (get_cfg, jax_get_cfg)]
    for cfg in cfgs:
        cfg.MODEL.MULTI_DATASETS = ["ssv2", "ssv2"]
        cfg.MODEL.MULTI_NUM_CLASSES = [5, 3]
    ds = build_dataset("multi_dataset_seq", cfgs[0], "val")
    ref = jfd.MultiDatasetSeq(cfgs[1], "val")
    assert type(ds) is tfd.MultiDatasetSeq and len(ds) == len(ref) == 4
    xs, y, i, meta = ds[3]
    rxs, ry, ri, rmeta = ref[3]
    assert len(xs) == len(rxs)
    for x, rx in zip(xs, rxs):
        np.testing.assert_allclose(x, rx, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y, ry)
    assert i == ri == 3 and meta == rmeta == {"dataset_idx": 1}
