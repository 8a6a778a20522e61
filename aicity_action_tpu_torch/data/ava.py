"""AVA spatio-temporal action detection dataset (port of
``aicity_action_tpu/data/ava.py``; reference: datasets/ava_dataset.py and
ava_helper.py): keyframe-centric clips from extracted frame images, with
each keyframe's person boxes and multi-hot action labels.

Each item carries a fixed slab of ``Ava.MAX_BOXES`` boxes and a validity
mask, as in the JAX package (the reference's collate concatenates a
variable number of boxes a batch, loader.py:98-132): the RoI head scores the
padded rows too, and the loss and the metrics mask them out. Val and test
items equal the JAX package's. Where the JAX package draws a training
item's scale, crop and flip from an unseeded ``random.Random()``
(``ava.py:200``), the port draws them from ``(RNG_SEED, epoch, index)``, so
that a training run repeats. cv2 is imported where frames are read.
"""

from __future__ import annotations

import os
import random
from collections import defaultdict

import numpy as np

from . import transform
from .datasets import DATASET_REGISTRY

FPS = 30
AVA_VALID_FRAMES = range(902, 1799)


def load_image_lists(cfg, is_train: bool):
    """frame-list csvs → (image_paths per video, video_idx_to_name)
    (ava_helper.py:16-74)."""
    names = cfg.AVA.TRAIN_LISTS if is_train else cfg.AVA.TEST_LISTS
    image_paths = defaultdict(list)
    video_name_to_idx: dict = {}
    video_idx_to_name: list = []
    for filename in names:
        path = os.path.join(cfg.AVA.FRAME_LIST_DIR, filename)
        with open(path) as f:
            f.readline()  # header
            for line in f:
                row = line.split()
                assert len(row) == 5, row
                video_name = row[0]
                if video_name not in video_name_to_idx:
                    video_name_to_idx[video_name] = len(video_name_to_idx)
                    video_idx_to_name.append(video_name)
                image_paths[video_name_to_idx[video_name]].append(
                    os.path.join(cfg.AVA.FRAME_DIR, row[3])
                )
    return (
        [image_paths[i] for i in range(len(image_paths))],
        video_idx_to_name,
    )


def parse_bboxes_file(ann_filenames, ann_is_gt_box, detect_thresh,
                      boxes_sample_rate=1):
    """AVA box csvs → video → sec → [[box, labels, is_ava]]
    (ava_helper.py:248-330)."""
    all_boxes: dict = {}
    count = 0
    unique_box_count = 0
    for filename, is_gt_box in zip(ann_filenames, ann_is_gt_box):
        with open(filename) as f:
            for line in f:
                row = line.strip().split(",")
                if not is_gt_box:
                    if float(row[7]) < detect_thresh:
                        continue
                is_ava = len(row[1]) == 4
                video_name, frame_sec = row[0], int(row[1])
                if frame_sec % boxes_sample_rate != 0:
                    continue
                box_key = ",".join(row[2:6])
                box = [float(v) for v in row[2:6]]
                label = -1 if row[6] == "" else int(row[6])
                video = all_boxes.setdefault(video_name, {})
                sec = video.setdefault(frame_sec, {})
                if box_key not in sec:
                    sec[box_key] = [box, [], is_ava]
                    unique_box_count += 1
                sec[box_key][1].append(label)
                if label != -1:
                    count += 1
    for video_name in all_boxes:
        for frame_sec in all_boxes[video_name]:
            all_boxes[video_name][frame_sec] = list(
                all_boxes[video_name][frame_sec].values()
            )
    return all_boxes, count, unique_box_count


def load_boxes_and_labels(cfg, mode: str):
    """(ava_helper.py:77-146)"""
    gt_lists = cfg.AVA.TRAIN_GT_BOX_LISTS if mode == "train" else []
    pred_lists = (
        cfg.AVA.TRAIN_PREDICT_BOX_LISTS
        if mode == "train"
        else cfg.AVA.TEST_PREDICT_BOX_LISTS
    )
    ann_filenames = [
        os.path.join(cfg.AVA.ANNOTATION_DIR, f) for f in gt_lists + pred_lists
    ]
    ann_is_gt_box = [True] * len(gt_lists) + [False] * len(pred_lists)
    boxes_sample_rate = (
        4 if mode == "val" and not cfg.AVA.FULL_TEST_ON_VAL else 1
    )
    all_boxes, count, unique = parse_bboxes_file(
        ann_filenames, ann_is_gt_box, cfg.AVA.DETECTION_SCORE_THRESH,
        boxes_sample_rate,
    )
    return all_boxes


def sec_to_frame(sec: int, is_ava: bool = True) -> int:
    return (sec - 900) * FPS if is_ava else sec * FPS


def get_keyframe_data(boxes_and_labels):
    """(ava_helper.py:149-227)"""
    keyframe_indices = []
    keyframe_boxes_and_labels = []
    for video_idx in range(len(boxes_and_labels)):
        sec_idx = 0
        keyframe_boxes_and_labels.append([])
        for sec in boxes_and_labels[video_idx]:
            entries = boxes_and_labels[video_idx][sec]
            is_ava = entries[0][2]
            if is_ava and sec not in AVA_VALID_FRAMES:
                continue
            if entries:
                keyframe_indices.append(
                    (video_idx, sec_idx, sec, sec_to_frame(sec, is_ava))
                )
                keyframe_boxes_and_labels[video_idx].append(entries)
            sec_idx += 1
    return keyframe_indices, keyframe_boxes_and_labels


def _scale_boxes(boxes, from_hw, to_hw):
    fy, fx = to_hw[0] / from_hw[0], to_hw[1] / from_hw[1]
    out = boxes.copy()
    out[:, [0, 2]] *= fx
    out[:, [1, 3]] *= fy
    return out


@DATASET_REGISTRY.register(name="Ava")
class Ava:
    """Keyframe clips with boxes. Items:
    ``(inputs, labels[max_boxes, num_classes], index,
    {"boxes": [max_boxes, 4], "box_mask": [max_boxes],
     "ori_boxes": ..., "metadata": [max_boxes, 2]})``."""

    MAX_BOXES = 28  # static slab size (AVA keyframes have <= ~25 people)

    def __init__(self, cfg, mode: str):
        self.cfg = cfg
        self.mode = "train" if mode == "train" else ("val" if mode == "val"
                                                     else "test")
        self._epoch = 0
        self._video_length = cfg.DATA.NUM_FRAMES
        self._sample_rate = cfg.DATA.SAMPLING_RATE
        self._seq_len = self._video_length * self._sample_rate
        self._num_classes = cfg.MODEL.NUM_CLASSES

        self._image_paths, self._video_idx_to_name = load_image_lists(
            cfg, self.mode == "train")
        boxes_and_labels = load_boxes_and_labels(cfg, self.mode)
        assert len(boxes_and_labels) <= len(self._image_paths)
        bl = [
            boxes_and_labels.get(self._video_idx_to_name[i], {})
            for i in range(len(self._image_paths))
        ]
        self._keyframe_indices, self._keyframe_boxes_and_labels = (
            get_keyframe_data(bl)
        )

    def __len__(self):
        return len(self._keyframe_indices)

    @property
    def num_videos(self):
        return len(self._image_paths)

    @property
    def video_idx_to_name(self):
        return self._video_idx_to_name

    def set_epoch(self, epoch: int) -> None:
        """The epoch whose training draws :meth:`__getitem__` makes (the
        loader's ``set_epoch`` passes it on)."""
        self._epoch = epoch

    def _rng(self, index: int) -> random.Random:
        """A training item's draws come from ``(RNG_SEED, epoch, index)``;
        val and test items' from ``random.Random(index)`` (they draw
        nothing)."""
        if self.mode != "train":
            return random.Random(index)
        state = np.random.SeedSequence(
            [self.cfg.RNG_SEED, self._epoch, index]).generate_state(2)
        return random.Random(int(state[0]) << 32 | int(state[1]))

    def _frame_indices(self, center: int, video_idx: int):
        seq = list(range(center - self._seq_len // 2,
                         center + self._seq_len // 2, self._sample_rate))
        n = len(self._image_paths[video_idx])
        return [min(max(i, 0), n - 1) for i in seq]

    def __getitem__(self, index: int):
        cfg = self.cfg
        import cv2

        index = int(index)
        video_idx, sec_idx, sec, center_idx = self._keyframe_indices[index]
        rng = self._rng(index)

        entries = self._keyframe_boxes_and_labels[video_idx][sec_idx]
        boxes = np.asarray([e[0] for e in entries], np.float32).reshape(-1, 4)
        label_lists = [e[1] for e in entries]

        idxs = self._frame_indices(center_idx, video_idx)
        frames = []
        for i in idxs:
            img = cv2.imread(self._image_paths[video_idx][i])
            if img is None:
                raise FileNotFoundError(self._image_paths[video_idx][i])
            frames.append(img[:, :, ::-1])  # BGR -> RGB
        frames = np.stack(frames)  # [T, H, W, 3]
        H, W = frames.shape[1:3]

        # normalized [0, 1] -> pixel coords, clipped
        boxes_px = boxes.copy()
        boxes_px[:, [0, 2]] = np.clip(boxes[:, [0, 2]] * W, 0, W)
        boxes_px[:, [1, 3]] = np.clip(boxes[:, [1, 3]] * H, 0, H)
        ori_boxes = boxes_px.copy()

        crop = cfg.DATA.TRAIN_CROP_SIZE if self.mode == "train" else \
            cfg.DATA.TEST_CROP_SIZE
        if self.mode == "train":
            size = rng.randint(*sorted(cfg.DATA.TRAIN_JITTER_SCALES))
        else:
            size = cfg.DATA.TEST_CROP_SIZE
        scaled = transform.short_side_scale(frames, size)
        boxes_px = _scale_boxes(boxes_px, (H, W), scaled.shape[1:3])

        sh, sw = scaled.shape[1:3]
        if self.mode == "train":
            y0 = rng.randint(0, max(sh - crop, 0)) if sh > crop else 0
            x0 = rng.randint(0, max(sw - crop, 0)) if sw > crop else 0
        else:
            y0, x0 = max((sh - crop) // 2, 0), max((sw - crop) // 2, 0)
        cropped = scaled[:, y0:y0 + crop, x0:x0 + crop]
        boxes_px[:, [0, 2]] -= x0
        boxes_px[:, [1, 3]] -= y0

        if self.mode == "train" and cfg.DATA.RANDOM_FLIP and rng.random() < 0.5:
            cropped = cropped[:, :, ::-1]
            cw = cropped.shape[2]
            x1 = cw - boxes_px[:, 2]
            x2 = cw - boxes_px[:, 0]
            boxes_px[:, 0], boxes_px[:, 2] = x1, x2

        boxes_px[:, [0, 2]] = np.clip(boxes_px[:, [0, 2]], 0, cropped.shape[2])
        boxes_px[:, [1, 3]] = np.clip(boxes_px[:, [1, 3]], 0, cropped.shape[1])

        x = transform.tensor_normalize(
            np.ascontiguousarray(cropped), cfg.DATA.MEAN, cfg.DATA.STD)

        n_path = 2 if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH else 1
        inputs = transform.pack_pathway_output(x, n_path, cfg.SLOWFAST.ALPHA)

        # multi-hot labels (ava_dataset.py:193-215); AVA ids are 1..80
        labels = np.zeros((self.MAX_BOXES, self._num_classes), np.float32)
        for i, ll in enumerate(label_lists[: self.MAX_BOXES]):
            for lab in ll:
                if lab == -1:
                    continue
                assert 1 <= lab <= 80
                labels[i, lab - 1] = 1.0
        n = min(len(boxes_px), self.MAX_BOXES)
        slab = np.zeros((self.MAX_BOXES, 4), np.float32)
        slab[:n] = boxes_px[: self.MAX_BOXES]
        ori_slab = np.zeros((self.MAX_BOXES, 4), np.float32)
        ori_slab[:n] = ori_boxes[: self.MAX_BOXES]
        mask = np.zeros(self.MAX_BOXES, np.float32)
        mask[:n] = 1.0
        metadata = np.tile(
            np.asarray([video_idx, sec], np.float32), (self.MAX_BOXES, 1))

        meta = {
            "boxes": slab,
            "box_mask": mask,
            "ori_boxes": ori_slab,
            "metadata": metadata,
            "orig_hw": np.asarray([H, W], np.float32),
        }
        return inputs, labels, index, meta


def write_synthetic_ava(root: str, *, secs: dict, num_frames: int,
                        hw: tuple, class_ids=(2, 5, 7),
                        boxes_per_sec: int = 2, seed: int = 0) -> dict:
    """Writes a small tree in AVA's layout under ``root``, for tests and
    smoke runs where no AVA data exists: per video of ``secs`` (name ->
    its keyframe seconds, 902 and on) ``num_frames`` JPEG frames of ``hw``
    (moving gradients plus noise, from ``seed``) named as AVA's frame
    lists name them; the train and val frame lists; ground-truth boxes
    (``boxes_per_sec`` a keyframe, one or two of ``class_ids`` each) for
    training and for the evaluation; predicted boxes for val and test (the
    ground truth's, each moved a little and scored, plus one box under the
    detection threshold); the label map and one excluded keyframe (the last
    video's last second). Returns the ``AVA`` config values that point at
    it."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = hw
    dirs = {k: os.path.join(root, k) for k in ("frames", "lists", "anno")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    rows, gt, pred = [], [], []
    for vid, vsecs in secs.items():
        os.makedirs(os.path.join(dirs["frames"], vid), exist_ok=True)
        for i in range(1, num_frames + 1):
            name = f"{vid}/{vid}_{i:06d}.jpg"
            img = np.stack([(xx * 3 + i * 5) % 256, (yy * 4 + i * 3) % 256,
                            rng.integers(0, 256, (h, w))], -1)
            cv2.imwrite(os.path.join(dirs["frames"], name),
                        img.astype(np.uint8))
            rows.append(f"{vid} 0 {i} {name} \"\"\n")
        for sec in vsecs:
            for _ in range(boxes_per_sec):
                x1, y1 = rng.uniform(0.0, 0.5, 2)
                x2, y2 = x1 + rng.uniform(0.2, 0.5), y1 + rng.uniform(0.2, 0.5)
                box = f"{x1:.3f},{y1:.3f},{x2:.3f},{y2:.3f}"
                for c in rng.choice(class_ids, rng.integers(1, 3),
                                    replace=False):
                    gt.append(f"{vid},{sec:04d},{box},{c},1\n")
                dx = rng.uniform(-0.02, 0.02)
                moved = ",".join(f"{min(max(v + dx, 0.0), 1.0):.3f}"
                                 for v in (x1, y1, x2, y2))
                pred.append(f"{vid},{sec:04d},{moved},,"
                            f"{rng.uniform(0.91, 1.0):.3f}\n")
            pred.append(f"{vid},{sec:04d},0.100,0.100,0.300,0.300,,0.500\n")
    header = "original_video_id video_id frame_id path labels\n"
    files = {("lists", "train.csv"): [header, *rows],
             ("lists", "val.csv"): [header, *rows],
             ("anno", "train_gt.csv"): gt, ("anno", "val_gt.csv"): gt,
             ("anno", "val_pred.csv"): pred,
             ("anno", "exclusions.csv"): [
                 f"{vid},{vsecs[-1]:04d}\n"
                 for vid, vsecs in list(secs.items())[-1:]],
             ("anno", "labelmap.pbtxt"): [
                 f'item {{\n  name: "action{c}"\n  id: {c}\n}}\n'
                 for c in class_ids]}
    for (d, name), lines in files.items():
        with open(os.path.join(dirs[d], name), "w") as f:
            f.writelines(lines)
    return {"FRAME_DIR": dirs["frames"], "FRAME_LIST_DIR": dirs["lists"],
            "ANNOTATION_DIR": dirs["anno"], "TRAIN_LISTS": ["train.csv"],
            "TEST_LISTS": ["val.csv"], "TRAIN_GT_BOX_LISTS": ["train_gt.csv"],
            "TRAIN_PREDICT_BOX_LISTS": [],
            "TEST_PREDICT_BOX_LISTS": ["val_pred.csv"],
            "GROUNDTRUTH_FILE": "val_gt.csv",
            "LABEL_MAP_FILE": "labelmap.pbtxt",
            "EXCLUSION_FILE": "exclusions.csv", "FULL_TEST_ON_VAL": True}
