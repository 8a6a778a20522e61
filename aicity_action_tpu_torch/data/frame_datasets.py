"""Frame-list and image datasets (port of
``aicity_action_tpu/data/frame_datasets.py``): Ssv2, Charades, Ssv2_frames
and Imagenet, and ``Multi_dataset_seq``, the concatenation of the
multi-head models' datasets.

References: datasets/ssv2.py (segment-uniform frame sampling, TSM-style),
datasets/charades.py (frame lists, multi-label, video-level labels the
union of the frames' labels), datasets/ssv2_frames.py and
datasets/imagenet.py. As in the port's clip datasets, train items draw
from an unseeded ``random.Random()`` and val and test items from
``random.Random(index)``, in the JAX package's order of calls; cv2 is
imported where frames are read.
"""

from __future__ import annotations

import os
import random
from collections import defaultdict

import numpy as np

from . import transform
from .datasets import (DATASET_REGISTRY, VideoCsvDataset, build_dataset,
                       get_seq_frames)
from .decoder import (_cv2_decode_indices, cv2_video_meta, get_start_end_idx,
                      sample_indices)


@DATASET_REGISTRY.register(name="Ssv2")
class Ssv2(VideoCsvDataset):
    """Something-Something v2 from video files with segment-uniform frames."""

    def __getitem__(self, index: int):
        cfg = self.cfg
        index = int(index)
        rng = random.Random() if self.mode == "train" else random.Random(index)
        (_, spatial_idx, min_scale, max_scale,
         crop_size) = self._sampling_params(index)

        path = self._path_to_videos[index]
        video_length, _ = cv2_video_meta(path)
        idxs = get_seq_frames(max(video_length, 1), cfg.DATA.NUM_FRAMES,
                              self.mode, rng)
        frames = _cv2_decode_indices(path, np.asarray(idxs))

        frames = transform.spatial_sampling(
            frames, spatial_idx=spatial_idx, min_scale=min_scale,
            max_scale=max_scale, crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP, rng=rng,
        )
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN,
                                            cfg.DATA.STD)
        n_path = 2 if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH else 1
        inputs = transform.pack_pathway_output(frames, n_path,
                                               cfg.SLOWFAST.ALPHA)
        return inputs, self._labels[index], index, {}


@DATASET_REGISTRY.register(name="Charades")
class Charades:
    """Charades from extracted frames (reference charades.py).

    ``{mode}.csv`` rows: ``original_vido_id video_id frame_id path labels``
    with comma-separated per-frame label ids; the video-level label is the
    union over frames (charades.py:90-91) as a multi-hot vector.
    """

    def __init__(self, cfg, mode: str):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        self._num_clips = (
            1 if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        path = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{mode}.csv")
        per_video_paths = defaultdict(list)
        per_video_labels = defaultdict(set)
        with open(path) as f:
            f.readline()
            for line in f:
                row = line.split()
                assert len(row) == 5, row
                video = row[0]
                per_video_paths[video].append(
                    os.path.join(cfg.DATA.PATH_PREFIX, row[3]))
                for tok in row[4].strip('"').split(","):
                    if tok:
                        per_video_labels[video].add(int(tok))
        self._videos = sorted(per_video_paths)
        self._paths = [per_video_paths[v] for v in self._videos]
        self._labels = []
        for v in self._videos:
            onehot = np.zeros(cfg.MODEL.NUM_CLASSES, np.float32)
            for c in per_video_labels[v]:
                onehot[c] = 1.0
            self._labels.append(onehot)

    def __len__(self):
        return len(self._videos) * self._num_clips

    @property
    def num_videos(self):
        return len(self._videos)

    def __getitem__(self, index: int):
        import cv2

        cfg = self.cfg
        index = int(index)
        video_idx = index // self._num_clips
        clip_idx = index % self._num_clips
        rng = random.Random() if self.mode == "train" else random.Random(index)

        paths = self._paths[video_idx]
        if self.mode in ("train", "val"):
            temporal_idx, spatial_idx = -1, -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop = cfg.DATA.TRAIN_CROP_SIZE
        else:
            temporal_idx = clip_idx // cfg.TEST.NUM_SPATIAL_CROPS
            spatial_idx = clip_idx % cfg.TEST.NUM_SPATIAL_CROPS
            if cfg.TEST.NUM_SPATIAL_CROPS == 1:
                spatial_idx = 1
            min_scale = max_scale = crop = cfg.DATA.TEST_CROP_SIZE

        seq_len = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
        s, e = get_start_end_idx(
            len(paths), seq_len, temporal_idx, cfg.TEST.NUM_ENSEMBLE_VIEWS,
            rng=rng)
        idxs = sample_indices(s, e, cfg.DATA.NUM_FRAMES, len(paths))
        frames = np.stack([
            cv2.cvtColor(cv2.imread(paths[i]), cv2.COLOR_BGR2RGB)
            for i in idxs
        ])
        frames = transform.spatial_sampling(
            frames, spatial_idx=spatial_idx, min_scale=min_scale,
            max_scale=max_scale, crop_size=crop,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP, rng=rng,
        )
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN,
                                            cfg.DATA.STD)
        n_path = 2 if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH else 1
        inputs = transform.pack_pathway_output(frames, n_path,
                                               cfg.SLOWFAST.ALPHA)
        return inputs, self._labels[video_idx], index, {}


@DATASET_REGISTRY.register(name="Ssv2_frames")
class Ssv2Frames:
    """Something-Something v2 from EXTRACTED frames (reference
    ssv2_frames.py): labels come from the official json pair
    (``something-something-v2-labels.json`` template->id map +
    ``something-something-v2-{train|validation}.json`` per-video
    templates); frame paths come from a ``{train|val}.csv`` frame list
    (same format as Charades); sampling is segment-uniform.
    """

    def __init__(self, cfg, mode: str):
        import json

        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        self._num_clips = (
            1 if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        root = cfg.DATA.PATH_TO_DATA_DIR
        with open(os.path.join(
                root, "something-something-v2-labels.json")) as f:
            label_dict = json.load(f)
        split = "train" if mode == "train" else "validation"
        with open(os.path.join(
                root, f"something-something-v2-{split}.json")) as f:
            label_json = json.load(f)
        names, labels = [], {}
        for video in label_json:
            template = video["template"].replace("[", "").replace("]", "")
            labels[str(video["id"])] = int(label_dict[template])
            names.append(str(video["id"]))

        csv_path = os.path.join(
            root, "{}.csv".format("train" if mode == "train" else "val"))
        per_video_paths = defaultdict(list)
        with open(csv_path) as f:
            f.readline()
            for line in f:
                row = line.split()
                assert len(row) == 5, row
                per_video_paths[row[0]].append(
                    os.path.join(cfg.DATA.PATH_PREFIX, row[3]))

        self._videos = [v for v in names if v in per_video_paths]
        self._paths = [per_video_paths[v] for v in self._videos]
        self._labels = [labels[v] for v in self._videos]

    def __len__(self):
        return len(self._videos) * self._num_clips

    @property
    def num_videos(self):
        return len(self._videos)

    def __getitem__(self, index: int):
        import cv2

        cfg = self.cfg
        index = int(index)
        video_idx = index // self._num_clips
        clip_idx = index % self._num_clips
        rng = random.Random() if self.mode == "train" else random.Random(index)
        paths = self._paths[video_idx]

        if self.mode in ("train", "val"):
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_idx = clip_idx % cfg.TEST.NUM_SPATIAL_CROPS
            if cfg.TEST.NUM_SPATIAL_CROPS == 1:
                spatial_idx = 1
            min_scale = max_scale = crop = cfg.DATA.TEST_CROP_SIZE

        idxs = get_seq_frames(len(paths), cfg.DATA.NUM_FRAMES, self.mode, rng)
        frames = np.stack([
            cv2.cvtColor(cv2.imread(paths[i]), cv2.COLOR_BGR2RGB)
            for i in idxs
        ])
        frames = transform.spatial_sampling(
            frames, spatial_idx=spatial_idx, min_scale=min_scale,
            max_scale=max_scale, crop_size=crop,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP, rng=rng,
        )
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN,
                                            cfg.DATA.STD)
        n_path = 2 if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH else 1
        inputs = transform.pack_pathway_output(frames, n_path,
                                               cfg.SLOWFAST.ALPHA)
        return inputs, self._labels[video_idx], index, {}


@DATASET_REGISTRY.register(name="Imagenet")
class Imagenet:
    """ImageNet-style image classification (reference imagenet.py).

    Manifest resolution order matches the reference:
    1. ``DATA.PATH_TO_PRELOAD_IMDB/{mode}.json`` — preloaded imdb
       (list of ``{"im_path", "class"}``, imagenet.py:44-51);
    2. the directory tree ``{PATH_TO_DATA_DIR}/{mode}/n<id>/*`` — class ids
       sorted and mapped to contiguous labels (imagenet.py:53-74);
    3. a ``{mode}.csv`` of ``path label`` rows (this framework's own
       convenience manifest).
    Images become single-frame clips [1, H, W, 3]."""

    def __init__(self, cfg, mode: str):
        import json
        import re

        self.cfg = cfg
        self.mode = mode
        self._num_clips = 1
        self._paths, self._labels = [], []

        preload = getattr(cfg.DATA, "PATH_TO_PRELOAD_IMDB", "")
        split_dir = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, mode)
        if preload:
            with open(os.path.join(preload, f"{mode}.json")) as f:
                imdb = json.load(f)
            for entry in imdb:
                self._paths.append(entry["im_path"])
                self._labels.append(int(entry["class"]))
        elif os.path.isdir(split_dir) and any(
                re.match(r"^n[0-9]+$", d) for d in os.listdir(split_dir)):
            class_ids = sorted(
                d for d in os.listdir(split_dir)
                if re.match(r"^n[0-9]+$", d))
            for cont_id, class_id in enumerate(class_ids):
                im_dir = os.path.join(split_dir, class_id)
                for name in sorted(os.listdir(im_dir)):
                    self._paths.append(os.path.join(im_dir, name))
                    self._labels.append(cont_id)
        else:
            path = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{mode}.csv")
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    p, label = line.split(cfg.DATA.PATH_LABEL_SEPARATOR)
                    self._paths.append(os.path.join(cfg.DATA.PATH_PREFIX,
                                                    p.strip()))
                    self._labels.append(int(label))

    def __len__(self):
        return len(self._paths)

    @property
    def num_videos(self):
        return len(self._paths)

    def __getitem__(self, index: int):
        import cv2

        cfg = self.cfg
        index = int(index)
        rng = random.Random() if self.mode == "train" else random.Random(index)
        img = cv2.imread(self._paths[index])[:, :, ::-1]
        frames = img[None]
        crop = (cfg.DATA.TRAIN_CROP_SIZE if self.mode == "train"
                else cfg.DATA.TEST_CROP_SIZE)
        if self.mode == "train":
            frames = transform.spatial_sampling(
                frames, spatial_idx=-1,
                min_scale=cfg.DATA.TRAIN_JITTER_SCALES[0],
                max_scale=cfg.DATA.TRAIN_JITTER_SCALES[1],
                crop_size=crop, random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                rng=rng)
        else:
            frames = transform.spatial_sampling(
                frames, spatial_idx=1, min_scale=crop, max_scale=crop,
                crop_size=crop, random_horizontal_flip=False, rng=rng)
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN,
                                            cfg.DATA.STD)
        return [frames], self._labels[index], index, {}


@DATASET_REGISTRY.register(name="Multi_dataset_seq")
class MultiDatasetSeq:
    """The ``MODEL.MULTI_DATASETS`` one after another (the JAX
    ``frame_datasets.py:336``; reference multi_dataset_seq.py:38-51), each
    built from its own ``MULTI_PATH_TO_DATA_DIR`` / ``MULTI_PATH_PREFIX``
    entry where given and its ``MULTI_NUM_CLASSES``; in training each
    repeated ``MULTI_REPLICAS`` times. Labels become one-hot (an int
    label) or zero-padded (a multi-hot one) f32 vectors of the largest
    class count, and ``meta["dataset_idx"]`` says which dataset an item
    comes from."""

    def __init__(self, cfg, mode: str):
        self.cfg = cfg
        self.mode = mode
        names = cfg.MODEL.MULTI_DATASETS
        data_dirs = cfg.MODEL.MULTI_PATH_TO_DATA_DIR or [""] * len(names)
        prefixes = cfg.MODEL.MULTI_PATH_PREFIX or [""] * len(names)
        self.max_classes = max(cfg.MODEL.MULTI_NUM_CLASSES)
        self.datasets = []
        self._index_map = []  # global index -> (dataset index, its index)
        for di, name in enumerate(names):
            sub = cfg.clone()
            if data_dirs[di]:
                sub.DATA.PATH_TO_DATA_DIR = data_dirs[di]
            if prefixes[di]:
                sub.DATA.PATH_PREFIX = prefixes[di]
            sub.MODEL.NUM_CLASSES = cfg.MODEL.MULTI_NUM_CLASSES[di]
            ds = build_dataset(name, sub, mode)
            self.datasets.append(ds)
            reps = cfg.MODEL.MULTI_REPLICAS[di] if mode == "train" else 1
            self._index_map += [(di, li) for _ in range(reps)
                                for li in range(len(ds))]

    def __len__(self):
        return len(self._index_map)

    def __getitem__(self, index: int):
        di, li = self._index_map[int(index)]
        inputs, label, _, meta = self.datasets[di][li]
        meta = dict(meta)
        meta["dataset_idx"] = np.int64(di)
        onehot = np.zeros(self.max_classes, np.float32)
        lab = np.asarray(label)
        if lab.ndim == 0:
            onehot[int(lab)] = 1.0
        else:
            onehot[:lab.shape[0]] = lab
        return inputs, onehot, index, meta
