"""Clip-classification datasets over a csv of ``path<sep>label`` rows (port
of ``aicity_action_tpu/data/datasets.py``; reference: datasets/kinetics.py
and its clone aicity.py).

- train/val: one clip per video, placed at random, random short-side
  scale jitter and crop (+ flip where ``DATA.RANDOM_FLIP``, off for AI City:
  its classes are left/right sensitive);
- test: each video repeated ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS``
  times, the temporal and spatial index taken from the repeat
  (aicity.py:203-227);
- a failed decode is retried, and after several tries a random other video
  takes its place (aicity.py:238-290; never in test mode).

Train clips draw from an unseeded ``random.Random()``, val and test clips
from ``random.Random(index)``, and every transform takes that ``rng``, in
the JAX package's order of calls. Items are numpy, channels-last.
"""

from __future__ import annotations

import os
import random

import numpy as np

from ..utils.registry import Registry
from . import decoder, transform

DATASET_REGISTRY = Registry("DATASET")

_NUM_RETRIES = 10
_REPLACE_AFTER = 5


def get_seq_frames(video_length: int, num_frames: int, mode: str,
                   rng: random.Random) -> list[int]:
    """Segment-uniform sampling (copy of ``aicity_action_tpu/data/
    frame_datasets.py:get_seq_frames``; reference ssv2.py:158-184): the
    video in ``num_frames`` segments, one frame from each (random in
    training, the centre otherwise)."""
    seg_size = float(video_length - 1) / num_frames
    seq = []
    for i in range(num_frames):
        start = int(np.round(seg_size * i))
        end = int(np.round(seg_size * (i + 1)))
        if mode == "train":
            seq.append(rng.randint(start, end))
        else:
            seq.append((start + end) // 2)
    return seq


class VideoCsvDataset:
    """Base clip dataset; one row per video: ``path<sep>label``."""

    multi_label = False

    def __init__(self, cfg, mode: str):
        assert mode in ("train", "val", "test"), mode
        self.cfg = cfg
        self.mode = mode

        if mode in ("train", "val"):
            self._num_clips = 1
        else:
            self._num_clips = (
                cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
            )

        self._path_to_videos: list[str] = []
        self._labels: list = []
        self._spatial_temporal_idx: list[int] = []
        self._construct()

    # -- csv loading ---------------------------------------------------
    def _csv_name(self) -> str:
        return f"{self.mode}.csv"

    def _parse_label(self, label_str: str):
        return int(label_str)

    def _construct(self):
        cfg = self.cfg
        path = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, self._csv_name())
        assert os.path.exists(path), f"{path} not found"
        skip = 1
        if self.mode == "val":
            skip = max(cfg.DATA.VAL_SKIP, 1)
        elif self.mode == "test":
            skip = max(cfg.DATA.TEST_SKIP, 1)
        with open(path) as f:
            rows = [ln.strip() for ln in f if ln.strip()]
        for clip_idx, row in enumerate(rows):
            if clip_idx % skip != 0:
                continue
            fields = row.split(self.cfg.DATA.PATH_LABEL_SEPARATOR)
            assert len(fields) == 2, (path, row)
            video_path, label = fields
            for idx in range(self._num_clips):
                self._path_to_videos.append(
                    os.path.join(cfg.DATA.PATH_PREFIX, video_path)
                )
                self._labels.append(self._parse_label(label))
                self._spatial_temporal_idx.append(idx)
        assert self._path_to_videos, f"empty dataset from {path}"

    def __len__(self) -> int:
        return len(self._path_to_videos)

    @property
    def num_videos(self) -> int:
        return len(self._path_to_videos) // self._num_clips

    # -- item ------------------------------------------------------------
    def _sampling_params(self, index: int):
        cfg = self.cfg
        if self.mode in ("train", "val"):
            temporal_idx = -1
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            replica = self._spatial_temporal_idx[index]
            temporal_idx = replica // cfg.TEST.NUM_SPATIAL_CROPS
            spatial_idx = replica % cfg.TEST.NUM_SPATIAL_CROPS
            if cfg.TEST.NUM_SPATIAL_CROPS == 1:
                spatial_idx = 1  # center crop
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE
        return temporal_idx, spatial_idx, min_scale, max_scale, crop_size

    def __getitem__(self, index: int):
        cfg = self.cfg
        index = int(index)
        rng = random.Random() if self.mode == "train" else random.Random(index)
        (temporal_idx, spatial_idx, min_scale, max_scale,
         crop_size) = self._sampling_params(index)

        for retry in range(_NUM_RETRIES):
            path = self._path_to_videos[index]
            try:
                if cfg.DATA.UNIFORM_SAMPLE_FRAME:
                    # segment-uniform sampling (TSM-style) instead of a
                    # fixed-stride clip (reference kinetics.py path)
                    video_len, _ = decoder.cv2_video_meta(path)
                    idxs = get_seq_frames(
                        max(video_len, 1), cfg.DATA.NUM_FRAMES,
                        self.mode, rng)
                    frames = decoder._cv2_decode_indices(
                        path, np.asarray(idxs))
                else:
                    # multigrid long cycle: when T is reduced, randomly
                    # stretch the stride so some clips keep the original
                    # span (reference datasets/utils.py:297-306)
                    sampling_rate = cfg.DATA.SAMPLING_RATE
                    lc = cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE
                    if lc > 0 and self.mode == "train":
                        sampling_rate = rng.randint(sampling_rate, lc)
                    frames = decoder.decode(
                        path,
                        sampling_rate,
                        cfg.DATA.NUM_FRAMES,
                        clip_idx=temporal_idx,
                        num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS,
                        target_fps=cfg.DATA.TARGET_FPS,
                        backend=cfg.DATA.DECODING_BACKEND,
                        use_offset=cfg.DATA.USE_OFFSET_SAMPLING,
                        rng=rng,
                    )
            except Exception:
                frames = None
            if frames is not None:
                break
            if retry >= _REPLACE_AFTER and self.mode != "test":
                index = rng.randrange(len(self))
        else:
            raise RuntimeError(
                f"Failed to decode after {_NUM_RETRIES} retries: "
                f"{self._path_to_videos[index]}"
            )

        if cfg.DATA.REVERSE_INPUT_CHANNEL:
            frames = frames[..., ::-1]

        if self.mode == "train" and cfg.AUG.ENABLE:
            frames = self._aug_frames(frames, crop_size, rng)
        else:
            frames = transform.spatial_sampling(
                frames,
                spatial_idx=spatial_idx,
                min_scale=min_scale,
                max_scale=max_scale,
                crop_size=crop_size,
                random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
                rng=rng,
            )
            frames = transform.tensor_normalize(
                frames, cfg.DATA.MEAN, cfg.DATA.STD
            )

        n_path = 2 if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH else 1
        inputs = transform.pack_pathway_output(
            frames, n_path, cfg.SLOWFAST.ALPHA
        )
        label = self._labels[index]
        return inputs, label, index, {}

    def _aug_frames(self, frames: np.ndarray, crop_size: int,
                    rng) -> np.ndarray:
        """RandAugment path (reference: aicity.py:354-429 _aug_frame):
        PIL RandAugment (same ops per clip) → inception-style crop (+flip) →
        normalize → optional RandomErasing."""
        from PIL import Image

        from .rand_augment import RandomErasing, rand_augment_transform

        cfg = self.cfg
        ra = rand_augment_transform(cfg.AUG.AA_TYPE)
        pil = [Image.fromarray(f) for f in frames]
        pil = ra(pil)
        frames = np.stack([np.asarray(f) for f in pil])

        scl = cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE or (0.08, 1.0)
        asp = cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE or (3 / 4, 4 / 3)
        frames = transform.random_resized_crop(
            frames, crop_size, crop_size, scale=scl, ratio=asp, rng=rng)
        if cfg.DATA.RANDOM_FLIP:
            frames = transform.horizontal_flip(0.5, frames, rng)
        frames = np.ascontiguousarray(frames)
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN,
                                            cfg.DATA.STD)
        if cfg.AUG.RE_PROB > 0:
            frames = RandomErasing(
                probability=cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE,
                max_count=cfg.AUG.RE_COUNT,
            )(frames, rng)
        return frames


@DATASET_REGISTRY.register(name="Kinetics")
class Kinetics(VideoCsvDataset):
    pass


@DATASET_REGISTRY.register(name="Aicity")
class Aicity(VideoCsvDataset):
    """AI City driver-action clips (reference aicity.py == kinetics.py)."""


@DATASET_REGISTRY.register(name="Activitynet")
class Activitynet(VideoCsvDataset):
    def _parse_label(self, label_str: str):
        # activitynet keeps only the first label (activitynet.py:134-135)
        return int(label_str.split(",")[0])


@DATASET_REGISTRY.register(name="Mmit")
class Mmit(VideoCsvDataset):
    """Multi-label: comma-separated ids → multi-hot (mmit.py:139-153)."""

    multi_label = True

    def _parse_label(self, label_str: str):
        onehot = np.zeros(self.cfg.MODEL.NUM_CLASSES, np.float32)
        for tok in label_str.split(","):
            if tok != "":
                onehot[int(tok)] = 1.0
        return onehot


@DATASET_REGISTRY.register(name="Mit")
class Mit(VideoCsvDataset):
    pass


@DATASET_REGISTRY.register(name="Web_video_text")
class WebVideoText(VideoCsvDataset):
    """Video-caption pairs for contrastive training (reference:
    web_video_text.py:117-180): ``{mode}_tokenized.csv`` rows of
    ``path<sep>label<sep>comma-separated BPE ids``; the ids are padded with
    zeros (or cut) to ``CONTRA.CONTEXT_LENGTH``, and an item carries them
    in its meta dict as ``tokens`` (the loader's batch key)."""

    def _csv_name(self) -> str:
        return f"{self.mode}_tokenized.csv"

    def _construct(self):
        cfg = self.cfg
        path = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, self._csv_name())
        assert os.path.exists(path), f"{path} not found"
        self._tokens: list[np.ndarray] = []
        with open(path) as f:
            rows = [ln for ln in f.read().splitlines() if ln]
        for row in rows:
            video_path, label, token_str = row.split(
                cfg.DATA.PATH_LABEL_SEPARATOR)
            ids = [int(t) for t in token_str.split(",") if t]
            padded = np.zeros(cfg.CONTRA.CONTEXT_LENGTH, np.int64)
            ids = ids[: cfg.CONTRA.CONTEXT_LENGTH]
            padded[: len(ids)] = ids
            for idx in range(self._num_clips):
                self._path_to_videos.append(
                    os.path.join(cfg.DATA.PATH_PREFIX, video_path))
                self._labels.append(int(label))
                self._tokens.append(padded)
                self._spatial_temporal_idx.append(idx)
        assert self._path_to_videos, f"empty dataset from {path}"

    def __getitem__(self, index: int):
        inputs, label, index, meta = super().__getitem__(index)
        meta = dict(meta)
        meta["tokens"] = self._tokens[index]
        return inputs, label, index, meta


def build_dataset(name: str, cfg, split: str):
    """Reference: datasets/build.py:15-31; the name is capitalized to the
    class's."""
    from . import ava, frame_datasets  # noqa: F401 (register their classes)

    name = name.capitalize()
    return DATASET_REGISTRY.get(name)(cfg, split)
