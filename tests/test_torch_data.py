"""The port's clip data stack against the JAX package's, on the same files
and seeds, exactly (``array_equal`` for uint8 frames and for normalized f32
frames): ``decode`` (cv2), every transform, RandAugment and RandomErasing,
``VideoCsvDataset.__getitem__`` in train (seeded), val and test modes, the
Loader's per-epoch, per-shard order and batches, ``_pad_batch``, and the
host-to-card feed on the CPU. Videos are written in code (64x48 mp4v)."""

import random

import numpy as np
import pytest
import torch
from PIL import Image

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.data import datasets as jdatasets
from aicity_action_tpu.data import decoder as jdecoder
from aicity_action_tpu.data import loader as jloader
from aicity_action_tpu.data import rand_augment as jra
from aicity_action_tpu.data import transform as jtransform
from aicity_action_tpu.engine import train_loop as jtrain_loop
from aicity_action_tpu.parallel import prefetch as jprefetch
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data import datasets as tdatasets
from aicity_action_tpu_torch.data import decoder as tdecoder
from aicity_action_tpu_torch.data import loader as tloader
from aicity_action_tpu_torch.data import rand_augment as tra
from aicity_action_tpu_torch.data import transform as ttransform
from aicity_action_tpu_torch.engine import train_loop as ttrain_loop
from aicity_action_tpu_torch.parallel import prefetch as tprefetch
from torch_port_helpers import write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NUM_VIDEOS = 6


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    for i in range(NUM_VIDEOS):
        write_mp4(str(d / f"v{i}.mp4"), num_frames=40 + 6 * i, seed=i)
    for split in ("train", "val", "test"):
        with open(d / f"{split}.csv", "w") as f:
            for i in range(NUM_VIDEOS):
                f.write(f"v{i}.mp4 {i % 3}\n")
    return d


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


# ------------------------------------------------------------------ decode

def test_sampling_math_matches_jax():
    for args in [(90, 32.0, -1, 10), (90, 32.0, 3, 10), (20, 32.0, 1, 3),
                 (90, 32.0, 0, 1)]:
        for offset in (False, True):
            want = jdecoder.get_start_end_idx(*args, offset,
                                              random.Random(7))
            got = tdecoder.get_start_end_idx(*args, offset,
                                             random.Random(7))
            assert got == want, (args, offset)
    assert tdecoder.clip_size_in_frames(4, 16, 25.0, 30.0) == \
        jdecoder.clip_size_in_frames(4, 16, 25.0, 30.0)
    frames = np.arange(30)[:, None, None, None].astype(np.uint8)
    _assert_same(tdecoder.temporal_sampling(frames, 3.5, 40.0, 7),
                 jdecoder.temporal_sampling(frames, 3.5, 40.0, 7))


@pytest.mark.parametrize("clip_idx", [-1, 0, 1, 2])
@pytest.mark.parametrize("backend", ["cv2", "pyav", "decord"])
def test_decode_matches_jax(videos, clip_idx, backend):
    """A train draw (seeded ``random.Random``) and each test clip; PyAV and
    decord are installed on neither machine, so both packages decode those
    backends with cv2."""
    path = str(videos / "v3.mp4")
    kw = dict(sampling_rate=2, num_frames=8, clip_idx=clip_idx, num_clips=3,
              target_fps=30.0, backend=backend)
    want = jdecoder.decode(path, rng=random.Random(11), **kw)
    got = tdecoder.decode(path, rng=random.Random(11), **kw)
    assert got.shape == (8, 48, 64, 3)
    _assert_same(got, want)
    idx = np.array([2, 5, 5, 70])  # past the end: the nearest decoded
    _assert_same(tdecoder._cv2_decode_indices(path, idx),
                 jdecoder._cv2_decode_indices(path, idx))
    got_all, fps = tdecoder._cv2_decode_all(path)
    want_all, want_fps = jdecoder._cv2_decode_all(path)
    _assert_same(got_all, want_all)
    assert fps == want_fps


class _FakeFrame:
    def __init__(self, pts, image):
        self.pts, self.image = pts, image

    def to_rgb(self):
        return self

    def to_ndarray(self):
        return self.image


class _FakeContainer:
    """What ``pyav_decode`` reads of a PyAV container: one video stream of
    ``n`` frames, ``step`` pts apart (duration None: no header)."""

    def __init__(self, n, step, header=True):
        self.frames = [_FakeFrame(i * step, np.full((2, 3, 3), i, np.uint8))
                       for i in range(n)]
        stream = type("Stream", (), {})()
        stream.average_rate = 25
        stream.frames = n if header else 0
        stream.duration = n * step if header else None
        self.streams = type("Streams", (), {"video": [stream]})()
        self.seeked = None

    def seek(self, offset, **kw):
        self.seeked = offset

    def decode(self, stream):
        return iter([f for f in self.frames if f.pts >= self.seeked])


@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("clip_idx", [-1, 2])
def test_pyav_decode_matches_jax(header, clip_idx):
    """PyAV is installed on neither machine: both packages' selective-seek
    decode read a stand-in container."""
    kw = dict(sampling_rate=2, num_frames=8, clip_idx=clip_idx, num_clips=4,
              target_fps=30.0)
    want = jdecoder.pyav_decode(_FakeContainer(300, 512, header),
                                rng=random.Random(3), **kw)
    got = tdecoder.pyav_decode(_FakeContainer(300, 512, header),
                               rng=random.Random(3), **kw)
    assert got[1:] == want[1:]
    _assert_same(got[0], want[0])


# --------------------------------------------------------------- transform

def _clip(seed, t=4, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_match_jax(seed):
    x = _clip(seed)
    tall = _clip(seed, h=64, w=40)
    pairs = [
        (lambda m, r: m.random_short_side_scale_jitter(x, 40, 56, False,
                                                       r)),
        (lambda m, r: m.random_short_side_scale_jitter(x, 40, 56, True,
                                                       r)),
        (lambda m, r: m.short_side_scale(tall, 30)),
        (lambda m, r: m.random_crop(x, 32, r)),
        (lambda m, r: m.horizontal_flip(0.5, x, r)),
        (lambda m, r: m.random_resized_crop(x, 32, 24, rng=r)),
        (lambda m, r: m.random_resized_crop(x, 32, 32, (2.0, 3.0),
                                            (3.0, 4.0), r)),
        (lambda m, r: m.tensor_normalize(x, (0.45, 0.4, 0.4),
                                         (0.225, 0.2, 0.25))),
        (lambda m, r: m.spatial_sampling(x, -1, 40, 56, 32, True,
                                         False, rng=r)),
        (lambda m, r: m.spatial_sampling(x, -1, 40, 56, 32, True, False,
                                         (0.75, 1.33), (0.08, 1.0),
                                         r)),
        (lambda m, r: m.pack_pathway_output(x, 2, 4)[0]),
        (lambda m, r: m.pack_pathway_output(x, 1, 4)[0]),
    ]
    pairs += [(lambda m, r, s=s, f=f: m.uniform_crop(f, 32, s))
              for s in (0, 1, 2) for f in (x, tall)]
    pairs += [(lambda m, r, s=s: m.spatial_sampling(tall, s, 36, 36, 32))
              for s in (0, 1, 2)]
    for fn in pairs:
        want = fn(jtransform, random.Random(seed + 40))
        got = fn(ttransform, random.Random(seed + 40))
        _assert_same(np.asarray(got), np.asarray(want))
    f = x.astype(np.float32) / 255.0
    out = {}
    for m in (jtransform, ttransform):
        np.random.seed(seed)  # color_jitter's order of the three jitters
        jitter = m.color_jitter(f, 0.4, 0.4, 0.4, random.Random(seed))
        np.random.seed(seed)
        out[m] = (jitter, m.lighting_jitter(f, 0.1, [0.2, 0.1, 0.05],
                                            np.eye(3).tolist()))
    for got, want in zip(out[ttransform], out[jtransform]):
        _assert_same(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rand_augment_and_erasing_match_jax(seed):
    """The same PIL ops and magnitudes for the same seed of the ``random``
    module (both packages draw from it), and RandomErasing for the same
    ``rng`` and numpy seed."""
    frames = [Image.fromarray(f) for f in _clip(seed, t=3)]
    policy = "rand-m9-n3-mstd0.5-inc1"
    random.seed(seed)
    want = jra.rand_augment_transform(policy)(frames)
    random.seed(seed)
    got = tra.rand_augment_transform(policy)(frames)
    for a, b in zip(got, want):
        _assert_same(np.asarray(a), np.asarray(b))
    clip = np.random.default_rng(seed).standard_normal(
        (3, 32, 24, 3)).astype(np.float32)
    for mode in ("pixel", "const"):
        kw = dict(probability=0.9, mode=mode, max_count=2)
        np.random.seed(seed)
        want = jra.RandomErasing(**kw)(clip, random.Random(seed))
        np.random.seed(seed)
        got = tra.RandomErasing(**kw)(clip, random.Random(seed))
        _assert_same(got, want)


# ----------------------------------------------------------------- dataset

def _data_cfg(get, videos, **over):
    cfg = get()
    cfg.DATA.PATH_TO_DATA_DIR = str(videos)
    cfg.DATA.PATH_PREFIX = str(videos)
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 3
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    cfg.MODEL.NUM_CLASSES = 3
    cfg.MODEL.ARCH = "mvit"
    for key, value in over.items():
        node, leaf = key.rsplit(".", 1)
        setattr(getattr(cfg, node), leaf, value)
    return cfg


@pytest.fixture
def seeded_random(monkeypatch):
    """``random.Random()`` without a seed (the train clips' generator)
    seeded with 5; one patch of the ``random`` module serves both
    packages."""
    orig = random.Random
    monkeypatch.setattr(random, "Random",
                        lambda seed=None: orig(5 if seed is None else seed))


CASES = {
    "train": ("train", {}),
    "train_flip_reverse": ("train", {"DATA.RANDOM_FLIP": True,
                                     "DATA.REVERSE_INPUT_CHANNEL": True}),
    "train_uniform": ("train", {"DATA.UNIFORM_SAMPLE_FRAME": True}),
    "train_randaug": ("train", {"AUG.ENABLE": True, "AUG.RE_PROB": 0.5}),
    "val": ("val", {}),
    "test": ("test", {}),
    "test_uniform": ("test", {"DATA.UNIFORM_SAMPLE_FRAME": True}),
    "test_two_pathways": ("test", {"MODEL.ARCH": "slowfast"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_items_match_jax(videos, seeded_random, case):
    split, over = CASES[case]
    jds = jdatasets.Aicity(_data_cfg(jax_get_cfg, videos, **over), split)
    tds = tdatasets.Aicity(_data_cfg(get_cfg, videos, **over), split)
    assert len(tds) == len(jds) and tds.num_videos == jds.num_videos
    for i in range(0, len(tds), 5 if split == "test" else 2):
        random.seed(i)  # RandAugment's and RandomErasing's draws
        np.random.seed(i)
        want = jds[i]
        random.seed(i)
        np.random.seed(i)
        got = tds[i]
        assert got[1:3] == want[1:3] and got[3] == want[3] == {}
        assert len(got[0]) == len(want[0])
        for a, b in zip(got[0], want[0]):
            assert a.dtype == np.float32
            _assert_same(a, b)


def test_labels_and_unported_datasets(videos, tmp_path):
    with open(tmp_path / "val.csv", "w") as f:
        f.write(f"{videos}/v0.mp4 0,2\n{videos}/v1.mp4 1\n")
    cfg = _data_cfg(get_cfg, tmp_path)
    cfg.DATA.PATH_PREFIX = ""
    jcfg = _data_cfg(jax_get_cfg, tmp_path)
    jcfg.DATA.PATH_PREFIX = ""
    for name in ("Mmit", "Activitynet"):
        got = getattr(tdatasets, name)(cfg, "val")._labels
        want = getattr(jdatasets, name)(jcfg, "val")._labels
        assert [np.asarray(x).tolist() for x in got] == \
            [np.asarray(x).tolist() for x in want]
    assert type(tdatasets.build_dataset("mmit", cfg, "val")) is \
        tdatasets.Mmit
    # Web_video_text is ported: the captions' ids, padded to the context
    with open(tmp_path / "val_tokenized.csv", "w") as f:
        f.write(f"{videos}/v0.mp4 3 5,9,1\n{videos}/v1.mp4 1 "
                + ",".join(map(str, range(1, 90))) + "\n")
    got = tdatasets.build_dataset("web_video_text", cfg, "val")
    want = jdatasets.WebVideoText(jcfg, "val")
    assert type(got) is tdatasets.WebVideoText
    assert got._labels == want._labels == [3, 1]
    assert [t.tolist() for t in got._tokens] == \
        [t.tolist() for t in want._tokens]
    assert got._tokens[0].shape == (cfg.CONTRA.CONTEXT_LENGTH,)
    # Multi_dataset_seq is ported: the two datasets one after another
    cfg.MODEL.MULTI_DATASETS = ["mmit", "activitynet"]
    cfg.MODEL.MULTI_NUM_CLASSES = [5, 4]
    multi = tdatasets.build_dataset("multi_dataset_seq", cfg, "val")
    assert type(multi).__name__ == "MultiDatasetSeq" and len(multi) == 4


def test_decode_failures_retry_then_raise(videos, tmp_path):
    with open(tmp_path / "test.csv", "w") as f:
        f.write("missing.mp4 0\n")
    for get, mod in ((jax_get_cfg, jdatasets), (get_cfg, tdatasets)):
        cfg = _data_cfg(get, tmp_path)
        with pytest.raises(RuntimeError, match="after 10 retries"):
            mod.Aicity(cfg, "test")[0]


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("shards", [(0, 1), (0, 2), (1, 2)])
def test_loader_order_and_batches_match_jax(videos, shards):
    shard_id, num_shards = shards
    loaders = []
    for get, ds_mod, ld_mod in ((jax_get_cfg, jdatasets, jloader),
                                (get_cfg, tdatasets, tloader)):
        ds = ds_mod.Aicity(_data_cfg(get, videos), "val")
        loaders.append(ld_mod.Loader(
            ds, 2, shuffle=True, drop_last=num_shards == 1, num_workers=3,
            seed=4, shard_id=shard_id, num_shards=num_shards))
    jl, tl = loaders
    for epoch in (0, 1):
        jloader.shuffle_dataset(jl, epoch)
        tloader.shuffle_dataset(tl, epoch)
        _assert_same(tl._indices(), jl._indices())
        assert len(tl) == len(jl)
        batches = list(zip(tl, jl, strict=True))
        assert len(batches) == len(jl)
        for got, want in batches:
            assert got.keys() == want.keys()
            _assert_same(got["inputs"][0], want["inputs"][0])
            _assert_same(got["labels"], want["labels"])
            _assert_same(got["index"], want["index"])


def test_construct_loader_matches_jax(videos):
    for split in ("train", "val", "test"):
        j = jloader.construct_loader(_data_cfg(jax_get_cfg, videos), split)
        t = tloader.construct_loader(_data_cfg(get_cfg, videos), split)
        assert (t.batch_size, t.shuffle, t.drop_last, len(t)) == \
            (j.batch_size, j.shuffle, j.drop_last, len(j))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_pad_batch_matches_jax(n):
    rng = np.random.default_rng(n)
    batch = {"inputs": [rng.standard_normal((n, 2, 4, 4, 3))],
             "labels": rng.integers(0, 5, n), "index": np.arange(n)}
    got, gn = ttrain_loop._pad_batch(batch, 4)
    want, wn = jtrain_loop._pad_batch(batch, 4)
    assert gn == wn == n
    _assert_same(got["inputs"][0], want["inputs"][0])
    _assert_same(got["labels"], want["labels"])
    _assert_same(got["index"], want["index"])


# -------------------------------------------------------------------- feed

def test_feed_on_the_cpu_and_prefetch_order():
    """The bf16 host cast rounds as the model's entry cast does; on the CPU
    the feed hands back the arrays as tensors; the prefetch yields the JAX
    generator's pairs in its order."""
    cfg = get_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    assert tprefetch.host_transfer_dtype(cfg) == torch.bfloat16
    cfg.MIXUP.ENABLE = True
    assert tprefetch.host_transfer_dtype(cfg) is None
    cfg.MIXUP.ENABLE = False
    cfg.TPU.BF16_HOST_TRANSFER = False
    assert tprefetch.host_transfer_dtype(cfg) is None
    x = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(
        np.float32)
    cast = tprefetch.cast_for_transfer(x, torch.bfloat16)
    assert torch.equal(cast, torch.from_numpy(x).to(torch.bfloat16))
    labels = np.array([1, 2])
    assert tprefetch.cast_for_transfer(labels, torch.bfloat16).dtype == \
        torch.int64
    feed = tprefetch.DeviceFeed(torch.device("cpu"), torch.bfloat16)
    dev = feed.take(feed.put({"inputs": [x], "labels": labels}))
    assert torch.equal(dev["inputs"][0], cast)
    assert torch.equal(dev["labels"], torch.from_numpy(labels))
    for n, depth in ((5, 2), (1, 2), (0, 2), (4, 1)):
        want = list(jprefetch.prefetch_to_device(range(n), lambda i: i * 10,
                                                 depth))
        got = list(tprefetch.prefetch_to_device(range(n), lambda i: i * 10,
                                                depth))
        assert got == want
