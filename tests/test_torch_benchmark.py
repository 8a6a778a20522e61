"""The port's loader and decode benchmarks on the CPU:
``benchmark_data_loading`` against the JAX package's on the same written
clips (the same keys, clips and batch size; the times are the host's), its
CLI, and ``tools.benchmark_decode``'s JSON lines."""

import json

import numpy as np
import pytest

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.utils.benchmark import (
    benchmark_data_loading as jax_benchmark)
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.tools import benchmark as tbenchmark
from aicity_action_tpu_torch.tools import benchmark_decode
from aicity_action_tpu_torch.utils.benchmark import benchmark_data_loading
from torch_port_helpers import write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    for i in range(5):
        write_mp4(str(d / f"v{i}.mp4"), num_frames=12, size=(48, 40),
                  seed=60 + i)
    (d / "train.csv").write_text("".join(f"v{i}.mp4 {i % 2}\n"
                                         for i in range(5)))
    return d


def _cfg(get, d):
    cfg = get()
    cfg.OUTPUT_DIR = str(d / "out")
    cfg.DATA.PATH_TO_DATA_DIR = str(d)
    cfg.DATA.PATH_PREFIX = str(d)
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 44]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.MODEL.ARCH = "mvit"
    cfg.TRAIN.DATASET = "aicity"
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.BENCHMARK.NUM_EPOCHS = 2
    cfg.BENCHMARK.LOG_PERIOD = 1
    cfg.DATA_LOADER.NUM_WORKERS = 1
    return cfg


def test_benchmark_data_loading_matches_jax(clips):
    """5 clips at batch 2 over 2 epochs: the train loader drops the short
    batch, 2 batches an epoch, 8 clips."""
    want = jax_benchmark(_cfg(jax_get_cfg, clips))
    got = benchmark_data_loading(_cfg(get_cfg, clips))
    assert set(got) == set(want) == {
        "_type", "clips_per_sec", "med_iter_sec", "p95_iter_sec",
        "total_clips", "wall_sec", "batch_size"}
    assert got["_type"] == want["_type"] == "data_benchmark"
    assert got["total_clips"] == want["total_clips"] == 8
    assert got["batch_size"] == want["batch_size"] == 2
    assert got["clips_per_sec"] > 0 and 0 < got["med_iter_sec"] <= \
        got["p95_iter_sec"] <= got["wall_sec"]


def test_benchmark_cli_reads_the_benchmark_keys(clips, tmp_path):
    cfg = _cfg(get_cfg, clips)
    path = tmp_path / "bench.yaml"
    path.write_text(cfg.dump())
    stats = tbenchmark.main(["--cfg", str(path), "BENCHMARK.NUM_EPOCHS", "1",
                             "BENCHMARK.SHUFFLE", "False"])
    assert stats["total_clips"] == 4 and stats["batch_size"] == 2


def test_benchmark_decode_prints_a_line_a_backend(capsys):
    results = benchmark_decode.main(["--seconds", "1", "3", "--reps", "2",
                                     "--num_frames", "4"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    head, rows = lines[0], lines[1:]
    assert head["metric"] == "clip_decode_backends"
    assert "cv2" in head["present"]
    assert {"decord", "pyav"} <= set(head["present"]) | set(head["absent"])
    assert [r["metric"] for r in rows] == [
        f"clip_decode_ms[{b}]" for b in head["present"]]
    for r in rows:
        assert set(r) == {"metric", "1s", "3s", "long_over_short"}
        assert r["1s"] > 0 and r["3s"] > 0
    assert set(results) == set(head["present"])


def test_ffmpeg_clip_holds_the_sampled_frames(tmp_path):
    """The FFmpeg backend's clip after its seek: bit for bit the frames at
    the indices the cv2 path samples, as a sequential decode from frame 0
    gives them."""
    from aicity_action_tpu_torch import native
    from aicity_action_tpu_torch.data import decoder

    if not native.ffmpeg_available():
        pytest.skip("no FFmpeg development files: the ffmpeg backend is "
                    "absent here")
    path = str(tmp_path / "v.mp4")
    benchmark_decode.write_video(path, 3)
    clip = benchmark_decode.ffmpeg_clip(path, 4, 4, clip_idx=3)
    n, fps = decoder.cv2_video_meta(path)
    s, e = decoder.get_start_end_idx(
        n, decoder.clip_size_in_frames(4, 4, fps, 30.0), 3, 5)
    idx = decoder.sample_indices(s, e, 4, n)
    assert idx[0] > 0 and clip.shape == (4, 96 * 3 // 2, 96)
    frames = []
    with native.VideoDecoderI420(path, 96) as dec:
        row = np.empty((144, 96), np.uint8)
        while dec.read(row):
            frames.append(row.copy())
    np.testing.assert_array_equal(clip, np.stack(frames)[idx])
