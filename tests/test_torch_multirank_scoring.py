"""One video's windows over several ranks (``WindowScorer`` in a process
group, ``run_temporal_inf NUM_GPUS 2``) against one process, on the CPU:
two gloo ranks of the CLI, spawned by the CLI itself, score a view of four
chunks (windows that straddle a chunk's end, and one past the view's end)
and a view of one chunk (the second rank's share is empty), and rank 0's
pickles must equal the one-process run's (the same windows in the same
order, scores within atol 1e-5, f32). The tiny MViT-v2 of
``torch_port_helpers.tiny_cfg``; weights from ``RNG_SEED`` on every
rank."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.pipeline.window_inference import rank_chunks
from aicity_action_tpu_torch.tools import run_temporal_inf
from torch_port_helpers import REPO, free_init_method, tiny_cfg, write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

VIEWS = {"long": 90, "short": 20}  # frames at 30 fps
CHUNK = 24  # windows span 16 frames and start every 16


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("multirank")
    for name, frames in VIEWS.items():
        write_mp4(str(d / f"{name}.mp4"), num_frames=frames, seed=7)
    (d / "videos.txt").write_text("".join(f"{n}.mp4\n" for n in VIEWS))
    cfg = tiny_cfg(get_cfg)
    cfg.MODEL.ACT_CHECKPOINT = False
    (d / "tiny.yaml").write_text(cfg.dump())
    return d


def _argv(d, out):
    return ["--cfg", str(d / "tiny.yaml"), "--video_lst",
            str(d / "videos.txt"), "--video_path", str(d), "--out_dir",
            str(d / out), "--frame_length", "4", "--frame_size", "32",
            "--batch_size", "2", "--num_workers", "2", "--chunk_frames",
            str(CHUNK), "--device", "cpu"]


def test_rank_shares_are_contiguous_and_cover_the_chunks():
    for n in range(7):
        for world in (1, 2, 3):
            shares = [rank_chunks(n, world, r) for r in range(world)]
            assert shares[0][0] == 0 and shares[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            sizes = [hi - lo for lo, hi in shares]
            assert max(sizes) - min(sizes) <= 1
    # the long view: windows from frames 0, 16, ..., 80 start in chunks
    # 0, 0, 1, 2, 2, 3; the short one's two in chunk 0 only
    assert [rank_chunks(4, 2, r) for r in range(2)] == [(0, 2), (2, 4)]
    assert [rank_chunks(1, 2, r) for r in range(2)] == [(0, 1), (1, 1)]


def test_two_ranks_write_the_one_process_pickles(tree):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "aicity_action_tpu_torch.tools."
         "run_temporal_inf", *_argv(tree, "two"), "NUM_GPUS", "2",
         "DIST_BACKEND", "gloo", "INIT_METHOD", free_init_method()],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        stats = run_temporal_inf.main(_argv(tree, "one") + ["NUM_GPUS", "1"])
        log, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-6000:]
    assert {v: s["windows"] for v, s in stats.items()} == {
        "long.mp4": 6, "short.mp4": 2}
    assert sorted(os.listdir(tree / "two")) == ["long.pkl", "short.pkl"]
    for name in VIEWS:
        with open(tree / "one" / f"{name}.pkl", "rb") as f:
            want = pickle.load(f)
        with open(tree / "two" / f"{name}.pkl", "rb") as f:
            got = pickle.load(f)
        assert [(t0, t1) for t0, t1, _ in got] == \
            [(t0, t1) for t0, t1, _ in want]
        for (_, _, a), (_, _, b) in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # each rank logged its share: the long view split 3 + 3 windows, the
    # short one 2 + 0
    assert "'windows': 3" in log and "'windows': 0" in log
