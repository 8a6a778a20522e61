"""The PyTorch port's sliding-window scorer against the JAX package's, on
the CPU, over a tiny synthetic video written with cv2.

Both decode the same file with cv2 into planar I420 chunks (the JAX side's
FFmpeg decoder is switched off with ``AICITY_VDEC=0``), convert I420 to RGB
on their device, and score with the same tiny MViT-v2 weights in f32. The
port's scorer runs with small chunks so that windows straddle chunk
boundaries. Tolerance for the window scores: max abs error 2e-5 (f32, the
model bound of PARITY.md); the I420 conversion, the window spans and the
chunks must agree exactly (the I420 conversion to 1e-4, f32 rounding of
the same formula).
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.parallel.mesh import make_mesh
from aicity_action_tpu.pipeline import postprocess as jpp
from aicity_action_tpu.pipeline import window_inference as jwi
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.pipeline import window_inference as twi
from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict
from torch_port_helpers import jax_tiny_model, perturb, tiny_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

TOL = 2e-5
DS_ARGS = dict(frame_length=4, frame_stride=4, proposal_stride=16,
               frame_size=32)


def _write_video(path, num_frames, fps=30, size=(64, 48), seed=0):
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    yy, xx = np.mgrid[0:size[1], 0:size[0]]
    for i in range(num_frames):
        frame = np.stack([(xx * 4 + i * 5) % 256, (yy * 5 + i * 3) % 256,
                          rng.integers(0, 256, xx.shape)], -1)
        w.write(frame.astype(np.uint8))
    w.release()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_wi") / "clip.mp4")
    _write_video(path, 90)
    return path


@pytest.fixture(autouse=True)
def _cv2_decoder(monkeypatch):
    monkeypatch.setenv("AICITY_VDEC", "0")


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg(jax_get_cfg)
    # remat is a training knob, and the JAX scorer's jit of a remat'ed
    # block traces the static (T, H, W); inference needs neither
    cfg.MODEL.ACT_CHECKPOINT = False
    module, params = jax_tiny_model()
    params = perturb(params, 5)
    model = build_model(tiny_cfg(get_cfg), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    mesh = make_mesh(cfg, devices=jax.devices()[:1])
    return module, params, mesh, model


def test_i420_to_rgb_matches_jax():
    yuv = np.random.default_rng(0).integers(
        0, 256, (2, 3, 48, 32), dtype=np.uint8)
    ref = np.asarray(jwi.i420_to_rgb(jax.numpy.asarray(yuv), 32))
    out = twi.i420_to_rgb(torch.from_numpy(yuv), 32).numpy()
    assert out.shape == ref.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fps", [30, 60])
def test_window_spans_and_plans_match_jax(tmp_path, fps):
    path = str(tmp_path / f"v{fps}.mp4")
    _write_video(path, 70, fps=fps)
    ref = jwi.WindowDataset(path, **DS_ARGS)
    ds = twi.WindowDataset(path, **DS_ARGS)
    assert (ds.num_frames, ds.fps) == (ref.num_frames, ref.fps)
    assert ds.windows == ref.windows
    for (t0, t1, idx), (r0, r1) in zip(ds.plans(), ref.windows):
        assert (t0, t1) == (r0, r1)
        np.testing.assert_array_equal(
            idx, jwi.sample_indices(r0, r1, 4, ref.num_frames))


def test_stream_chunks_match_jax_bitwise(video):
    ref = jwi.WindowDataset(video, **DS_ARGS).stream_chunks(32, yuv420=True)
    out = twi.WindowDataset(video, **DS_ARGS).stream_chunks(32)
    for _ in range(4):  # 90 frames: two full chunks, the EOF one, a pad
        a, b = next(out), next(ref)
        assert a.shape == (32, 48, 32) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_window_scorer_matches_jax(video, models, tmp_path):
    module, params, mesh, model = models
    ref = jwi.WindowScorer(module, params, mesh, batch_size=4,
                           num_workers=1).score_video(
        jwi.WindowDataset(video, **DS_ARGS))
    ds = twi.WindowDataset(video, **DS_ARGS)
    preds = twi.WindowScorer(model, batch_size=3,
                             chunk_frames=24).score_video(ds)
    assert [p[:2] for p in preds] == [p[:2] for p in ref] == ds.windows
    for a, b in zip(preds, ref):
        assert a[2].dtype == np.float32 and a[2].shape == (18,)
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=TOL)

    # the port's pickle is the JAX package's: its loader and the
    # post-processing that tools/aicity_inf.py runs read it
    pkl = str(tmp_path / "clip.pkl")
    twi.save_window_predictions(preds, pkl)
    assert not os.path.exists(pkl + ".tmp")
    loaded = jwi.load_window_predictions(pkl)
    assert [p[:2] for p in loaded] == [p[:2] for p in preds]
    per_frame = jpp.aggregate_predictions(loaded, np.mean, 18)
    np.testing.assert_allclose(per_frame.sum(axis=1), 1.0, rtol=1e-3)
    assert twi.load_window_predictions(pkl)[0][0] == 0


def test_score_chunks_is_independent_of_chunking(models):
    """One iterator of in-memory I420 chunks, scored with two chunk sizes
    and batch sizes, gives the same windows and scores."""
    model = models[3]
    rng = np.random.default_rng(7)
    n = 75
    video = rng.integers(0, 256, (n, 48, 32), dtype=np.uint8)
    plans = twi.window_plans(twi.window_spans(n, 30.0, 4, 4, 16, 30.0), 4, n)

    def chunks(f):
        c0 = 0
        while True:
            part = video[c0:c0 + f]
            pad = np.repeat(video[-1:], f - len(part), 0)
            yield np.concatenate([part, pad])
            c0 += f

    mean, std = (0.45,) * 3, (0.225,) * 3
    small = twi.WindowScorer(model, batch_size=2, chunk_frames=20)
    big = twi.WindowScorer(model, batch_size=8, chunk_frames=128)
    a = small.score_chunks(chunks(20), plans, 32, mean, std)
    b = big.score_chunks(chunks(128), plans, 32, mean, std)
    assert [p[:2] for p in a] == [p[:2] for p in b] == [p[:2] for p in plans]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x[2], y[2], rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        twi.WindowScorer(model, chunk_frames=8).score_chunks(
            chunks(8), plans, 32, mean, std)


def test_run_temporal_inf_cli_writes_readable_pickles(video, tmp_path):
    from aicity_action_tpu_torch.tools import run_temporal_inf

    lst = tmp_path / "videos.txt"
    lst.write_text(os.path.basename(video) + "\n")
    out_dir = tmp_path / "out"
    opts = ["DATA.NUM_FRAMES", "4", "MVIT.DEPTH", "4", "MVIT.EMBED_DIM",
            "32", "MVIT.DIM_MUL", "[[1, 2.0], [3, 2.0]]", "MVIT.HEAD_MUL",
            "[[1, 2.0], [3, 2.0]]", "MVIT.POOL_Q_STRIDE",
            "[[1, 1, 2, 2], [3, 1, 2, 2]]", "TPU.COMPUTE_DTYPE", "float32"]
    run_temporal_inf.main([
        "--cfg", "configs/AICITY_MVITV2_B_16x4_448.yaml",
        "--video_lst", str(lst), "--video_path", os.path.dirname(video),
        "--out_dir", str(out_dir), "--frame_length", "4", "--frame_size",
        "32", "--batch_size", "4", "--device", "cpu", *opts])
    with open(out_dir / "clip.pkl", "rb") as f:
        preds = pickle.load(f)
    assert [p[:2] for p in preds] == twi.WindowDataset(
        video, **DS_ARGS).windows
    assert all(np.isfinite(p[2]).all() and p[2].shape == (18,)
               for p in preds)
