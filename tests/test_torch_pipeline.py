"""The PyTorch port's decode side against the JAX package's, on the CPU,
over a 64x48 mp4 written by cv2 and a 64x48 YUV4MPEG2 file written by
numpy.

- The port's FFmpeg library (``aicity_action_tpu_torch/native``): its
  metadata equals the JAX package's ``cv2_video_meta``, and its I420 chunks
  equal the JAX package's own FFmpeg decoder's bit for bit (full frame and
  an even ROI).
- ``stream_chunks_parallel`` equals ``stream_chunks`` bit for bit (EOF
  padding and ``max_chunks`` included), on both decoders.
- The FFmpeg path runs with ``sys.modules["cv2"] = None``: it needs no cv2.
- Without FFmpeg's development files the dataset decodes with cv2, and
  asking for the library raises; where they are found, a failed build
  raises. Decode errors reach the scorer's caller, a scoring error stops
  the decoding, unported branches raise; ``run_temporal_inf`` drives the
  parallel decoders and the exact-RGB path.

The scoring paths against the JAX scorer's are in
``test_torch_gather_paths.py`` and ``test_torch_host_paths.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from aicity_action_tpu.data.decoder import cv2_video_meta
from aicity_action_tpu.pipeline import window_inference as jwi
from aicity_action_tpu_torch import native
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data.decoder import video_meta, write_y4m
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.pipeline import window_inference as twi
from torch_port_helpers import synthetic_i420, tiny_cfg, write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

DS_ARGS = dict(frame_length=4, frame_stride=4, proposal_stride=16,
               frame_size=32)
EVEN_ROI = (0.25, 0.125, 0.75, 0.875)  # (16, 6, 48, 42) px of 64x48


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipe")
    mp4, y4m = str(d / "clip.mp4"), str(d / "clip.y4m")
    write_mp4(mp4, 90)
    write_y4m(y4m, synthetic_i420(70))
    write_y4m(str(d / "long.y4m"), synthetic_i420(240))
    return {"mp4": mp4, "y4m": y4m, "long": str(d / "long.y4m")}


@pytest.fixture(scope="module")
def model():
    return build_model(tiny_cfg(get_cfg), device="cpu")


def _take(gen, n):
    out = [next(gen) for _ in range(n)]
    gen.close()
    return out


def _assert_same_preds(a, b):
    assert [p[:2] for p in a] == [p[:2] for p in b]
    for x, y in zip(a, b):
        assert x[2].dtype == np.float32 and x[2].shape == (18,)
        np.testing.assert_array_equal(x[2], y[2])


@pytest.mark.parametrize("kind", ["mp4", "y4m"])
def test_video_meta_matches_jax_cv2_meta(videos, kind, monkeypatch):
    path = videos[kind]
    meta = native.video_meta(path)
    assert (meta.width, meta.height, meta.yuv420p) == (64, 48, True)
    want = cv2_video_meta(path)
    assert want == ((90, 30.0) if kind == "mp4" else (70, 30.0))
    assert video_meta(path) == (meta.frames, meta.fps) == want
    monkeypatch.setenv("AICITY_VDEC", "0")
    assert video_meta(path) == want
    assert native.video_meta(path + ".missing") is None


@pytest.mark.parametrize("roi", [None, EVEN_ROI])
@pytest.mark.parametrize("kind", ["mp4", "y4m"])
def test_vdec_chunks_match_jax_decoder_bitwise(videos, kind, roi):
    args = dict(DS_ARGS, **({"roi": roi} if roi else {}))
    ref_ds = jwi.WindowDataset(videos[kind], **args)
    ds = twi.WindowDataset(videos[kind], **args)
    n = ds.num_frames // 32 + 2  # the full chunks, the EOF one, a pad
    ref = _take(ref_ds.stream_chunks(32, yuv420=True), n)
    out = _take(ds.stream_chunks(32), n)
    assert ref_ds.last_decode_backend == ds.last_decode_backend == "vdec"
    for a, b in zip(out, ref):
        assert a.shape == (32, 48, 32) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(out[0][0], out[0][1])


@pytest.mark.parametrize("decoder,rgb,yuv420", [
    ("vdec", True, True), ("cv2", True, True), ("cv2", False, False)])
def test_parallel_decode_equals_sequential(videos, monkeypatch, decoder,
                                           rgb, yuv420):
    if decoder == "cv2":
        monkeypatch.setenv("AICITY_VDEC", "0")

    def mk():
        return twi.WindowDataset(videos["mp4"], roi=EVEN_ROI, **DS_ARGS)

    # 90 frames in chunks of 24: three full, a partial of 18, then pads
    seq_ds = mk()
    seq = _take(seq_ds.stream_chunks(24, rgb=rgb, yuv420=yuv420), 6)
    par_ds = mk()
    par = _take(par_ds.stream_chunks_parallel(24, 3, rgb=rgb, yuv420=yuv420),
                6)
    assert par_ds.last_decode_backend == seq_ds.last_decode_backend == (
        decoder if yuv420 else None)
    for a, b in zip(par, seq):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seq[3][18:], np.broadcast_to(
        seq[3][17], seq[3][18:].shape))
    # no chunk at or past max_chunks is decoded: later ones repeat the last
    # frame decoded
    bounded = _take(mk().stream_chunks_parallel(
        24, 3, rgb=rgb, yuv420=yuv420, max_chunks=2), 3)
    for a, b in zip(bounded[:2], seq[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        bounded[2], np.broadcast_to(seq[1][-1], seq[1].shape))


def test_vdec_path_runs_without_cv2(videos, model, monkeypatch):
    """The card's path (FFmpeg metadata, ROI, sequential and parallel I420
    decode, the device-gather scorer) imports no cv2."""
    want = _take(twi.WindowDataset(videos["y4m"], roi=EVEN_ROI, **DS_ARGS)
                 .stream_chunks(32), 3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    ds = twi.WindowDataset(videos["y4m"], roi=EVEN_ROI, **DS_ARGS)
    for a, b in zip(_take(ds.stream_chunks_parallel(32, 2), 3), want):
        np.testing.assert_array_equal(a, b)
    scorer = twi.WindowScorer(model, batch_size=3, num_workers=2,
                              chunk_frames=24)
    preds = scorer.score_video(ds)
    assert [p[:2] for p in preds] == ds.windows
    assert scorer.last_timers["decoder"] == "vdec"


def test_loader_path_with_a_worker_process(videos, model, monkeypatch):
    """The loader path in a spawned worker process scores as inline."""
    monkeypatch.setenv("AICITY_VDEC", "0")
    ds = twi.WindowDataset(videos["mp4"], **DS_ARGS)
    inline = twi.WindowScorer(model, batch_size=4, num_workers=0)
    spawned = twi.WindowScorer(model, batch_size=4, num_workers=1)
    _assert_same_preds(spawned._score_loader(ds), inline._score_loader(ds))


def test_unported_branches_raise(videos, model):
    with pytest.raises(NotImplementedError, match="window scoring"):
        twi.WindowDataset(videos["mp4"], backend="decord", **DS_ARGS)
    with pytest.raises(NotImplementedError, match="window scoring"):
        twi.WindowDataset(videos["mp4"], backend="pyav", **DS_ARGS)
    # two-pathway windows are ported (the window-streaming path)
    assert twi.WindowDataset(videos["mp4"], arch_pathways=2,
                             **DS_ARGS).arch_pathways == 2
    # detection scoring is ported (whole-frame boxes, the streaming path)
    assert twi.WindowScorer(model, detection=True).detection


def test_decode_errors_reach_the_caller(videos, model, monkeypatch):
    ds = twi.WindowDataset(videos["y4m"], **DS_ARGS)

    def broken(*args, **kwargs):
        yield np.zeros((24, 48, 32), np.uint8)
        raise OSError("disk gone")

    monkeypatch.setattr(ds, "stream_chunks_parallel", broken)
    with pytest.raises(OSError, match="disk gone"):
        twi.WindowScorer(model, batch_size=4, chunk_frames=24).score_video(ds)


def test_a_scoring_error_stops_the_decoding(videos, monkeypatch):
    """The decoder thread stops at the next chunk once the scoring loop has
    raised: it does not decode the rest of the video first."""
    ds = twi.WindowDataset(videos["long"], **DS_ARGS)
    pulled = []

    def chunks(*args, **kwargs):
        while True:
            pulled.append(1)
            yield np.zeros((20, 48, 32), np.uint8)

    class Broken(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x):
            raise RuntimeError("out of memory")

    monkeypatch.setattr(ds, "stream_chunks_parallel", chunks)
    scorer = twi.WindowScorer(Broken(), batch_size=4, chunk_frames=20)
    n_chunks = max(int(p[2][-1]) for p in ds.plans()) // 20 + 1
    with pytest.raises(RuntimeError, match="out of memory"):
        scorer.score_video(ds)
    # one chunk scored, two queued, one held at the full queue
    assert n_chunks == 12 and len(pulled) <= 4


def _fresh_native(monkeypatch, build_dir, packages=None):
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "_lib", [])
    monkeypatch.setattr(native, "_pkg_config", [])
    if packages:
        monkeypatch.setattr(native, "FFMPEG_PACKAGES", packages)


def test_without_ffmpeg_dev_files_the_dataset_decodes_with_cv2(
        videos, monkeypatch, tmp_path):
    """Where pkg-config finds no FFmpeg, metadata and chunks come from cv2
    (as under AICITY_VDEC=0), and asking for the library itself raises with
    pkg-config's words."""
    monkeypatch.setenv("AICITY_VDEC", "0")
    want_ds = twi.WindowDataset(videos["y4m"], **DS_ARGS)
    want = _take(want_ds.stream_chunks(32), 3)
    monkeypatch.delenv("AICITY_VDEC")
    _fresh_native(monkeypatch, tmp_path, ("libavcodec", "libno_such_ffmpeg"))
    assert not native.ffmpeg_available()
    assert video_meta(videos["y4m"]) == cv2_video_meta(videos["y4m"])
    ds = twi.WindowDataset(videos["y4m"], **DS_ARGS)
    for a, b in zip(_take(ds.stream_chunks(32), 3), want):
        np.testing.assert_array_equal(a, b)
    assert ds.last_decode_backend == want_ds.last_decode_backend == "cv2"
    with pytest.raises(RuntimeError, match="libno_such_ffmpeg"):
        native.VideoDecoderI420(videos["y4m"], 32)
    assert "libno_such_ffmpeg" in (tmp_path / "build.log").read_text()


def test_a_failed_native_build_raises(videos, monkeypatch, tmp_path):
    """FFmpeg's development files found but no working compiler: the build
    raises with the compiler's words and nothing falls back to cv2."""
    _fresh_native(monkeypatch, tmp_path)
    monkeypatch.setenv("CXX", "false")
    assert native.ffmpeg_available()
    with pytest.raises(RuntimeError, match="building libvideodec.so failed"):
        twi.WindowDataset(videos["y4m"], **DS_ARGS)
    assert "rc=1" in (tmp_path / "build.log").read_text()


def test_run_temporal_inf_scores_with_parallel_decoders(videos, model,
                                                        tmp_path):
    """The CLI on the FFmpeg path (``--num_workers 3``) writes the pickle
    that ``score_video`` gives, and ``--exact_rgb`` the exact-RGB one."""
    from aicity_action_tpu_torch.tools import run_temporal_inf

    lst = tmp_path / "videos.txt"
    lst.write_text("clip.y4m\n")
    opts = ["DATA.NUM_FRAMES", "4", "MVIT.DEPTH", "4", "MVIT.EMBED_DIM",
            "32", "MVIT.DIM_MUL", "[[1, 2.0], [3, 2.0]]", "MVIT.HEAD_MUL",
            "[[1, 2.0], [3, 2.0]]", "MVIT.POOL_Q_STRIDE",
            "[[1, 1, 2, 2], [3, 1, 2, 2]]", "TPU.COMPUTE_DTYPE", "float32",
            "NUM_GPUS", "1"]
    for extra in ([], ["--exact_rgb"]):
        out_dir = tmp_path / f"out{len(extra)}"
        stats = run_temporal_inf.main([
            "--cfg", "configs/AICITY_MVITV2_B_16x4_448.yaml",
            "--video_lst", str(lst), "--video_path",
            os.path.dirname(videos["y4m"]), "--out_dir", str(out_dir),
            "--frame_length", "4", "--frame_size", "32", "--batch_size", "4",
            "--num_workers", "3", "--device", "cpu", *extra, *opts])
        want = twi.WindowScorer(model, batch_size=4, chroma420=not extra)\
            .score_video(twi.WindowDataset(videos["y4m"], **DS_ARGS))
        got = twi.load_window_predictions(str(out_dir / "clip.pkl"))
        _assert_same_preds(got, want)
        timers = stats["clip.y4m"]["timers"]
        assert stats["clip.y4m"]["windows"] == len(want)
        assert timers["decoder"] == ("cv2" if extra else "vdec")
