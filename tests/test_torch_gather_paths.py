"""The PyTorch port's device-gather scorer against the JAX package's, on
the CPU, with the tiny MViT-v2 in f32: the I420 path on chunks from each
package's FFmpeg decoder (a 64x48 YUV4MPEG2 file written by numpy), and
the exact-RGB path (``chroma420=False``: BGR chunks decoded by cv2 from a
64x48 mp4, the channel swap folded into a copy of the patch-embed weight).
Max abs error of the window scores 2e-5 (f32, the model bound of
PARITY.md).
"""

import numpy as np
import pytest
import torch

from aicity_action_tpu.pipeline import window_inference as jwi
from aicity_action_tpu_torch.data.decoder import write_y4m
from aicity_action_tpu_torch.pipeline import window_inference as twi
from torch_port_helpers import scorer_models, synthetic_i420, write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

TOL = 2e-5
DS_ARGS = dict(frame_length=4, frame_stride=4, proposal_stride=16,
               frame_size=32)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scoring")
    mp4, y4m = str(d / "clip.mp4"), str(d / "clip.y4m")
    write_mp4(mp4, 90)
    write_y4m(y4m, synthetic_i420(70))
    return {"mp4": mp4, "y4m": y4m}


@pytest.fixture(scope="module")
def models():
    return scorer_models(3)


def _assert_same_preds(a, b):
    assert [p[:2] for p in a] == [p[:2] for p in b]
    for x, y in zip(a, b):
        assert x[2].dtype == np.float32 and x[2].shape == (18,)
        np.testing.assert_allclose(x[2], y[2], rtol=0, atol=TOL)


def test_device_gather_i420_matches_jax_on_the_ffmpeg_decoder(videos,
                                                              models):
    module, params, mesh, model = models
    ref_ds = jwi.WindowDataset(videos["y4m"], **DS_ARGS)
    ref = jwi.WindowScorer(module, params, mesh, batch_size=4,
                           num_workers=2).score_video(ref_ds)
    ds = twi.WindowDataset(videos["y4m"], **DS_ARGS)
    scorer = twi.WindowScorer(model, batch_size=3, num_workers=3,
                              chunk_frames=24)
    preds = scorer.score_video(ds)
    assert ref_ds.last_decode_backend == "vdec"
    assert [p[:2] for p in preds] == ds.windows
    _assert_same_preds(preds, ref)
    t = scorer.last_timers
    assert t["decoder"] == "vdec" and t["chunks"] == 3 and t["calls"] >= 3
    assert all(t[k] >= 0 for k in ("decode", "upload", "dispatch", "drain"))


def test_device_gather_exact_rgb_matches_jax(videos, models, monkeypatch):
    """``chroma420=False``: BGR chunks, the channel swap folded into the
    patch-embed weight (dim 1 of the port's Conv3d weight, axis 3 of the
    JAX kernel)."""
    monkeypatch.setenv("AICITY_VDEC", "0")
    module, params, mesh, model = models
    ref = jwi.WindowScorer(module, params, mesh, batch_size=4, num_workers=1,
                           chroma420=False).score_video(
        jwi.WindowDataset(videos["mp4"], **DS_ARGS))
    weight = model.patch_embed.proj.weight.clone()
    scorer = twi.WindowScorer(model, batch_size=4, num_workers=2,
                              chunk_frames=32, chroma420=False)
    preds = scorer.score_video(twi.WindowDataset(videos["mp4"], **DS_ARGS))
    _assert_same_preds(preds, ref)
    assert torch.equal(model.patch_embed.proj.weight, weight)
    assert scorer.last_timers["decoder"] == "cv2"
