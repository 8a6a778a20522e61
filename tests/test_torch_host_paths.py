"""The PyTorch port's loader scorer against the JAX package's, on the CPU,
with the tiny MViT-v2 in f32 over a 64x48 mp4 written by cv2 (both decode
with cv2, ``AICITY_VDEC=0``): a seek per window, in a
``torch.utils.data.DataLoader`` here, the JAX package's ``Loader`` there.
Max abs error of the window scores 2e-5 (f32, the model bound of
PARITY.md).
"""

import numpy as np
import pytest

from aicity_action_tpu.pipeline import window_inference as jwi
from aicity_action_tpu_torch.pipeline import window_inference as twi
from torch_port_helpers import scorer_models, write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

TOL = 2e-5
DS_ARGS = dict(frame_length=4, frame_stride=4, proposal_stride=16,
               frame_size=32)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scoring")
    mp4 = str(d / "clip.mp4")
    write_mp4(mp4, 90)
    return {"mp4": mp4}


@pytest.fixture(scope="module")
def models():
    return scorer_models(4)


def _assert_same_preds(a, b):
    assert [p[:2] for p in a] == [p[:2] for p in b]
    for x, y in zip(a, b):
        assert x[2].dtype == np.float32 and x[2].shape == (18,)
        np.testing.assert_allclose(x[2], y[2], rtol=0, atol=TOL)


def test_loader_path_matches_jax(videos, models, monkeypatch):
    monkeypatch.setenv("AICITY_VDEC", "0")
    module, params, mesh, model = models
    ref = jwi.WindowScorer(module, params, mesh, batch_size=4,
                           num_workers=2).score_video(
        jwi.WindowDataset(videos["mp4"], **DS_ARGS), streaming=False)
    scorer = twi.WindowScorer(model, batch_size=4, num_workers=0)
    scorer.last_timers = {"stale": True}
    ds = twi.WindowDataset(videos["mp4"], **DS_ARGS)
    preds = scorer.score_video(ds, streaming=False)
    _assert_same_preds(preds, ref)
    assert scorer.last_timers is None  # reset by every score_video
    inputs, t0, t1 = ds[1]
    ref_inputs, r0, r1 = jwi.WindowDataset(videos["mp4"], **DS_ARGS)[1]
    assert (t0, t1) == (r0, r1)
    np.testing.assert_array_equal(inputs[0], ref_inputs[0])
