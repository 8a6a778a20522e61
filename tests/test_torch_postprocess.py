"""The PyTorch port's post-processing, annotation tools, AI City CLIs and
partial checkpoint load against the JAX package's functions, on the CPU.

Synthetic window pickles (three views of two videos, scores made with
numpy from a seed) and synthetic annotation csvs go through both packages:
integers and strings must agree exactly, scores and thresholds within
1e-6. The port's CLIs run in process; their output files are held to the
JAX package's functions on the same inputs. ``load_test_checkpoint`` is
held to the JAX package's shape-matched merge of the same ``torch.save``d
checkpoint.
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

from aicity_action_tpu.pipeline import anno as janno
from aicity_action_tpu.pipeline import postprocess as jpp
from aicity_action_tpu.utils.convert import (convert_mvit_state_dict,
                                             merge_with_model_params)
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data.decoder import video_meta, write_y4m
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.pipeline import anno as tanno
from aicity_action_tpu_torch.pipeline import postprocess as tpp
from aicity_action_tpu_torch.pipeline.window_inference import (
    save_window_predictions)
from aicity_action_tpu_torch.tools import (aicity_convert_anno, aicity_inf,
                                           aicity_inf_graph,
                                           aicity_split_anno)
from aicity_action_tpu_torch.utils import checkpoint as tckpt
from torch_port_helpers import jax_tiny_params_from_port, tiny_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASS = 18
USERS = ("24026", "35133")
VIEWS = ("Dashboard", "Rear_view", "Right_side_window")
CLASSES = list(range(1, NUM_CLASS))


def _file_id(view, user, perform="0"):
    return f"{view}_user_id_{user}_NoAudio_{perform}"


def _windows(rng, n_frames, stride=16, length=64):
    out = []
    for t0 in range(0, n_frames, stride):
        s = rng.dirichlet(np.full(NUM_CLASS, 0.3)).astype(np.float32)
        out.append((t0, t0 + length, s))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Window pickles of 3 views x 2 videos, the clip-annotation csv of a
    labeled split over them, and the video csv that joins the views."""
    d = tmp_path_factory.mktemp("torch_pp")
    rng = np.random.default_rng(0)
    preds = {}
    for u, user in enumerate(USERS):
        for view in VIEWS:
            fid = _file_id(view, user)
            preds[fid] = _windows(rng, 600 + 97 * u)
            save_window_predictions(preds[fid], str(d / f"{fid}.pkl"))
    rows = []
    for user in USERS:
        for c, (t0, t1) in zip((1, 2, 3, 5), ((0, 4), (4, 9), (9, 14),
                                              (14, 19))):
            for view in VIEWS:
                rows.append(f"{_file_id(view, user)}.{user}.{t0}.{t1}.MP4 {c}")
    (d / "val.csv").write_text("\n".join(rows) + "\n")
    vid_csv = ["video_id,view1,view2,view3"] + [
        f"{i + 1}," + ",".join(_file_id(v, user) for v in VIEWS)
        for i, user in enumerate(USERS)]
    (d / "vid.csv").write_text("\n".join(vid_csv) + "\n")
    return d, preds


def _anno_data(path):
    out = {}
    for line in open(path):
        video_file, c = line.split()
        fid, user, t0, t1, _ = video_file.split(".")
        out.setdefault(f"{user}_{fid[-1]}", []).append(
            (fid, user, int(t0), int(t1), int(c)))
    return out


@pytest.mark.parametrize("agg", [np.mean, np.max, np.median])
def test_aggregate_predictions_matches_jax(data, agg):
    for preds in list(data[1].values())[:2]:
        np.testing.assert_allclose(
            tpp.aggregate_predictions(preds, agg, NUM_CLASS),
            jpp.aggregate_predictions(preds, agg, NUM_CLASS),
            rtol=0, atol=1e-6)


def _same_chunks(a, b):
    assert [c[:3] for c in a] == [c[:3] for c in b]
    for x, y in zip(a, b):
        assert abs(x[3] - y[3]) <= 1e-6
        np.testing.assert_allclose(x[4], y[4], rtol=0, atol=1e-6)


def test_get_chunks_matches_jax_and_drops_a_run_at_the_last_frame():
    rng = np.random.default_rng(1)
    for scores in [rng.random(200), np.array([0.1, 0.9, 0.9, 0.1, 0.1, 0.9]),
                   np.array([0.9, 0.9, 0.2, 0.9, 0.95])]:
        _same_chunks(tpp.get_chunks(scores, 0.5), jpp.get_chunks(scores, 0.5))
    # a run that starts at the last frame never closes (docs/DESIGN.md:107)
    assert tpp.get_chunks(np.array([0.1, 0.1, 0.9]), 0.5) == []
    assert [c[:3] for c in tpp.get_chunks(np.array([0.1, 0.9, 0.9]), 0.5)] \
        == [(1, 2, 2)]


@pytest.mark.parametrize("take", ["min", "max", "mean"])
def test_thresholds_chunks_and_f1_match_jax(data, take):
    d, preds = data
    per_frame = {k: jpp.aggregate_predictions(v, np.mean, NUM_CLASS)
                 for k, v in preds.items()}
    anno = _anno_data(d / "val.csv")
    thr = tpp.derive_thresholds(anno, per_frame, CLASSES, thres_take=take)
    ref = jpp.derive_thresholds(anno, per_frame, CLASSES, thres_take=take)
    assert sorted(thr) == sorted(ref)
    for c in thr:
        assert abs(thr[c] - ref[c]) <= 1e-6
    for sort_base in ("length", "score"):
        chunks = {k: tpp.chunks_for_video(v, ref, use_num_chunk=2,
                                          sort_base=sort_base)
                  for k, v in per_frame.items()}
        ref_chunks = {k: jpp.chunks_for_video(v, ref, use_num_chunk=2,
                                              sort_base=sort_base)
                      for k, v in per_frame.items()}
        assert chunks == ref_chunks
        for kw in ({}, {"use_tight_times": True}, {"use_ori_times": True}):
            assert tpp.compute_f1(anno, CLASSES, chunks, use_num_chunk=2,
                                  chunk_sort_base=sort_base, return_pr=True,
                                  **kw) == jpp.compute_f1(
                anno, CLASSES, ref_chunks, use_num_chunk=2,
                chunk_sort_base=sort_base, return_pr=True, **kw)
        views = {str(i): [_file_id(v, u) for v in VIEWS]
                 for i, u in enumerate(USERS)}
        rows = tpp.merge_views_to_submission(views, chunks, ref,
                                             sort_base=sort_base)
        assert rows == jpp.merge_views_to_submission(
            views, ref_chunks, ref, sort_base=sort_base)


@pytest.mark.parametrize("text", ["0:00", "1:05", "12:59"])
def test_time_helpers_match_jax(text):
    assert tanno.time2int(text) == janno.time2int(text)
    secs = janno.time2int(text) + 0.25
    assert tanno.int2time(secs) == janno.int2time(secs)


@pytest.mark.parametrize("user,view", [
    ("24026", "Rightside window"), ("38508", "Rearview"), ("49381",
                                                          "Rear_view"),
    ("35133", "Dashboard")])
def test_normalize_file_name_matches_jax(user, view):
    name = f"{view}_{user}_NoAudio_7"
    assert tanno.normalize_file_name(name, user, view) == \
        janno.normalize_file_name(name, user, view)


def _raw_annotations(path):
    lines = ["User ID,Filename,Camera View,Activity Type,Start Time,"
             "End Time,Label,Appearance Block"]
    for user in ("24026", "35133"):
        for view in ("Dashboard", "Rearview", "Rightside window"):
            t = 0
            for c in ("1", "NA", "4"):
                lines.append(f"{user},{view}_{user}_NoAudio_2,{view},x,"
                             f"0:{t + 1:02d},0:{t + 4:02d},{c},None")
                t += 5
    path.write_text("\n".join(lines) + "\n")


def test_convert_and_split_cli_match_jax(tmp_path):
    raw = tmp_path / "raw.csv"
    _raw_annotations(raw)
    videos = tmp_path / "videos"
    videos.mkdir()
    # two of the six videos exist, 20 s each (YUV4MPEG2 content under the
    # .MP4 name): their length fills the tail gap; the others get none
    frames = np.full((600, 36, 32), 128, np.uint8)
    for view in ("Dashboard", "Rear_view"):
        write_y4m(str(videos / f"{view}_User_id_24026_NoAudio_2.MP4"),
                  frames)
    rows = aicity_convert_anno.main([
        str(raw), str(videos), str(tmp_path / "clips.txt"),
        str(tmp_path / "cmds.sh"), "/clips"])

    def length(video_file):
        p = os.path.join(str(videos), video_file)
        if not os.path.exists(p):
            return None
        n, fps = video_meta(p)
        return n / fps

    ref = janno.convert_annotations(
        str(raw), length, out_anno_file=str(tmp_path / "ref_clips.txt"),
        clip_cmds_file=str(tmp_path / "ref_cmds.sh"),
        video_path=str(videos), target_path="/clips")
    assert rows == ref and len(rows) > 18
    for name in ("clips.txt", "cmds.sh"):
        assert (tmp_path / name).read_text() == \
            (tmp_path / f"ref_{name}").read_text()
    tails = [r[0] for r in rows if r[0].endswith(".14.20.MP4")]
    assert len(tails) == 2 and all(r[1] == -2 for r in rows
                                   if r[0] in tails)

    for method in (1, 2):
        dirs = aicity_split_anno.main([
            str(tmp_path / "clips.txt"), str(tmp_path / f"splits{method}"),
            "--method", str(method)])
        ref_dirs = janno.make_user_splits(
            str(tmp_path / "clips.txt"), str(tmp_path / f"ref{method}"),
            method)
        assert len(dirs) == len(ref_dirs) == 2
        for a, b in zip(dirs, ref_dirs):
            for name in ("train.csv", "val.csv"):
                assert open(os.path.join(a, name)).read() == \
                    open(os.path.join(b, name)).read()


def test_inf_graph_and_inf_clis_match_jax(data, tmp_path, capsys):
    d, preds = data
    thr_file = tmp_path / "thr.txt"
    out = aicity_inf_graph.main([str(d / "val.csv"), str(d),
                                 "--thres_file", str(thr_file)])
    per_frame = {k: jpp.aggregate_predictions(v, np.mean, NUM_CLASS)
                 for k, v in preds.items()}
    anno = _anno_data(d / "val.csv")
    ref_thr = jpp.derive_thresholds(anno, per_frame, CLASSES)
    written = dict(line.split() for line in thr_file.read_text().split("\n")
                   if line)
    assert written == {str(c): f"{ref_thr[c]:.5f}" for c in CLASSES}
    ref_chunks = {k: jpp.chunks_for_video(v, ref_thr)
                  for k, v in per_frame.items()}
    ref_f1 = jpp.compute_f1(anno, CLASSES, ref_chunks, return_pr=True)
    assert (out["f1"], out["precision"], out["recall"]) == ref_f1
    assert f"F1, precision, recall: {ref_f1[0]:.6f}" in capsys.readouterr().out

    sub = tmp_path / "sub.txt"
    rows = aicity_inf.main([str(d), str(thr_file), str(d / "vid.csv"),
                            str(sub), "--agg_method", "max"])
    thr = {int(k): float(v) for k, v in written.items()}
    views = {str(i + 1): [_file_id(v, u) for v in VIEWS]
             for i, u in enumerate(USERS)}
    chunks = {k: jpp.chunks_for_video(
        jpp.aggregate_predictions(v, np.max, NUM_CLASS), thr)
        for k, v in preds.items()}
    ref_rows = jpp.merge_views_to_submission(views, chunks, thr)
    assert rows == ref_rows and rows
    jpp.write_submission(ref_rows, str(tmp_path / "ref_sub.txt"))
    assert sub.read_text() == (tmp_path / "ref_sub.txt").read_text()


def test_inf_graph_draws_curves_or_says_why_not(data, tmp_path,
                                                monkeypatch):
    d, _ = data
    pytest.importorskip("matplotlib")
    one = tmp_path / "one.csv"  # one (video, class): one figure
    one.write_text("".join(ln + "\n" for ln in (d / "val.csv").read_text()
                           .split("\n") if ln.endswith(".MP4 1")
                           and USERS[0] in ln))
    aicity_inf_graph.main([str(one), str(d), "--graph_path",
                           str(tmp_path / "g")])
    assert os.listdir(tmp_path / "g") == ["24026_0.action_1.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        aicity_inf_graph.main([str(one), str(d), "--graph_path",
                               str(tmp_path / "h")])
    assert not os.path.exists(tmp_path / "h")


def test_load_test_checkpoint_merges_by_shape_like_jax(tmp_path, caplog):
    """A ``torch.save``d checkpoint (DDP names) with one shape-mismatched
    key, one key the model lacks and one parameter missing: the port loads
    what the JAX package's merge loads, keeps the model's own values
    elsewhere, and logs the same counts."""
    cfg = tiny_cfg(get_cfg)
    src = build_model(cfg, device="cpu", seed=5).state_dict()
    state = {f"module.{k}": v for k, v in src.items()}
    state["module.head.projection.weight"] = torch.zeros(7, 128)
    state["module.extra.weight"] = torch.ones(3)
    del state["module.norm.bias"]
    path = str(tmp_path / "ckpt.pyth")
    torch.save({"model_state": state, "epoch": 3}, path)

    model = build_model(cfg, device="cpu", seed=6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg.TEST.CHECKPOINT_FILE_PATH = path
    with caplog.at_level(logging.INFO):
        tckpt.load_test_checkpoint(cfg, model)
    after = model.state_dict()

    converted, skipped = convert_mvit_state_dict(
        {k: v.numpy() for k, v in state.items()})
    _, loaded, mismatched, missing = merge_with_model_params(
        converted, jax_tiny_params_from_port(seed=6))
    want = (f"torch load: {len(loaded)} loaded, "
            f"{len(mismatched) + len(skipped)} shape-mismatched, "
            f"{len(missing)} missing")
    assert want == f"torch load: {len(src) - 2} loaded, 2 shape-mismatched, " \
        f"1 missing"
    assert want in caplog.text
    assert "mismatch head.projection.weight: ckpt (7, 128) vs model " \
        "(18, 128)" in caplog.text
    for k in after:
        keep = k in ("head.projection.weight", "norm.bias")
        assert torch.equal(after[k], before[k] if keep else src[k]), k

    # a Caffe2 .pkl loads through the reference's name chain, by shape
    import pickle

    bias = np.arange(18, dtype=np.float32)
    with open(tmp_path / "ckpt.pkl", "wb") as f:
        pickle.dump({"blobs": {"pred_b": bias, "model_iter": np.int64(1),
                               "pred_b_momentum": bias}}, f)
    cfg.TEST.CHECKPOINT_FILE_PATH = str(tmp_path / "ckpt.pkl")
    tckpt.load_test_checkpoint(cfg, model)
    assert np.array_equal(model.state_dict()["head.projection.bias"].numpy(),
                          bias)
