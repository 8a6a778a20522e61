"""The port's released-checkpoint fire drill (``tools.fire_drill``) end to
end on the CPU, as the JAX package's ``tests/test_fire_drill.py`` drives
its own: a tiny ``.pyth`` of the port's MViT-v2 drawn from seed 0, two
written views, a threshold file and an annotation csv, the chain
``run_temporal_inf`` -> ``aicity_inf`` -> ``aicity_inf_graph`` as
subprocesses. Every stage runs, the load counts show a clean load, the F1
is finite, and a second run skips the scoring stage."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models.build import build_model
from torch_port_helpers import REPO, tiny_cfg, write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _drill(argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "aicity_action_tpu_torch.tools.fire_drill",
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)


def _summary(stdout):
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("[fire_drill] {")]
    assert lines, stdout[-2000:]
    return json.loads(lines[-1].split(" ", 1)[1])


def test_fire_drill_end_to_end(tmp_path):
    cfg = tiny_cfg(get_cfg)
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.NUM_GPUS = 1  # the YAML's 8 are the training recipe's cards
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    (tmp_path / "tiny.yaml").write_text(cfg.dump())
    model = build_model(cfg, device="cpu", seed=0)
    pyth = str(tmp_path / "released.pyth")
    torch.save({"model_state": model.state_dict(), "epoch": 1}, pyth)
    for i, name in enumerate(("v0", "v1")):
        write_mp4(str(tmp_path / f"{name}.mp4"), num_frames=40, seed=i)
    (tmp_path / "videos.lst").write_text("v0.mp4\nv1.mp4\n")
    (tmp_path / "vids.csv").write_text("video_id,f1,f2,f3\n1,v0,v1,v0\n")
    (tmp_path / "thres.txt").write_text(
        "".join(f"{c} 0.05\n" for c in range(1, 18)))
    # annotation rows: file_id.user_id.t0.t1.MP4 label
    (tmp_path / "anno.csv").write_text("v0.u1.0.1.MP4 2\nv1.u1.0.1.MP4 3\n")
    argv = ["--pyth", pyth, "--cfg", str(tmp_path / "tiny.yaml"),
            "--video_lst", str(tmp_path / "videos.lst"),
            "--video_path", str(tmp_path),
            "--vid_csv", str(tmp_path / "vids.csv"),
            "--thres_file", str(tmp_path / "thres.txt"),
            "--out_dir", str(tmp_path / "drill"),
            "--anno_csv", str(tmp_path / "anno.csv"), "--device", "cpu",
            "--frame_length", "4", "--frame_stride", "2",
            "--proposal_stride", "8", "--frame_size", "32",
            "--batch_size", "4", "--num_workers", "2"]
    r = _drill(argv)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert os.path.exists(tmp_path / "drill" / "submission.txt")
    assert os.path.exists(tmp_path / "drill" / "preds" / "v0.pkl")
    summary = _summary(r.stdout)
    assert summary["load"] == {"loaded": len(model.state_dict()),
                               "shape_mismatched": 0, "missing_in_ckpt": 0}
    assert summary["preds"] == 2
    assert np.isfinite(summary["f1"])
    # a rerun skips the scoring stage and gives the same summary
    r2 = _drill(argv + ["--expect_f1", str(summary["f1"])])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert r2.stdout.count("skipping") == 1, r2.stdout[-2000:]
    assert _summary(r2.stdout) == summary
