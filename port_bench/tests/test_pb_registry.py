"""A cell, a mix, a configuration and a metric are new files and entries:
the registry finds them in a checkout without an edit to any file."""

import json
import shutil

from port_bench.registry import Registry
from port_bench.tests.helpers import run_cell

READER = '''"""``windows_total``: every window scored in the window."""


def read(rec):
    return float(rec.windows) if rec.kind == "score" else None
'''


def test_registry_finds_new_files(tiny_checkout, one_thread):
    base = tiny_checkout / "port_bench"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    # a new configuration, mix, limits and metric, as files ...
    shutil.copy(base / "configs" / "tiny.json", base / "configs" / "tiny2.json")
    mix = json.loads((base / "traffic" / "score_tiny.json").read_text())
    mix["batch_size"] = 3
    (base / "traffic" / "score_tiny3.json").write_text(json.dumps(mix))
    (base / "limits" / "tiny2.score3.json").write_text(
        json.dumps({"score_gap": 1e-3}))
    (base / "metrics" / "windows_total.py").write_text(READER)
    # ... and as entries
    bench = json.loads((tiny_checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "x",
                             "file": "port_bench/configs/tiny2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny2.score3", "config": "tiny2",
                               "traffic": "score_tiny3", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "windows_total", "unit": "windows",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny2.score3"]})
    for m in bench["end_to_end"]:
        if m["name"] == "windows_per_s":
            m["workloads"].append("tiny2.score3")
    (tiny_checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(tiny_checkout)
    assert reg.traffic(reg.workload("tiny2.score3")["traffic"])[
        "batch_size"] == 3
    assert [m["name"] for m in reg.metrics_for("tiny2.score3", False)] == [
        "windows_per_s", "setup_s", "windows_total"]
    line, rec = run_cell(tiny_checkout, "tiny2.score3")
    assert line["correct"]
    assert line["metrics"]["windows_total"]["value"] == rec.windows > 0
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_per_layer_metrics_are_listed_by_cell(tiny_checkout):
    reg = Registry(tiny_checkout)
    names = {m["name"] for m in reg.metrics_for("tiny.train", True)}
    assert names == {"mfu.train", "attn_roofline.train",
                     "conv_ms_per_clip.train", "idle_share.train"}
