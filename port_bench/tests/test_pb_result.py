"""The result's last line, and the look for a card."""

import json

import pytest

from port_bench import run
from port_bench.tests.helpers import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [("tiny.score", False),
                                        ("tiny.score", True),
                                        ("tiny.train", False)])
def test_result_line_schema(tiny_checkout, one_thread, cell, trace):
    line, _ = run_cell(tiny_checkout, cell, trace=trace)
    json.loads(json.dumps(line))  # one JSON object, numbers as measured
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in line) == trace
    assert line["correct"] is True and line["failed"] == 0
    assert isinstance(line["attempted"], int) and line["attempted"] > 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    if not trace:
        assert "setup_s" in line["metrics"]
        assert len(line["metrics"]) >= 2
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][part]) <= 10
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(tiny_checkout, monkeypatch, capsys):
    import torch

    monkeypatch.chdir(tiny_checkout)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "b448.score_b8", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "aicity_action_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == [] or all(
        m.split(".")[0] in run.FORBIDDEN for m in run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert "jaxlib.fake" in run.forbidden_modules()
