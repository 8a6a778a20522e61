"""Each cell on the card, briefly: one run of the benchmark command, whose
last line is correct and carries the cell's metrics."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    group = BENCH["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group
            if "workloads" not in m or cell in m["workloads"]}
    assert want == set(line["metrics"])
