"""Pytest settings of the benchmark's own tests (``port_bench/tests``).

- ``card``: a test that needs a CUDA card; it skips without one. Whether
  there is a card is decided in the ``card`` fixture, never at import.
- ``tiny_checkout``: a copy of the benchmark in a temporary checkout, with a
  tiny MViT-v2 configuration and tiny score and train mixes added as new
  files and entries (``tiny.score``, ``tiny.train``), run on the CPU through
  the port's plain path.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "tests" / "data"

# tight limits: the port's float32 plain path against the float32
# reference reads ~1e-6 at this size
TINY_LIMITS = {
    "tiny.score": {"score_gap": 1e-3},
    "tiny.train": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda", 0)


def make_checkout(dest: Path) -> Path:
    """A checkout at ``dest``: ``BENCHMARK.json`` and ``port_bench/`` with
    the tiny configuration, mixes and cells added."""
    shutil.copytree(ROOT / "port_bench", dest / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = dest / "port_bench"
    shutil.copy(DATA / "tiny.json", base / "configs" / "tiny.json")
    for mix in ("score_tiny", "train_tiny"):
        shutil.copy(DATA / f"{mix}.json", base / "traffic" / f"{mix}.json")
    for cell, limits in TINY_LIMITS.items():
        (base / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests/data/tiny.json",
                             "file": "port_bench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    cells = {"tiny.score": "score_tiny", "tiny.train": "train_tiny"}
    for cell, mix in cells.items():
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "score" if any("score" in w for w in m["workloads"]) \
                else "train"
            m["workloads"].append(f"tiny.{kind}")
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture
def tiny_checkout(tmp_path):
    return make_checkout(tmp_path)


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
