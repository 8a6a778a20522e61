"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (on the CPU, at a tiny size, past the look for a
card): an answer altered where it is produced (score cells); a step that
returns its state unchanged, and half of the batch left out with the mean
taken over the rest (training cells). No cell spans chips, so no exchange
between chips can be left out. The control, the float32 reference computed
in float8, fails too."""

import pytest
import torch

from port_bench import control
from port_bench.tests.helpers import context, run_cell


def test_sound_runs_are_correct(tiny_checkout, one_thread):
    for cell in ("tiny.score", "tiny.train"):
        line, _ = run_cell(tiny_checkout, cell)
        assert line["correct"], line["checks"]


def test_altered_answer(tiny_checkout, one_thread, monkeypatch):
    from aicity_action_tpu_torch.pipeline import window_inference as wi

    real = wi.WindowScorer.score_chunks

    def altered(self, *a, **k):
        # each window's scores rolled by one class: still a distribution
        return [(t0, t1, s[[*range(1, len(s)), 0]])
                for t0, t1, s in real(self, *a, **k)]

    monkeypatch.setattr(wi.WindowScorer, "score_chunks", altered)
    line, rec = run_cell(tiny_checkout, "tiny.score")
    assert rec.failed == 0  # every window there, each a distribution
    assert not line["correct"]
    assert not line["checks"]["score_gap"]["value"] <= line["checks"][
        "score_gap"]["limit"]


def test_state_unchanged(tiny_checkout, one_thread, monkeypatch):
    from aicity_action_tpu_torch.solver import optimizer

    def frozen(self):
        params = [p for p in self.params if p.grad is not None]
        self.count += 1
        return self.norm_fn(params)

    monkeypatch.setattr(optimizer.TrainOptimizer, "step", frozen)
    line, _ = run_cell(tiny_checkout, "tiny.train")
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch(tiny_checkout, one_thread, monkeypatch):
    from aicity_action_tpu_torch.engine import steps

    real = steps.make_train_step

    def halved(*a, **k):
        step = real(*a, **k)

        def half(batch, mixup_draw=None):
            n = batch["labels"].shape[0] // 2
            return step({"inputs": batch["inputs"][:n],
                         "labels": batch["labels"][:n]}, mixup_draw)

        return half

    monkeypatch.setattr(steps, "make_train_step", halved)
    line, _ = run_cell(tiny_checkout, "tiny.train")
    assert not line["correct"]


@pytest.mark.parametrize("cell,fault", [("tiny.score", None),
                                        ("tiny.train", None),
                                        ("tiny.train", "half_batch")])
def test_control_and_planted_faults_fail(tiny_checkout, one_thread, cell,
                                         fault):
    ctx = context(tiny_checkout, cell)
    readings = control.readings(ctx, fault)
    assert any(v > ctx.limits[k] for k, v in readings.items()), readings


@pytest.mark.card
@pytest.mark.parametrize("cell", ["b448.score_b8", "l448.score_b8",
                                  "b448.train_b8", "l448.train_b8"])
def test_control_fails_on_card(card, cell, monkeypatch):
    """The control at the cell's own size on the card, one seed."""
    import argparse
    import pathlib

    from port_bench import run
    from port_bench.registry import Registry

    root = pathlib.Path(__file__).resolve().parents[2]
    ctx = run.context(Registry(root), cell, argparse.Namespace(
        seed=2 ** 31 + 77, seconds=0.0, trace=0), card, 0.0)
    readings = control.readings(ctx)
    assert any(v > ctx.limits[k] for k, v in readings.items()), readings
