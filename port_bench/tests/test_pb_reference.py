"""The plain float32 reference against the port's CPU path (its plain
PyTorch versions of every kernel) at a tiny size, and the benchmark's
imports."""

import ast
import json
from pathlib import Path

import pytest
import torch

from port_bench import weights
from port_bench.reference import quant
from port_bench.reference.mvit import MViTReference, param_shapes
from port_bench.reference.train import follow
from port_bench.program import port_cfg, port_model
from port_bench.drivers.train import checks

BENCH = Path(__file__).resolve().parents[1]
TINY = json.loads((BENCH / "tests" / "data" / "tiny.json").read_text())


@pytest.fixture
def tiny(one_thread):
    c = TINY["cfg"]
    return c, weights.make(c, 11, "cpu")


def test_param_names_and_shapes_are_the_ports(tiny):
    c, params = tiny
    model = port_model(port_cfg(TINY), params, "cpu")
    assert {n: tuple(p.shape) for n, p in model.state_dict().items()} == \
        param_shapes(c)


def test_forward_matches_the_port(tiny):
    c, params = tiny
    model = port_model(port_cfg(TINY), params, "cpu").eval()
    x = torch.randn((3, 4, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        prog = model(x)
    ref = MViTReference(c, params).scores(x)
    torch.testing.assert_close(prog, ref, rtol=1e-5, atol=1e-6)


def test_fp8_control_moves_the_scores(tiny):
    c, params = tiny
    x = torch.randn((3, 4, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(0))
    ref = MViTReference(c, params).scores(x)
    low = MViTReference(c, params, quant.fp8).scores(x)
    assert (low - ref).abs().max() > 1e-4


def test_train_steps_match_the_port(tiny):
    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    c, params = tiny
    cfg = port_cfg(TINY)
    model = port_model(cfg, params, "cpu")
    opt = construct_optimizer(cfg, model, 100)
    step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC,
                           num_classes=18, seed=5)
    gen = torch.Generator().manual_seed(1)
    batches = [{"inputs": torch.randn((2, 4, 32, 32, 3), generator=gen),
                "labels": torch.randint(0, 18, (2,), generator=gen)}
               for _ in range(3)]
    named = list(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named}
    losses, grad1 = [], {}
    for k in range(3):
        m, _ = step(batches[k])
        losses.append(float(m["loss"]))
        if k == 0:
            grad1 = {n: float(opt.opt.state[p]["exp_avg"].norm() / 0.1)
                     for n, p in named}
    prog = {"loss": losses, "grad1": grad1,
            "change": {n: float((p.detach() - p0[n]).norm())
                       for n, p in named}}
    ref = follow(c, params, batches, 5, 3, 100)
    limits = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3}
    assert all(ch["ok"] for ch in checks(prog, ref, limits)), \
        checks(prog, ref, limits)
    # the draws are the program's: another seed's masks read far off
    other = follow(c, params, batches, 6, 3, 100)
    assert not all(ch["ok"] for ch in checks(prog, other, limits))


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "aicity_action_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "aicity_action_tpu_torch" not in imported(path)
