"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, chooses its device only as asked, and builds its 448 config
without YAML."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import aicity_action_tpu_torch
from aicity_action_tpu_torch import device as tdevice
from aicity_action_tpu_torch.config import get_cfg, mvitv2_b_16x4_448_cfg
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.mvit import MViT, build_mvit_spec
from aicity_action_tpu_torch.ops import flash_attention as tfa
from aicity_action_tpu_torch.ops import fused_dense as tfd
from aicity_action_tpu_torch.ops import kernels
from aicity_action_tpu_torch.ops import layer_norm as tln
from torch_port_helpers import YAML, tiny_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(aicity_action_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aicity_action_tpu")


def _port_modules():
    return ["aicity_action_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            [PKG_DIR], prefix="aicity_action_tpu_torch.")]


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_of_the_port_imports_jax_even_lazily():
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs
        if f.endswith(".py")]
    bad = [(os.path.relpath(f, REPO), name) for f in files
           for name in _imported_names(f)
           if name.split(".")[0] in FORBIDDEN]
    assert len(files) > 20 and bad == []


def test_build_model_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tiny_cfg(get_cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")
    model = build_model(tiny_cfg(get_cfg), device="cpu", seed=3)
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training


def test_build_model_weights_come_from_the_seed():
    a = build_model(tiny_cfg(get_cfg), device="cpu", seed=3).state_dict()
    b = build_model(tiny_cfg(get_cfg), device="cpu", seed=3).state_dict()
    c = build_model(tiny_cfg(get_cfg), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"],
                           c["blocks.0.attn.qkv.weight"])


def test_448_config_in_code_equals_the_yaml():
    from_yaml = get_cfg()
    from_yaml.merge_from_file(os.path.join(REPO, YAML))
    assert mvitv2_b_16x4_448_cfg() == from_yaml


def test_reference_parameter_names_and_shapes():
    """The port's state_dict uses PySlowFast's names, so a reference
    checkpoint's model_state loads with load_state_dict. (Built on the meta
    device: names and shapes only, no 448 weights on the CPU.)"""
    with torch.device("meta"):
        model = MViT(build_mvit_spec(mvitv2_b_16x4_448_cfg()))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["patch_embed.proj.weight"] == (96, 3, 3, 7, 7)
    assert shapes["pos_embed_spatial"] == (1, 112 * 112, 96)
    assert shapes["pos_embed_temporal"] == (1, 8, 96)
    assert shapes["blocks.0.attn.qkv.weight"] == (288, 96)
    assert shapes["blocks.0.attn.pool_q.weight"] == (96, 1, 3, 3, 3)
    assert shapes["blocks.1.attn.norm_q.weight"] == (96,)
    assert shapes["blocks.1.proj_max_pool.weight"] == (192, 96)
    assert shapes["blocks.15.mlp.fc1.weight"] == (3072, 768)
    assert shapes["norm.weight"] == (768,)
    assert shapes["head.projection.weight"] == (18, 768)
    # stem, pos-embeds, final norm, head: 8; per block norm1, norm2, qkv,
    # proj, fc1, fc2 (12) and the q/k/v pools with their norms (9);
    # proj_max_pool on the three expand blocks
    assert len(shapes) == 8 + 16 * (12 + 9) + 3 * 2


def test_wrappers_raise_instead_of_falling_back(monkeypatch, tmp_path):
    """Where a wrapper decides to launch its kernel, a kernel that cannot
    be built, or a tensor it does not take, raises; nothing drops to the
    plain version."""
    monkeypatch.setattr(kernels, "use_kernel", lambda t: True)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_lib", None)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "nvcc_path", no_nvcc)
    x, g, b = torch.ones(8, 96), torch.ones(96), torch.zeros(96)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfd.fused_ln_qkv(x, g, b, torch.ones(288, 96), None, 1e-6, 4)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfd.fused_ln_mlp(x, g, b, torch.ones(384, 96), torch.ones(384),
                         torch.ones(96, 384), b, 1e-6)
    # a CPU tensor is not a kernel's input
    with pytest.raises(ValueError, match="expected a tensor on cuda"):
        tln.fused_layer_norm(x, g, b, 1e-6)
    q = torch.ones(1, 96, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="expected a tensor on cuda"):
        tfa.flash_attention_ln(q, q, q, g, b, g, b, g, b, 0.1, 1e-5,
                               (True, True, True), True)
    # nor is a layout the kernel does not read
    with pytest.raises(ValueError, match="d-major"):
        tfa.flash_attention_ln(q.contiguous(), q, q, g, b, g, b, g, b, 0.1,
                               1e-5, (True, True, True), True)


def test_plain_reference_mode_is_scoped():
    assert kernels._force_plain is False
    with kernels.plain_reference():
        assert kernels._force_plain is True
    assert kernels._force_plain is False
