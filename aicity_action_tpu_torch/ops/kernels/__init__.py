"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, which is loaded with ``ctypes``. The build happens at first use,
into ``aicity_action_tpu_torch/_build/`` (ignored by git), under a name that
hashes the sources and flags, so an edited source rebuilds and an unchanged
one is reused. Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.

Each C entry point launches on the caller's stream and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.

:func:`export_op` registers an inference wrapper as a ``torch.library``
custom op (``aicity::NAME``) with the output shapes of its fake, so that
``torch.export`` traces the wrapper as one opaque op (its launches read
``data_ptr()``, which no traced tensor has) and the exported program calls
it, and so launches the kernel, when it runs. The registration runs no
build.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v"]

_vp, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
# C signatures of csrc/*.cu's extern "C" functions: (argtypes, restype)
_SIGNATURES = {
    "aicity_layer_norm": ([_vp] * 4 + [_l] + [_i] * 4 + [_f, _vp], _i),
    "aicity_ln_qkv": ([_vp] * 9 + [_i, _i, _i, _f] + [_i] * 4 + [_vp], _i),
    "aicity_ln_qkv_smem_bytes": ([_i] * 3, _i),
    "aicity_ln_mlp": ([_vp] * 10 + [_i] * 4 + [_f] + [_i] * 7 + [_vp], _i),
    "aicity_ln_mlp_smem_bytes": ([_i] * 5, _i),
    "aicity_flash_attention_ln": ([_vp] * 14 + [_i] * 4 + [_f, _f] + [_i] * 4
                                  + [_vp], _i),
    "aicity_flash_attention_ln_bwd": ([_vp] * 25 + [_i] * 5 + [_f, _f]
                                      + [_i] * 5 + [_vp], _i),
    "aicity_flash_ln_bwd_plan": ([_i] * 4 + [_vp], None),
    "aicity_layer_norm_bwd": ([_vp] * 7 + [_l] + [_i] * 4 + [_f, _vp], _i),
    "aicity_pool_norm": ([_vp] * 4 + [_i] * 6 + [_f, _vp], _i),
    "aicity_pool_norm_bwd": ([_vp] * 7 + [_i] * 6 + [_f, _vp], _i),
    "aicity_layer_norm_smem_bytes": ([_i] * 4, _i),
    "aicity_flash_attention": ([_vp] * 5 + [_i] * 4 + [_f, _vp], _i),
    "aicity_flash_attention_bwd": ([_vp] * 13 + [_i] * 4 + [_f, _i, _vp],
                                   _i),
    "aicity_flash_bwd_smem_bytes": ([_i], _i),
    "aicity_flash_ln_bwd_dq_smem_bytes": ([_i], _i),
    "aicity_wgmma_sw64_probe": ([_vp] * 4 + [_i, _vp], _i),
    "aicity_ln_qkv_bwd": ([_vp, _vp] + [_i] * 4 + [_f, _vp], _i),
    "aicity_ln_qkv_bwd_smem_bytes": ([_i] * 4, _i),
    "aicity_ln_mlp_bwd": ([_vp, _vp] + [_i] * 3 + [_f, _vp], _i),
    "aicity_ln_mlp_bwd_smem_bytes": ([_i] * 5, _i),
    "aicity_error_string": ([_i], ctypes.c_char_p),
}

# Shared memory a Hopper block may use (232,448 bytes).
MAX_SMEM_BYTES = 232_448
# shared memory an SM gives its blocks (228 KB, 1 KB of it reserved per
# block)
SM_SMEM_BYTES = 233_472

_lib = None
_lock = threading.Lock()
_force_plain = False


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _digest() -> str:
    """Hash of the nvcc flags and every ``csrc/`` source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    them into one shared library; returns its path. The compiler's output
    (``-Xptxas=-v``: registers, shared memory, spills) goes to
    ``_build/build.log``."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    so = BUILD_DIR / f"libaicity_kernels_{_digest()}.so"
    if so.exists():
        return so
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    logs, failed = [], []
    for src, p in zip(sources, procs):
        out, _ = p.communicate()
        logs.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().aicity_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (the persistent kernels' grid)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def use_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``t``: yes on a CUDA
    tensor, no on a CPU tensor (the plain version runs). The only other way
    to get the plain version on the card is :func:`plain_reference`."""
    if t.device.type == "cuda":
        return not _force_plain
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


@contextlib.contextmanager
def plain_reference():
    """Run every wrapper's plain PyTorch version, CUDA tensors included.
    Exists only so that a whole forward can be held against its plain
    reference on the card (``chip_smoke.py``); no serving path uses it."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def require(t: torch.Tensor, name: str, shape: tuple | None = None,
            device: torch.device | None = None,
            dtype: torch.dtype = torch.bfloat16) -> None:
    """What every kernel takes: a contiguous CUDA tensor of ``dtype``
    (bf16 unless stated), 16-byte aligned, on the given device and of the
    given shape."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a 16-byte aligned tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def export_op(name: str, schema: str, impl, fake):
    """``impl`` registered as the custom op ``aicity::{name}`` of
    ``schema`` (no argument mutated), with ``fake`` its output shapes and
    types; returns the op. Wrappers call it only under
    ``torch.compiler.is_exporting()``, so that the eager path launches as
    before; the op runs ``impl``, the wrapper itself."""
    op = torch.library.custom_op(f"aicity::{name}", impl, mutates_args=(),
                                 schema=schema)
    op.register_fake(fake)
    return op
