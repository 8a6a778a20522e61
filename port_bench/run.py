"""The benchmark of ``aicity_action_tpu_torch`` on NVIDIA H100 cards.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout (``BENCHMARK.json`` beside ``port_bench/``).
The cell names a configuration and a traffic mix; the mix names its driver
(``port_bench/drivers/<driver>.py``), which loads the program, warms it up,
measures a window of ``--seconds`` and checks what the timed path produced
against the plain reference (``port_bench/reference/``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read by ``port_bench/metrics/<name>.py``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared,
with its limit. The same numbers end standard error.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package is loaded once the window has
closed, 3. Kernel and compiler caches live in the checkout: the port's
``aicity_action_tpu_torch/_build/`` and ``.bench_cache/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aicity_action_tpu")


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's pieces, the run's arguments, the
    device and the clock's reading at the process's start."""

    registry: object
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Notes a set-up phase's end, printed on standard error."""
        self.marks.append((name, round(time.perf_counter() - self.t_start,
                                       2)))


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root: Path, traffic: dict) -> None:
    """Fixed cache directories inside the checkout; the mix's own
    environment (``env``) and nothing else of the program's switches."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ.pop("AICITY_TPU_FUSE_ATTN_LN", None)
    for key, value in traffic.get("env", {}).items():
        os.environ[key] = str(value)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def context(registry, name: str, args, device, t_start: float) -> Context:
    cell = registry.workload(name)
    return Context(registry=registry, cell=cell,
                   config=registry.config(cell["config"]),
                   traffic=registry.traffic(cell["traffic"]),
                   limits=registry.limits(name), seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device=device, t_start=t_start)


def execute(ctx: Context):
    """The cell's driver over ``ctx``; returns its record."""
    return ctx.registry.driver(ctx.traffic["driver"]).run(ctx)


def result_line(ctx: Context, record, device: dict) -> dict:
    """The run's result: the cell's metrics read from ``record``, the
    device, and the compared numbers last."""
    metrics = {}
    for m in ctx.registry.metrics_for(ctx.cell["name"], ctx.trace):
        value = ctx.registry.metric(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(device, memory_peak_bytes=record.memory_peak_bytes)
    out = {"correct": all(c["ok"] for c in record.checks)
           and record.failed == 0,
           "attempted": record.attempted, "failed": record.failed,
           "metrics": metrics, "device": dev}
    if ctx.trace:
        dev["busy_s"] = record.busy_s
        dev["window_s"] = record.trace_window_s
        out["breakdown"] = record.breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in record.checks}
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse(argv)
    from .registry import Registry

    root = Path.cwd()
    registry = Registry(root)
    cell = registry.workload(args.workload)
    cache_env(root, registry.traffic(cell["traffic"]))
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = context(registry, args.workload, args, torch.device("cuda", 0),
                  t_start)
    record = execute(ctx)
    loaded = forbidden_modules()
    if loaded:
        print(f"port_bench: loaded after the window: {loaded}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"]}
    result = result_line(ctx, record, device)
    print(f"port_bench: {args.workload} set-up {record.setup_s:.1f} s, "
          f"window {record.window_s:.1f} s, run "
          f"{time.perf_counter() - t_start:.1f} s; set-up phases "
          f"{ctx.marks}; views "
          f"{[round(u, 3) for u in getattr(record, 'unit_s', [])]}",
          file=sys.stderr)
    for c in record.checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
