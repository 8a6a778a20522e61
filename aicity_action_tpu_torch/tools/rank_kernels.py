"""Rank the hand-written kernels by what they lose, from a ``chip_smoke.py``
run's output.

    python3 chip_smoke.py > smoke.log
    python -m aicity_action_tpu_torch.tools.rank_kernels smoke.log

Reads the ``{"kernels": [...]}`` line and, for every kernel and every shape
it was checked at, the kernel's time, its bound, its library yardstick and
its launches on the path it serves, and, where the log has them, the
interquartile ranges of the kernel's and the library's times (printed
beside the worst factor). Ranks the kernels first by their worst
factor against the library call (kernel ms over library ms, over the
shapes; kernels without a library call last), then by launches x (kernel ms
- bound ms) summed over the shapes. Prints one line per kernel and one JSON
list. Reads a log; needs no card.
"""

from __future__ import annotations

import argparse
import json


def kernels_line(path: str) -> list:
    with open(path) as f:
        for line in f:
            if line.startswith('{"kernels":'):
                return json.loads(line)["kernels"]
    raise ValueError(f"{path}: no kernels line")


def rank(kernels: list) -> list:
    rows = []
    for k in kernels:
        cases = ([k] + k.get("other_shapes", [])
                 + k.get("odd_token_shapes", []))
        factors = [(c["ms"] / c["library_ms"], c["shape"], c)
                   for c in cases if c.get("library_ms")]
        worst = max(factors, key=lambda f: f[0]) if factors else (
            None, None, {})
        rows.append({
            "name": k["name"], "worst_factor": worst[0],
            "worst_shape": worst[1],
            # the worst shape's medians and interquartile ranges (ms)
            "worst_ms": worst[2].get("ms"),
            "worst_ms_iqr": worst[2].get("ms_iqr"),
            "worst_library_ms": worst[2].get("library_ms"),
            "worst_library_iqr": worst[2].get("library_iqr"),
            "excess_ms": sum(k["launches"] * (c["ms"] - c["bound_ms"])
                             for c in cases) / len(cases),
            "launches": k["launches"], "path": k.get("launches_on")})
    return sorted(rows, key=lambda r: (r["worst_factor"] is None,
                                       -(r["worst_factor"] or 0.0),
                                       -r["excess_ms"]))


def _spread(r: dict) -> str:
    """The worst shape's kernel and library times with their interquartile
    ranges, where the log has them."""
    if not r.get("worst_ms_iqr") or not r.get("worst_library_iqr"):
        return ""
    k, lib = r["worst_ms_iqr"], r["worst_library_iqr"]
    return (f" (kernel {r['worst_ms']:.4f} ms, iqr {k[0]:.4f}-{k[1]:.4f}; "
            f"library {r['worst_library_ms']:.4f} ms, iqr "
            f"{lib[0]:.4f}-{lib[1]:.4f})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("log")
    args = p.parse_args(argv)
    rows = rank(kernels_line(args.log))
    for i, r in enumerate(rows, 1):
        factor = ("no library call" if r["worst_factor"] is None
                  else f"{r['worst_factor']:.2f}x the library at "
                       f"{r['worst_shape']}" + _spread(r))
        print(f"{i:2d}. {r['name']}: {factor}; launches x (ms - bound) "
              f"{r['excess_ms']:.2f} ms on {r['path']}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
