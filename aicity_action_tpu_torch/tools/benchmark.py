"""Data-loading throughput of a config's train loader, with no model (port
of ``tools/benchmark.py``, the reference's utils/benchmark.py harness).

Usage:
    python -m aicity_action_tpu_torch.tools.benchmark --cfg CFG \
        [BENCHMARK.NUM_EPOCHS N] [BENCHMARK.LOG_PERIOD N] \
        [BENCHMARK.SHUFFLE True|False] [KEY VALUE ...]

Prints the ``data_benchmark`` JSON line of
:func:`~aicity_action_tpu_torch.utils.benchmark.benchmark_data_loading`
(clips/s, median and p95 seconds an iteration, clips, wall, batch size).
The loader runs on the host; no card is needed.
"""

from __future__ import annotations


def main(argv=None) -> dict:
    from ..config import assert_and_infer_cfg, load_config, parse_args
    from ..utils.benchmark import benchmark_data_loading

    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    return benchmark_data_loading(cfg)


if __name__ == "__main__":
    main()
