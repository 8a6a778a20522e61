"""Data-loading throughput benchmark (port of ``aicity_action_tpu/utils/
benchmark.py``; reference: slowfast/utils/benchmark.py).

Measures the input pipeline alone, with no model: the train loader of
``cfg`` over ``BENCHMARK.NUM_EPOCHS`` passes (reshuffled each epoch where
``BENCHMARK.SHUFFLE``), reporting clips/s and the per-iteration latency
distribution, logged every ``BENCHMARK.LOG_PERIOD`` iterations. Runs on the
host: nothing touches the card.
"""

from __future__ import annotations

import time

import numpy as np

from ..data.loader import construct_loader, shuffle_dataset
from .logging import get_logger, log_json_stats, setup_logging

logger = get_logger(__name__)


def benchmark_data_loading(cfg) -> dict:
    """Returns ``{"_type": "data_benchmark", "clips_per_sec",
    "med_iter_sec", "p95_iter_sec", "total_clips", "wall_sec",
    "batch_size"}`` (also logged as a JSON line)."""
    setup_logging(cfg.OUTPUT_DIR)
    loader = construct_loader(cfg, "train")
    log_period = max(cfg.BENCHMARK.LOG_PERIOD, 1)
    iter_times: list[float] = []
    total_clips = 0
    t_start = time.perf_counter()
    for epoch in range(cfg.BENCHMARK.NUM_EPOCHS):
        if cfg.BENCHMARK.SHUFFLE:
            shuffle_dataset(loader, epoch)
        t0 = time.perf_counter()
        for i, batch in enumerate(loader):
            t1 = time.perf_counter()
            iter_times.append(t1 - t0)
            total_clips += batch["labels"].shape[0]
            if (i + 1) % log_period == 0:
                logger.info("epoch %d iter %d: %.4fs/iter (median %.4fs)",
                            epoch, i + 1, iter_times[-1],
                            float(np.median(iter_times[-log_period:])))
            t0 = time.perf_counter()
    wall = time.perf_counter() - t_start
    stats = {
        "_type": "data_benchmark",
        "clips_per_sec": total_clips / wall,
        "med_iter_sec": float(np.median(iter_times)) if iter_times else 0.0,
        "p95_iter_sec": (float(np.percentile(iter_times, 95))
                         if iter_times else 0.0),
        "total_clips": total_clips,
        "wall_sec": wall,
        "batch_size": loader.batch_size,
    }
    log_json_stats(stats)
    return stats
