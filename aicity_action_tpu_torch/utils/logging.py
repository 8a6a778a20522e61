"""Logging setup (port of ``aicity_action_tpu/utils/logging.py``;
reference: slowfast/utils/logging.py).

Master-only console + ``stdout.log`` file logging; on the other ranks
``print`` is suppressed. Structured stats go out as ``json_stats: {...}`` lines
(`logging.py:87-99`) so existing reference log parsers keep working.
"""

from __future__ import annotations

import builtins
import json
import logging
import os
import sys


def _suppress_print() -> None:
    def ignore(*args, **kwargs):
        pass

    builtins.print = ignore


# the handlers this module added to the root logger, and for which
# (output dir, master) they were made: a run with another OUTPUT_DIR in the
# same process replaces them instead of adding a second set
_installed: dict = {"key": None, "handlers": []}


def _configure(output_dir: str | None, is_master: bool) -> None:
    key = (output_dir, is_master)
    if _installed["key"] == key:
        return
    logger = logging.getLogger()
    for h in _installed["handlers"]:
        logger.removeHandler(h)
        h.close()
    _installed.update(key=key, handlers=[])
    logger.setLevel(logging.INFO)
    logger.propagate = False
    formatter = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s",
        datefmt="%m/%d %H:%M:%S",
    )
    if is_master:
        ch = logging.StreamHandler(stream=sys.stdout)
        handlers = [ch]
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            handlers.append(logging.FileHandler(
                os.path.join(output_dir, "stdout.log")))
        for h in handlers:
            h.setFormatter(formatter)
            logger.addHandler(h)
        _installed["handlers"] = handlers
    else:
        _suppress_print()


def is_master() -> bool:
    """Rank 0 of an initialized process group, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def setup_logging(output_dir: str | None = None) -> None:
    _configure(output_dir, is_master())


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def log_json_stats(stats: dict) -> None:
    """One-line machine-readable stats (reference format)."""
    stats = {
        k: (round(float(v), 5) if isinstance(v, float) else v)
        for k, v in stats.items()
    }
    get_logger(__name__).info("json_stats: %s", json.dumps(stats, sort_keys=True))
