"""Multigrid training schedules (port of ``aicity_action_tpu/utils/
multigrid.py``, a copy; reference: slowfast/utils/multigrid.py).

Long cycle: cycle through coarse-to-fine (T, S) base shapes with batch
sizes chosen to keep the per-iteration cost constant, stretching the step
schedule by EPOCH_FACTOR. Short cycle: vary the crop within an epoch.

:func:`MultigridSchedule.init_multigrid` derives the schedule and the
solver overrides (``SOLVER.STEPS`` / ``LRS`` / ``MAX_EPOCH``) in ``cfg``;
:meth:`MultigridSchedule.update_long_cycle` sets an epoch's shape, batch
size and BatchNorm kind, and ``engine/train_loop.py`` rebuilds the loader,
model and optimizer when the shape changes (carrying the weights). The
reference's aicity path leaves multigrid off.
"""

from __future__ import annotations

import numpy as np

from .logging import get_logger

logger = get_logger(__name__)


class MultigridSchedule:
    def __init__(self):
        self.schedule = None

    def init_multigrid(self, cfg):
        """Derive the schedule; updates SOLVER.STEPS/LRS/MAX_EPOCH and stores
        the default shapes (same contract as the reference)."""
        self.schedule = None
        cfg.MULTIGRID.DEFAULT_B = cfg.TRAIN.BATCH_SIZE
        cfg.MULTIGRID.DEFAULT_T = cfg.DATA.NUM_FRAMES
        cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE

        if cfg.MULTIGRID.LONG_CYCLE:
            self.schedule = self.get_long_cycle_schedule(cfg)
            cfg.SOLVER.STEPS = [0] + [s[-1] for s in self.schedule]
            cfg.SOLVER.STEPS[-1] = (
                cfg.SOLVER.STEPS[-2] + cfg.SOLVER.STEPS[-1]
            ) // 2  # fine-tuning phase
            cfg.SOLVER.LRS = [
                cfg.SOLVER.GAMMA ** s[0] * s[1][0] for s in self.schedule
            ]
            cfg.SOLVER.LRS = cfg.SOLVER.LRS[:-1] + [
                cfg.SOLVER.LRS[-2], cfg.SOLVER.LRS[-1],
            ]
            cfg.SOLVER.MAX_EPOCH = self.schedule[-1][-1]
        elif cfg.MULTIGRID.SHORT_CYCLE:
            cfg.SOLVER.STEPS = [
                int(s * cfg.MULTIGRID.EPOCH_FACTOR) for s in cfg.SOLVER.STEPS
            ]
            cfg.SOLVER.MAX_EPOCH = int(
                cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
            )
        return cfg

    def update_long_cycle(self, cfg, cur_epoch: int):
        """Apply the base shape for this epoch. Returns (cfg, changed)."""
        base_b, base_t, base_s = get_current_long_cycle_shape(
            self.schedule, cur_epoch)
        if (base_s != cfg.DATA.TRAIN_CROP_SIZE
                or base_t != cfg.DATA.NUM_FRAMES):
            cfg.DATA.NUM_FRAMES = base_t
            cfg.DATA.TRAIN_CROP_SIZE = base_s
            cfg.TRAIN.BATCH_SIZE = base_b * cfg.MULTIGRID.DEFAULT_B
            bs_factor = (
                float(cfg.TRAIN.BATCH_SIZE / max(cfg.NUM_GPUS, 1))
                / cfg.MULTIGRID.BN_BASE_SIZE
            )
            if bs_factor < 1:
                cfg.BN.NORM_TYPE = "sync_batchnorm"
                cfg.BN.NUM_SYNC_DEVICES = int(1.0 / bs_factor)
            elif bs_factor > 1:
                cfg.BN.NORM_TYPE = "sub_batchnorm"
                cfg.BN.NUM_SPLITS = int(bs_factor)
            else:
                cfg.BN.NORM_TYPE = "batchnorm"
            cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = (
                cfg.DATA.SAMPLING_RATE
                * (cfg.MULTIGRID.DEFAULT_T // cfg.DATA.NUM_FRAMES)
            )
            logger.info(
                "Long cycle update: B=%d T=%d S=%d norm=%s",
                cfg.TRAIN.BATCH_SIZE, base_t, base_s, cfg.BN.NORM_TYPE,
            )
            return cfg, True
        return cfg, False

    def get_long_cycle_schedule(self, cfg):
        steps = cfg.SOLVER.STEPS
        default_size = float(
            cfg.DATA.NUM_FRAMES * cfg.DATA.TRAIN_CROP_SIZE ** 2)
        default_iters = steps[-1]

        avg_bs = []
        all_shapes = []
        for t_factor, s_factor in cfg.MULTIGRID.LONG_CYCLE_FACTORS:
            base_t = int(round(cfg.DATA.NUM_FRAMES * t_factor))
            base_s = int(round(cfg.DATA.TRAIN_CROP_SIZE * s_factor))
            if cfg.MULTIGRID.SHORT_CYCLE:
                shapes = [
                    [base_t, cfg.MULTIGRID.DEFAULT_S
                     * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[0]],
                    [base_t, cfg.MULTIGRID.DEFAULT_S
                     * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[1]],
                    [base_t, base_s],
                ]
            else:
                shapes = [[base_t, base_s]]
            shapes = [
                [int(round(default_size / (s[0] * s[1] * s[1]))), s[0],
                 int(s[1])]
                for s in shapes
            ]
            avg_bs.append(np.mean([s[0] for s in shapes]))
            all_shapes.append(shapes)

        total_iters = 0.0
        schedule = []
        for step_index in range(len(steps) - 1):
            step_epochs = steps[step_index + 1] - steps[step_index]
            for ci, shapes in enumerate(all_shapes):
                cur_epochs = step_epochs * avg_bs[ci] / sum(avg_bs)
                total_iters += cur_epochs / avg_bs[ci]
                schedule.append((step_index, shapes[-1], cur_epochs))

        iter_saving = default_iters / total_iters
        final_step_epochs = cfg.SOLVER.MAX_EPOCH - steps[-1]
        ft_epochs = final_step_epochs / iter_saving * avg_bs[-1]
        schedule.append((len(steps) - 1, all_shapes[-1][-1], ft_epochs))

        x = (cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
             / sum(s[-1] for s in schedule))
        final_schedule = []
        total_epochs = 0.0
        for s in schedule:
            total_epochs += s[2] * x
            final_schedule.append((s[0], s[1], int(round(total_epochs))))
        for s in final_schedule:
            logger.info("long-cycle %s shape=%s until epoch %s", *s)
        return final_schedule


def get_current_long_cycle_shape(schedule, epoch: int):
    for s in schedule:
        if epoch < s[-1]:
            return s[1]
    return schedule[-1][1]


def short_cycle_crop_size(cur_global_idx: int, cfg) -> int:
    """Crop size for short cycles (replaces ShortCycleBatchSampler,
    reference datasets/multigrid_helper.py): iterations cycle through
    [S*f0, S*f1, S]."""
    factors = cfg.MULTIGRID.SHORT_CYCLE_FACTORS
    S = cfg.MULTIGRID.DEFAULT_S or cfg.DATA.TRAIN_CROP_SIZE
    phase = cur_global_idx % 3
    if phase == 0:
        return int(round(S * factors[0]))
    if phase == 1:
        return int(round(S * factors[1]))
    return S
