"""Host-side prefetching data loader (port of
``aicity_action_tpu/data/loader.py``; reference: datasets/loader.py).

- Per-host batch = global batch / ``NUM_SHARDS``; index sharding with
  epoch-seeded shuffling (``np.random.RandomState(seed + epoch)``, the
  JAX package's order; ``shuffle_dataset`` / ``set_epoch`` parity,
  loader.py:243-272).
- One process a card: the rank that drives card ``local_rank`` of a host's
  ``NUM_GPUS`` loads, and decodes, only its ``local_rank`` slice of each of
  the host's batches, the rows the JAX package's ``batch_sharding`` puts on
  that chip. A short batch (eval) is padded to the host's batch size with
  its last sample first, as the JAX loop pads it, and each rank's batch
  carries ``n_valid``, its real rows.
- A thread pool decodes the items of a batch (cv2 releases the
  interpreter lock while it decodes), and a bounded queue holds the
  collated batches ahead of the consumer.

Batches are numpy dicts: ``{"inputs": [np], "labels", "index"}``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from ..parallel import mesh
from .datasets import build_dataset


def _collate(items):
    inputs = [
        np.stack([it[0][p] for it in items])
        for p in range(len(items[0][0]))
    ]
    labels = np.stack([np.asarray(it[1]) for it in items])
    index = np.asarray([it[2] for it in items], np.int64)
    batch = {"inputs": inputs, "labels": labels, "index": index}
    meta = items[0][3] if len(items[0]) > 3 else {}
    for key in meta:
        batch[key] = np.stack([np.asarray(it[3][key]) for it in items])
    return batch


class Loader:
    """Iterable over batches with epoch-seeded shuffling and host sharding."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool,
        drop_last: bool,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        local_rank: int = 0,
        local_world: int = 1,
        loop: bool = False,
    ):
        if batch_size % local_world:
            raise ValueError(f"a host batch of {batch_size} over "
                             f"{local_world} cards")
        self.dataset = dataset
        self.host_batch_size = batch_size
        self.batch_size = batch_size // local_world  # what a rank gets
        self.local_rank = local_rank
        self.local_world = local_world
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle (parity with sampler.set_epoch), and the
        draws of a dataset that keys them by epoch (``Ava``)."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(idx)
        if self.num_shards > 1:
            # pad to a multiple so every shard sees the same count
            per = int(np.ceil(n / self.num_shards))
            padded = np.concatenate([idx, idx[: per * self.num_shards - n]])
            idx = padded[self.shard_id::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.host_batch_size
        return int(np.ceil(n / self.host_batch_size))

    def rank_rows(self, host_idx: np.ndarray) -> tuple[np.ndarray, int]:
        """This rank's indices of one host batch and how many are real:
        the slice ``[local_rank * b, (local_rank + 1) * b)`` of the batch
        padded to the host's size with its last index."""
        if self.local_world == 1:
            return host_idx, len(host_idx)
        n, b = len(host_idx), self.batch_size
        pad = self.host_batch_size - n
        padded = np.concatenate([host_idx, np.repeat(host_idx[-1:], pad)])
        lo = self.local_rank * b
        return padded[lo:lo + b], int(np.clip(n - lo, 0, b))

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        nb = len(self)
        hb = self.host_batch_size
        batches = [self.rank_rows(indices[i * hb:(i + 1) * hb])
                   for i in range(nb)]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx, n_valid in batches:
                        if stop.is_set():
                            return
                        items = list(
                            pool.map(self.dataset.__getitem__, batch_idx)
                        )
                        batch = _collate(items)
                        if self.local_world > 1:
                            batch["n_valid"] = n_valid
                        out_q.put(batch)
                out_q.put(None)
            except BaseException as e:  # propagate to the consumer
                out_q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a blocked producer can observe `stop` and exit
            while not out_q.empty():
                out_q.get_nowait()


def construct_loader(cfg, split: str):
    """Build the loader for a split (reference: loader.py:135-240)."""
    assert split in ("train", "val", "test")
    if split == "train":
        dataset_name = cfg.TRAIN.DATASET
        global_batch = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last = True, True
    elif split == "val":
        dataset_name = cfg.TRAIN.DATASET
        global_batch = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last = False, False
    else:
        dataset_name = cfg.TEST.DATASET
        global_batch = cfg.TEST.BATCH_SIZE
        shuffle, drop_last = False, False

    # per-host batch; each of the host's NUM_GPUS ranks takes its slice
    # (the reference divides by GPUs*shards per process)
    batch_size = global_batch // max(cfg.NUM_SHARDS, 1)
    dataset = build_dataset(dataset_name, cfg, split)
    local_world = max(cfg.NUM_GPUS, 1) if mesh.is_initialized() else 1
    return Loader(
        dataset,
        batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        seed=cfg.RNG_SEED,
        shard_id=cfg.SHARD_ID,
        num_shards=cfg.NUM_SHARDS,
        local_rank=mesh.get_rank() % local_world,
        local_world=local_world,
    )


def shuffle_dataset(loader: Loader, cur_epoch: int) -> None:
    """Reference API parity (loader.py:243-272)."""
    loader.set_epoch(cur_epoch)
