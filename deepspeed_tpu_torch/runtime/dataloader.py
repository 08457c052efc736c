"""Dataloader for the training engine.

Port of what ``deepspeed_tpu/runtime/dataloader.py`` gives the engine's
``_build_dataloader`` (engine.py:1062) on one process: a map-style
dataset (indexable, ``len()``) served as micro-batches in an order
shuffled by ``(seed, epoch)`` — the same order as the JAX loader's, with
the last partial batch dropped — and a :class:`RepeatingLoader` that
starts the next epoch when one runs out. Batches are dicts of numpy
arrays; the engine moves them to its device. Curriculum / data-efficiency
samplers, collate overrides and the resume cursor are not ported.
"""

from typing import Any, Dict, Iterator, Sequence

import numpy as np


class DeepSpeedDataLoader:
    """Port of ``DeepSpeedTPUDataLoader`` for one process. Items may be
    dicts of arrays or tuples (input_ids, labels)."""

    def __init__(self, dataset, micro_batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.micro_batch_size = micro_batch_size
        self.seed = seed
        self.epoch = 0
        if len(dataset) < micro_batch_size:
            raise ValueError(
                f"dataset of {len(dataset)} items smaller than one "
                f"microbatch ({micro_batch_size})")

    def __len__(self) -> int:
        return len(self.dataset) // self.micro_batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + self.epoch).shuffle(order)
        mb = self.micro_batch_size
        for start in range(0, len(self) * mb, mb):
            yield _default_collate([self.dataset[int(i)]
                                    for i in order[start:start + mb]])


def _default_collate(items: Sequence[Any]) -> Dict[str, np.ndarray]:
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(it[k]) for it in items])
                for k in first}
    if isinstance(first, (tuple, list)):
        names = ["input_ids", "labels"][:len(first)]
        return {n: np.stack([np.asarray(it[i]) for it in items])
                for i, n in enumerate(names)}
    return {"input_ids": np.stack([np.asarray(it) for it in items])}


class RepeatingLoader:
    """Wrap a loader to restart (epoch + 1) when exhausted."""

    def __init__(self, loader):
        self.loader = loader
        self._iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self._iter = iter(self.loader)
            return next(self._iter)
