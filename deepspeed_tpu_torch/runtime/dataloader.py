"""Dataloader for the training engine.

Port of what ``deepspeed_tpu/runtime/dataloader.py`` gives the engine's
``_build_dataloader`` (engine.py:1062): a map-style dataset (indexable,
``len()``) served as global micro-batches of ``micro_batch_size ×
dp_world_size`` items in an order shuffled by ``(seed, epoch)`` — the
same order as the JAX loader's, with the last partial batch dropped —
of which a rank takes its contiguous block of ``micro_batch_size`` items
(``_local_slice``, dataloader.py:98), and a :class:`RepeatingLoader` that
starts the next epoch when one runs out, and the resume cursor the
engine checkpoints (``state_dict``/``load_state_dict``). Batches are
dicts of numpy arrays; the engine moves them to its device. A
``data_sampler`` (the curriculum-aware
:class:`~deepspeed_tpu_torch.runtime.data_pipeline.DeepSpeedDataSampler`)
replaces the epoch order: each micro-batch is the sampler's next index
batch (dataloader.py:108-116). Collate overrides are not ported.
"""

from typing import Any, Dict, Iterator, Sequence

import numpy as np


class DeepSpeedDataLoader:
    """Port of ``DeepSpeedTPUDataLoader``: rank ``dp_rank`` of
    ``dp_world_size`` (every rank builds it with the same seed). Items
    may be dicts of arrays or tuples (input_ids, labels)."""

    def __init__(self, dataset, micro_batch_size: int, seed: int = 0,
                 data_sampler=None, dp_world_size: int = 1,
                 dp_rank: int = 0):
        self.dataset = dataset
        self.micro_batch_size = micro_batch_size
        self.dp_world_size = int(dp_world_size)
        self.dp_rank = int(dp_rank)
        self.global_batch = micro_batch_size * self.dp_world_size
        self.seed = seed
        self.data_sampler = data_sampler
        self.epoch = 0
        #: microbatches already served this epoch — the resume cursor. A
        #: fresh ``iter()`` continues FROM the cursor (the epoch order is
        #: deterministic in (seed, epoch), so position is the whole
        #: dataloader state); ``set_epoch`` rewinds it to 0.
        self._cursor = 0
        if len(dataset) < self.global_batch:
            raise ValueError(
                f"dataset of {len(dataset)} items smaller than one global "
                f"microbatch ({self.global_batch})")

    def __len__(self) -> int:
        return len(self.dataset) // self.global_batch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._cursor = 0

    def state_dict(self) -> Dict[str, int]:
        """Exact resume cursor: (epoch, microbatches served within it),
        checkpointed by the engine so a resumed run is fed the batches the
        uninterrupted run would have seen (dataloader.py:82)."""
        return {"epoch": int(self.epoch), "cursor": int(self._cursor),
                "seed": int(self.seed)}

    def load_state_dict(self, sd: Dict[str, int]) -> None:
        if int(sd.get("seed", self.seed)) != self.seed:
            raise ValueError(
                f"dataloader seed mismatch on resume: checkpoint has "
                f"{sd['seed']}, loader built with {self.seed} — the "
                f"shuffled orders would diverge silently")
        self.epoch = int(sd.get("epoch", 0))
        self._cursor = int(sd.get("cursor", 0))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's shuffled order from the cursor on (``_epoch_iter``
        of the JAX loader): skipped microbatches load no data. With a
        ``data_sampler``, its index batches, forever."""
        if self.data_sampler is not None:
            return self._sampler_iter()
        return self._epoch_iter()

    def _sampler_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        for idx in self.data_sampler:
            yield _default_collate([self.dataset[int(i)] for i in idx])

    def _epoch_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + self.epoch).shuffle(order)
        gb, mb = self.global_batch, self.micro_batch_size
        for start in range(self._cursor * gb, len(self) * gb, gb):
            self._cursor += 1
            mine = start + self.dp_rank * mb
            yield _default_collate([self.dataset[int(i)]
                                    for i in order[mine:mine + mb]])


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
