"""Multi-dataset batch sampling with temperature-weighted task choice
(own copy of `MultiTaskBatchSampler` from hma_tpu/data/sampler.py).

Each batch is drawn from a single dataset, chosen from a
temperature-flattened multinomial over dataset sizes; indices are sharded
across data-parallel ranks and reshuffled per epoch with a deterministic
seed, so the same seed gives the same index stream as `hma_tpu`'s. Pure
numpy.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class MultiTaskBatchSampler:
    """Yields (dataset-local) global index batches over a ConcatDataset layout.

    Indices are offsets into the concatenation of the datasets in order,
    matching torch.utils.data.ConcatDataset semantics so the same code
    drives either loader.
    """

    def __init__(self, dataset_sizes: Sequence[int], batch_size: int,
                 temperature: float = 3.0, rank: int = 0, world_size: int = 1,
                 seed: int = 42):
        self.dataset_sizes = list(dataset_sizes)
        self.batch_size = batch_size
        self.temperature = temperature
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0
        self.offsets = np.cumsum([0] + self.dataset_sizes[:-1])
        # shard each dataset across ranks
        self._shard_sizes = [s // world_size for s in self.dataset_sizes]
        total = sum(self._shard_sizes)
        self._num_batches = total // batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def generate_tasks_distribution(self) -> np.ndarray:
        """Temperature-smoothed sampling weights (reference:
        data_sampler.py:244-263): p_i ∝ (n_i / N) ** (1/T)."""
        sizes = np.asarray(self.dataset_sizes, dtype=np.float64)
        p = sizes / sizes.sum()
        p = p ** (1.0 / self.temperature)
        return p / p.sum()

    def __len__(self) -> int:
        return self._num_batches

    def _rank_shard(self, task: int, seed: int) -> np.ndarray:
        """This rank's shuffled index pool, tiled up to >= batch_size so a
        tiny domain (or a tiny rank shard) can never emit a short batch:
        every batch has the same shape."""
        if self.dataset_sizes[task] == 0:
            raise ValueError(
                f"dataset {task} has 0 sampleable windows (too few frames "
                f"for the window/stride?) — it cannot be in the mixture")
        perm = np.random.default_rng(seed).permutation(self.dataset_sizes[task])
        shard = perm[self.rank::self.world_size]
        if len(shard) == 0:  # fewer samples than ranks: fall back to all
            shard = perm
        while len(shard) < self.batch_size:
            shard = np.concatenate([shard, shard])
        return shard

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.epoch * 1000 + self.rank)
        dist = self.generate_tasks_distribution()
        # per-epoch, per-rank shuffled index pools
        pools = [self._rank_shard(i, self.seed + self.epoch)
                 for i in range(len(self.dataset_sizes))]
        cursors = [0] * len(pools)

        for _ in range(self._num_batches):
            task = int(rng.choice(len(self.dataset_sizes), p=dist))
            pool, cur = pools[task], cursors[task]
            if cur + self.batch_size > len(pool):
                pools[task] = self._rank_shard(task, int(rng.integers(2**31)))
                pool, cur = pools[task], 0
            batch = pool[cur:cur + self.batch_size]
            cursors[task] = cur + self.batch_size
            yield batch + self.offsets[task]
