"""Batch samplers (port of ``vae_gslm_tpu/data/sampler.py``, which the
port may not import): the standard sequential and seeded random
samplers of one process.  Pure Python: the same seed gives the JAX
package's batches.  The length-bucketed and token-budget samplers and
the distributed variants wait for the training and parallel-modes
slices (ROADMAP.md).
"""
from __future__ import annotations

import math
import random
from typing import Iterator, List, Optional


class Sampler:
    def __iter__(self) -> Iterator[List[int]]:
        raise NotImplementedError

    def set_epoch(self, epoch: int) -> None:
        pass


class SequentialSampler(Sampler):
    def __init__(self, n: int, batch_size: int, drop_last: bool = False):
        self.n, self.batch_size, self.drop_last = n, batch_size, drop_last

    def __iter__(self):
        idx = list(range(self.n))
        for i in range(0, self.n, self.batch_size):
            b = idx[i: i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                return
            yield b

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return math.ceil(self.n / self.batch_size)


class RandomSampler(Sampler):
    def __init__(self, n: int, batch_size: int, drop_last: bool = False,
                 seed: Optional[int] = None):
        self.n, self.batch_size, self.drop_last = n, batch_size, drop_last
        self.rng = random.Random(seed)

    def __iter__(self):
        idx = list(range(self.n))
        self.rng.shuffle(idx)
        for i in range(0, self.n, self.batch_size):
            b = idx[i: i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                return
            yield b

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return math.ceil(self.n / self.batch_size)


def standard_sampler(n: int, batch_size: int, shuffle: bool,
                     drop_last: bool = True,
                     seed: Optional[int] = None) -> Sampler:
    if shuffle:
        return RandomSampler(n, batch_size, drop_last=drop_last, seed=seed)
    return SequentialSampler(n, batch_size, drop_last=drop_last)
