"""Batch samplers (port of ``vae_gslm_tpu/data/sampler.py``, which the
port may not import): the standard sequential and seeded random
samplers of one process and the distributed sampler of one rank.  Pure
Python: the same seed gives the JAX package's batches.  The
length-bucketed and token-budget samplers wait for a later slice (no
shipped config selects them; ROADMAP.md).
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


class DistributedSampler(Sampler):
    """Epoch-seeded shuffle and rank subsample (torch's
    ``DistributedSampler`` semantics, JAX :68-108): every rank shuffles
    the same permutation of epoch ``seed + epoch``, keeps every
    ``world_size``-th index from its rank on, and batches them."""

    def __init__(self, n: int, batch_size: int, world_size: int, rank: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside 0..{world_size - 1}")
        self.n, self.batch_size = n, batch_size
        self.world_size, self.rank = world_size, rank
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.epoch = 0
        if drop_last and n % world_size:
            self.num_samples = n // world_size
        else:
            self.num_samples = math.ceil(n / world_size)
        self.total_size = self.num_samples * world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        idx = list(range(self.n))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: self.total_size]
        else:
            idx += idx[: self.total_size - len(idx)]
        idx = idx[self.rank: self.total_size: self.world_size]
        for i in range(0, len(idx), self.batch_size):
            b = idx[i: i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                return
            yield b

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return math.ceil(self.num_samples / self.batch_size)


def standard_sampler(n: int, batch_size: int, shuffle: bool,
                     distributed: bool = False,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     drop_last: bool = True,
                     seed: Optional[int] = None) -> Sampler:
    if distributed:
        if world_size is None or rank is None:
            raise ValueError("the distributed sampler needs world_size "
                             "and rank")
        return DistributedSampler(n, batch_size, world_size, rank,
                                  shuffle=shuffle, drop_last=drop_last,
                                  seed=seed or 0)
    if shuffle:
        return RandomSampler(n, batch_size, drop_last=drop_last, seed=seed)
    return SequentialSampler(n, batch_size, drop_last=drop_last)
