"""Batch samplers (port of ``vae_gslm_tpu/data/sampler.py``, which the
port may not import): the standard sequential and seeded random
samplers, the length-bucketed samplers (by count or by a padded-length
budget) and the token-budget (concat) samplers, each of one process and
of one rank.  Pure Python with ``random.Random`` as in JAX: the same
seed gives the JAX package's batches, index for index.  Like JAX's, the
distributed bucket and concat samplers shuffle their rank's batches with
the process-global ``random`` module.
"""
from __future__ import annotations

import math
import random
from typing import Iterator, List, Optional

import numpy as np


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


def _bucketize(lengths: List[float], nbuckets: int,
               descending: bool) -> List[List[int]]:
    """Indices sorted by length (stable, as ``np.argsort``) cut into
    ``nbuckets`` equal buckets, the remainder in one more."""
    order = np.argsort([-x for x in lengths] if descending else lengths)
    split = len(order) // nbuckets
    buckets = [order[i * split: (i + 1) * split] for i in range(nbuckets)]
    if nbuckets * split < len(order):
        buckets.append(order[nbuckets * split:])
    return [[int(i) for i in b] for b in buckets]


def _greedy_batches(indices: List[int], lengths: List[float],
                    batch_size: Optional[int],
                    batch_length: Optional[float],
                    drop_last: bool) -> List[List[int]]:
    """Batches of ``batch_size`` indices, or of as many as keep the
    longest length times the count within ``batch_length``."""
    batches, batch, max_len = [], [], 0.0
    for idx in indices:
        batch.append(idx)
        max_len = max(lengths[idx], max_len)
        if batch_size is not None:
            if len(batch) >= batch_size:
                batches.append(batch)
                batch, max_len = [], 0.0
        elif max_len * len(batch) > batch_length and batch[:-1]:
            batches.append(batch[:-1])
            batch = [batch[-1]]
            max_len = lengths[idx]
    if batch and not drop_last:
        batches.append(batch)
    return batches


def _check_budget(batch_size, batch_length) -> None:
    if (batch_size is None) == (batch_length is None):
        raise ValueError("give one of batch_size and batch_length")


def _check_rank(world_size: int, rank: int) -> None:
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside 0..{world_size - 1}")


def _rank_share(batches: List[List[int]], world_size: int,
                rank: int) -> List[List[int]]:
    """Rank ``rank``'s contiguous share of ``batches`` (JAX's count, which
    leaves the last world's worth out), shuffled by the global ``random``
    module as JAX's are."""
    num = math.ceil((len(batches) - world_size) / world_size)
    batches = batches[:num * world_size][rank * num:(rank + 1) * num]
    random.shuffle(batches)
    return batches


class SingleRandomBucketSampler(Sampler):
    """Length-sorted buckets (longest first), each shuffled, batched
    greedily, the batches shuffled; one ``random.Random(seed)`` for every
    epoch."""

    def __init__(self, nbuckets: int, lengths: List[float],
                 batch_size: Optional[int] = None,
                 batch_length: Optional[float] = None,
                 drop_last: bool = True, seed: Optional[int] = None):
        _check_budget(batch_size, batch_length)
        self.lengths = lengths
        self.batch_size, self.batch_length = batch_size, batch_length
        self.drop_last = drop_last
        self.buckets = _bucketize(lengths, nbuckets, descending=True)
        self.rng = random.Random(seed)

    def __iter__(self):
        self.rng.shuffle(self.buckets)
        for b in self.buckets:
            self.rng.shuffle(b)
        idxs = [i for b in self.buckets for i in b]
        batches = _greedy_batches(idxs, self.lengths, self.batch_size,
                                  self.batch_length, self.drop_last)
        self.rng.shuffle(batches)
        return iter(batches)


class DistributedRandomBucketSampler(Sampler):
    """Length-sorted buckets (shortest first) shuffled by epoch-seeded
    generators, the same on every rank, batched greedily; each rank takes
    its share."""

    def __init__(self, nbuckets: int, lengths: List[float],
                 world_size: int, rank: int,
                 batch_size: Optional[int] = None,
                 batch_length: Optional[float] = None,
                 drop_last: bool = True, seed: int = 1234):
        _check_rank(world_size, rank)
        _check_budget(batch_size, batch_length)
        self.lengths = lengths
        self.batch_size, self.batch_length = batch_size, batch_length
        self.buckets = _bucketize(lengths, nbuckets, descending=False)
        self.world_size, self.rank = world_size, rank
        self.epoch, self.seed = 0, seed

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        random.Random(self.epoch + self.seed).shuffle(self.buckets)
        for i, b in enumerate(self.buckets):
            random.Random(self.epoch + self.seed + i * 5).shuffle(b)
        idxs = [i for b in self.buckets for i in b]
        batches = _greedy_batches(idxs, self.lengths, self.batch_size,
                                  self.batch_length, drop_last=True)
        return iter(_rank_share(batches, self.world_size, self.rank))


def _concat_batches(idxs: List[int], lengths: List[float],
                    total: float) -> List[List[int]]:
    """Consecutive indices until their summed length reaches ``total``;
    a last batch short of it is dropped."""
    batches, batch, sum_len = [], [], 0.0
    for idx in idxs:
        batch.append(idx)
        sum_len += lengths[idx]
        if sum_len >= total:
            batches.append(batch)
            batch, sum_len = [], 0.0
    return batches


class SingleConcatLengthSampler(Sampler):
    """Token-budget batches of ``batch_size * max_length`` summed length
    over a shuffled order, the batches shuffled."""

    def __init__(self, batch_size: int, max_length: float,
                 lengths: List[float], seed: Optional[int] = None):
        self.lengths = lengths
        self.total_length = batch_size * max_length
        self.rng = random.Random(seed)

    def __iter__(self):
        idxs = list(range(len(self.lengths)))
        self.rng.shuffle(idxs)
        batches = _concat_batches(idxs, self.lengths, self.total_length)
        self.rng.shuffle(batches)
        return iter(batches)


class DistributedConcatLengthSampler(Sampler):
    """The token-budget batches of an epoch-seeded order, the same on
    every rank; each rank takes its share."""

    def __init__(self, batch_size: int, max_length: float,
                 lengths: List[float], world_size: int, rank: int,
                 seed: int = 1234):
        _check_rank(world_size, rank)
        self.lengths = lengths
        self.total_length = batch_size * max_length
        self.world_size, self.rank = world_size, rank
        self.epoch, self.seed = 0, seed

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        idxs = list(range(len(self.lengths)))
        random.Random(self.epoch + self.seed).shuffle(idxs)
        batches = _concat_batches(idxs, self.lengths, self.total_length)
        return iter(_rank_share(batches, self.world_size, self.rank))


def _need_rank(world_size, rank) -> None:
    if world_size is None or rank is None:
        raise ValueError("a distributed sampler needs world_size and rank")


def random_bucket_sampler(nbuckets: int, lengths: List[float],
                          batch_size: Optional[int] = None,
                          batch_length: Optional[float] = None,
                          drop_last: bool = True,
                          distributed: bool = False,
                          world_size: Optional[int] = None,
                          rank: Optional[int] = None) -> Sampler:
    if distributed:
        _need_rank(world_size, rank)
        return DistributedRandomBucketSampler(
            nbuckets, lengths, world_size, rank, batch_size, batch_length,
            drop_last)
    return SingleRandomBucketSampler(nbuckets, lengths, batch_size,
                                     batch_length, drop_last)


def concat_length_sampler(batch_size: int, max_length: float,
                          lengths: List[float],
                          distributed: bool = False,
                          world_size: Optional[int] = None,
                          rank: Optional[int] = None) -> Sampler:
    if distributed:
        _need_rank(world_size, rank)
        return DistributedConcatLengthSampler(batch_size, max_length,
                                              lengths, world_size, rank)
    return SingleConcatLengthSampler(batch_size, max_length, lengths)
