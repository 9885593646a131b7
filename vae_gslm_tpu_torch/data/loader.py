"""Prefetching data loader (port of ``vae_gslm_tpu/data/loader.py``).

A thread pool builds the batches ahead of the consumer (``prefetch``
batches staged), overlapping file IO and feature extraction with the
model; a dataset whose features run on the card issues its device work
from these threads, asynchronously.  ``get_dataloader`` builds the
standard, bucket or concat sampler's loader for one process or one
rank.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

from ..hparams.hp import Hparams
from .sampler import (Sampler, concat_length_sampler, random_bucket_sampler,
                      standard_sampler)


class DataLoader:
    def __init__(self, dataset, sampler: Sampler,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn or dataset.seq_collate
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def _make_batch(self, indices) -> Dict[str, Any]:
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batch_indices = list(iter(self.sampler))
        if not batch_indices:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # a failed batch ends the stream and is re-raised to the
            # consumer (a dead producer would leave it waiting forever)
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    futures = [pool.submit(self._make_batch, b)
                               for b in batch_indices]
                    for fut in futures:
                        if stop.is_set():
                            for f in futures:
                                f.cancel()
                            return
                        q.put(fut.result())
                q.put(None)
            except Exception as e:  # noqa: BLE001 (handed to the consumer)
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self) -> int:
        try:
            return len(self.sampler)
        except TypeError:
            return sum(1 for _ in iter(self.sampler))


def get_dataloader(hp: Hparams, dataset, distributed: bool = False,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None) -> DataLoader:
    """JAX's sampler dispatch (``BaseTrainer.get_dataloader`` :238-266):
    ``sampler.type`` ``standard`` (``batch_size``), ``bucket``
    (``sampler.num_buckets`` and ``batch_size`` or ``batch_length``, over
    the dataset's ``lengths``) or ``concat`` (``batch_size`` x ``length``
    of summed length), each of one process or, with ``distributed``, of
    this rank (a world of 1 when the caller runs alone)."""
    hp.check_arg_in_hparams("num_workers", "sampler")
    styp = hp.sampler.type
    if styp == "standard":
        hp.check_arg_in_hparams("batch_size")
        sampler = standard_sampler(
            len(dataset), hp.batch_size, shuffle=hp.sampler.shuffle,
            distributed=distributed, world_size=world_size, rank=rank,
            drop_last=hp.sampler.get("drop_last", True))
    elif styp == "bucket":
        hp.sampler.check_arg_in_hparams("num_buckets")
        sampler = random_bucket_sampler(
            hp.sampler.num_buckets, dataset.lengths,
            hp.get("batch_size", None), hp.get("batch_length", None),
            hp.sampler.get("drop_last", False), distributed,
            world_size=world_size, rank=rank)
    elif styp == "concat":
        hp.check_arg_in_hparams("batch_size", "length")
        sampler = concat_length_sampler(
            hp.batch_size, hp.length, dataset.lengths, distributed,
            world_size=world_size, rank=rank)
    else:
        raise NotImplementedError(f"sampler type {styp!r}")
    return DataLoader(dataset, sampler, num_workers=hp.num_workers)
