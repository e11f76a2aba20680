"""Data loading: index sampling, batching, threaded prefetch, pinned staging
to the card, MetaLoader (port of lavender_tpu/data/loader.py).

Replaces the reference's torch DataLoader machinery (dataset.py:279-330,
620-748, utils/data_sampler.py) with the JAX package's pipeline:

* ``ShardedSampler`` — deterministic per-rank index shard (the
  DistributedSampler equivalent);
* ``DataLoader`` — thread-pool __getitem__ + background prefetch queue
  (JPEG decode in cv2/PIL and the native library release the GIL, so
  threads scale); with ``pin_memory=True`` it collates straight into
  page-locked host tensors;
* ``device_prefetch`` — keeps ``depth`` batches in flight to the card:
  each copied from pinned memory with ``non_blocking=True`` on a side
  stream, the consumer's stream waiting on the copy's event;
* ``MetaLoader`` — ratio-weighted multi-task sampling with a shared seed
  (dataset.py:702-748): every rank draws the same task sequence.
"""
from __future__ import annotations

import collections
import math
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


def _pinned(shape, dtype: np.dtype) -> torch.Tensor:
    return torch.empty(shape, pin_memory=True,
                       dtype=torch.from_numpy(np.empty(0, dtype)).dtype)


def default_collate(items: List, pin_memory: bool = False) -> Dict:
    """Stack a list of dicts of numpy arrays / scalars.  Arrays and scalars
    stack into numpy arrays or, with ``pin_memory``, into page-locked torch
    tensors (arrays stacked in place: no pageable staging)."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            if pin_memory:
                out[k] = _pinned((len(vals),) + vals[0].shape, vals[0].dtype)
                np.stack(vals, axis=0, out=out[k].numpy())
            else:
                out[k] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.asarray(vals)
            if pin_memory:
                t = _pinned(out[k].shape, out[k].dtype)
                t.numpy()[...] = out[k]
                out[k] = t
        else:
            out[k] = vals  # strings / raw objects pass through
    return out


class ShardedSampler:
    """Per-rank contiguous-stride shard of shuffled indices.

    Equivalent of torch DistributedSampler (dataset.py:281); pads the index
    list so every rank sees the same number of batches.
    """

    def __init__(self, n: int, shuffle: bool, seed: int = 88,
                 rank: int = 0, world: int = 1):
        self.n, self.shuffle, self.seed = n, shuffle, seed
        self.rank, self.world = rank, world
        self.epoch = 0

    def set_epoch(self, ep: int):
        self.epoch = ep

    def indices(self) -> List[int]:
        idx = list(range(self.n))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        per = int(math.ceil(self.n / self.world))
        idx = (idx + idx[: per * self.world - self.n])[
            self.rank * per:(self.rank + 1) * per]
        return idx


class LimitedSampler(ShardedSampler):
    """Cap samples per rank per epoch (DistributedSamplerLimited,
    utils/data_sampler.py:13-95)."""

    def __init__(self, n: int, shuffle: bool, limited: int, seed: int = 88,
                 rank: int = 0, world: int = 1):
        super().__init__(n, shuffle, seed, rank, world)
        self.limited = limited

    def indices(self) -> List[int]:
        idx = super().indices()
        return idx[: self.limited] if self.limited > 0 else idx


class NodeSplitSampler(ShardedSampler):
    """Composite-source-aware split: keep each source's rows on one rank
    (NodeSplitSampler, utils/data_sampler.py:98-193) so a rank touches few
    shard files."""

    def __init__(self, source_idx: Sequence[int], shuffle: bool,
                 seed: int = 88, rank: int = 0, world: int = 1):
        super().__init__(len(source_idx), shuffle, seed, rank, world)
        self.source_idx = list(source_idx)

    def indices(self) -> List[int]:
        by_src = collections.defaultdict(list)
        for i, s in enumerate(self.source_idx):
            by_src[s].append(i)
        sources = sorted(by_src)
        rng = random.Random(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(sources)
        mine: List[int] = []
        for j, s in enumerate(sources):
            if j % self.world == self.rank:
                rows = by_src[s]
                if self.shuffle:
                    rng.shuffle(rows)
                mine.extend(rows)
        return mine


class IterationBasedBatchIter:
    """Wraps batch iteration to run a fixed number of iterations, cycling
    epochs (IterationBasedBatchSampler, utils/data_sampler.py:196-222)."""

    def __init__(self, loader: "DataLoader", num_iters: int,
                 start_iter: int = 0):
        self.loader = loader
        self.num_iters = num_iters
        self.iteration = start_iter

    def __len__(self):
        return self.num_iters

    def __iter__(self):
        ep = 0
        while self.iteration < self.num_iters:
            self.loader.set_epoch(ep)
            for batch in self.loader:
                if self.iteration >= self.num_iters:
                    return
                self.iteration += 1
                yield batch
            ep += 1


class DataLoader:
    """Minimal threaded batch loader over a map-style dataset.
    ``pin_memory``: the default collate writes the arrays into page-locked
    torch tensors (for ``device_prefetch``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 collate_fn: Optional[Callable] = None, seed: int = 88,
                 rank: int = 0, world: int = 1, prefetch: int = 2,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate = collate_fn or getattr(
            dataset, "collate_batch",
            lambda items: default_collate(items, pin_memory))
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.sampler = ShardedSampler(
            len(dataset), shuffle, seed, rank, world)

    def set_epoch(self, ep: int):
        self.sampler.set_epoch(ep)

    def __len__(self):
        n = len(self.sampler.indices())
        if self.drop_last:
            # a corpus smaller than one batch still yields ONE wrapped
            # batch (torch DistributedSampler pads indices to even) so
            # tiny datasets never train zero steps
            return max(1, n // self.batch_size) if n else 0
        return int(math.ceil(n / self.batch_size))

    def _batches(self) -> List[List[int]]:
        idx = self.sampler.indices()
        if self.drop_last and idx and len(idx) < self.batch_size:
            reps = int(math.ceil(self.batch_size / len(idx)))
            idx = (idx * reps)[: self.batch_size]
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batches()
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, b))
                        q.put(self.collate(items))
                q.put(None)
            except BaseException as e:  # re-raised in the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass


def _to_device(value, device: torch.device):
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=True)
    return value  # strings / raw objects pass through


def device_prefetch(iterator, device="cuda", depth: int = 2,
                    keys: Optional[Sequence[str]] = None):
    """Overlap host batch prep with device compute: keep ``depth`` batches
    (dicts of numpy arrays or tensors, best page-locked: ``DataLoader(...,
    pin_memory=True)``) already on their way to ``device`` ahead of the
    consumer; ``keys``: the entries to move (default every array; the
    others pass through as they are).  On a CUDA device each batch is copied with
    ``non_blocking=True`` on a side stream, and the consumer's current
    stream waits on that copy's event before it gets the batch (the
    tensors are recorded on the consumer's stream, so the allocator keeps
    them until its work is done).  On the CPU the batches pass through as
    tensors."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    buf = collections.deque()

    def move(batch):
        return {k: _to_device(v, device) if keys is None or k in keys else v
                for k, v in batch.items()}

    def start_copy(batch):
        if not cuda:
            return None, move(batch)
        with torch.cuda.stream(copy_stream):
            out = move(batch)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return done, out

    it = iter(iterator)
    for batch in it:
        buf.append(start_copy(batch))
        if len(buf) == depth:
            break
    while buf:
        done, out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(start_copy(nxt))
        if cuda:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for v in out.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(stream)
        yield out


class MetaLoader:
    """Infinite ratio-weighted multi-task iterator (dataset.py:702-748).

    The reference broadcasts rank-0's task choice every step; here every
    rank draws from the same seeded RNG, so all ranks agree with zero
    communication.
    """

    def __init__(self, loaders: Dict[str, "DataLoader"],
                 ratios: Optional[Dict[str, int]] = None,
                 accum_steps: int = 1, seed: int = 88):
        self.name2loader = dict(loaders)
        self.pool: List[str] = []
        for name in loaders:
            r = (ratios or {}).get(name, 1)
            self.pool.extend([name] * int(r))
        self.accum_steps = accum_steps
        self.rng = random.Random(seed)
        self.name2iter = {n: iter(l) for n, l in self.name2loader.items()}
        self.step = 0

    def __iter__(self):
        task = self.pool[0]
        while True:
            if self.step % self.accum_steps == 0:
                task = self.rng.choice(self.pool)
            self.step += 1
            it = self.name2iter[task]
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.name2loader[task])
                self.name2iter[task] = it
                batch = next(it)
            yield task, batch
