"""Batching and input features (``closerlook3d_tpu/data/loader.py``).

Numpy only, as in the JAX package: ``BatchIterator`` stacks the samples of
a len/__getitem__ dataset into fixed-shape batches; the train step moves
them to the card. ``host_pipeline(cfg)`` gives its host-side options as
the JAX package's ``Trainer`` sets them, and ``PrefetchIterator`` builds
the next batches in a thread while the card runs a step. With
``process_count`` > 1 each process takes its shard of one shuffled
order, as the JAX package's ``BatchIterator`` does.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np

from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch


def build_features(sample_or_batch: Dict[str, np.ndarray],
                   spec: str) -> np.ndarray:
    """The model's input features named by ``spec``, a comma-separated
    list of {ones, xyz, normals, rgb, height}, concatenated in f32."""
    xyz = sample_or_batch["xyz"]
    parts = []
    for name in spec.split(","):
        name = name.strip()
        if name == "ones":
            parts.append(np.ones_like(xyz[..., :1]))
        elif name == "xyz":
            parts.append(xyz)
        elif name == "normals":
            parts.append(sample_or_batch["normals"])
        elif name == "rgb":
            parts.append(sample_or_batch["rgb"])
        elif name == "height":
            # scene datasets emit absolute height separately; z otherwise
            parts.append(sample_or_batch.get("height", xyz[..., 2:3]))
        else:
            raise ValueError(f"unknown input feature: {name}")
    return np.concatenate(parts, axis=-1).astype(np.float32)


def feature_dim(spec: str) -> int:
    """Channels of the per-point input features named by ``spec``."""
    dims = {"ones": 1, "xyz": 3, "normals": 3, "rgb": 3, "height": 1}
    return sum(dims[p.strip()] for p in spec.split(","))


class BatchIterator:
    """Epoch iterator producing stacked numpy batches.

    Shuffled iteration draws its order from (seed, epoch); ``drop_last``
    drops the ragged last batch (train), otherwise the last batch is
    padded by repeating its last sample and ``batch_pad`` marks the
    padding. ``spatial_sort`` Morton-sorts each batch on the host
    (``cfg.spatial_sort == "host"``); ``transform`` (batch dict -> batch
    dict, host side) runs last, as the geometry precompute does.

    Sharding over processes (DistributedSampler semantics): every process
    draws the same order, wraps it (``np.resize``) to ``process_count``
    times ceil(n / ``process_count``) samples and takes every
    ``process_count``-th from ``process_index``, so that every process
    yields the same number of batches (the step's collectives stay in
    lockstep). ``batch_size`` is the per-process batch.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 feature_spec: str, seed: int = 0, drop_last: bool = True,
                 spatial_sort: bool = False, transform=None,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.feature_spec = feature_spec
        self.seed = seed
        self.drop_last = drop_last
        self.spatial_sort = spatial_sort
        self.transform = transform
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def _local_count(self) -> int:
        return -(-len(self.dataset) // self.process_count)

    def __len__(self):
        n = self._local_count()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 65537 + self.epoch)
            rng.shuffle(order)
        if self.process_count > 1:
            order = np.resize(order,
                              self._local_count() * self.process_count)
            order = order[self.process_index::self.process_count]
        n = len(order)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(0, stop, bs):
            sel = order[start:start + bs]
            pad = bs - len(sel)
            if pad:
                sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
            samples = [self.dataset[int(i)] for i in sel]
            batch = {k: np.stack([s[k] for s in samples])
                     for k in samples[0]}
            batch["features"] = build_features(batch, self.feature_spec)
            batch["batch_pad"] = np.arange(bs) >= (bs - pad)
            if self.spatial_sort:
                batch = morton_sort_batch(batch)
            if self.transform is not None:
                batch = self.transform(batch)
            yield batch


def host_pipeline(cfg) -> Dict[str, Any]:
    """``BatchIterator``'s ``transform`` and ``spatial_sort`` for ``cfg``,
    as the JAX package's ``Trainer`` sets them
    (``closerlook3d_tpu/train/loop.py``): with ``precompute_geometry`` the
    transform is the host geometry precompute, which sorts by itself, so
    it replaces the host sort; otherwise ``spatial_sort: host`` sorts."""
    transform = None
    if getattr(cfg, "precompute_geometry", False):
        from closerlook3d_tpu_torch.data.geometry import (
            precompute_batch_geometry)
        transform = functools.partial(precompute_batch_geometry, cfg=cfg)
    return {"transform": transform,
            "spatial_sort": cfg.spatial_sort == "host" and transform is None}


class PrefetchIterator:
    """Builds a batch iterable's batches in a daemon thread, ``depth``
    ahead, through a bounded queue (the JAX package's
    ``PrefetchIterator``): batch assembly is numpy that releases the
    interpreter lock, so it overlaps the train step's host work and its
    device time. ``set_epoch`` and ``__len__`` delegate, so it stands in
    for ``BatchIterator``; an exception in the producer is raised in the
    consumer.

    Every put, the end marker's included, waits for room in the queue
    for as long as the consumer is there: a consumer that lags behind a
    full queue still gets the marker, and one that leaves early (a
    ``break``, an exception, one ``next``) releases the thread.
    """

    _DONE = object()

    def __init__(self, base, depth: int = 2):
        self.base = base
        self.depth = depth

    def __len__(self):
        return len(self.base)

    def set_epoch(self, epoch: int):
        self.base.set_epoch(epoch)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.base:
                    if not put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 - raised by the consumer
                err.append(e)
            put(self._DONE)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                yield item
        finally:
            # on exhaustion, and when the consumer leaves early: release
            # the producer and drop what it had queued
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
        if err:
            raise err[0]
