"""Mixture data loader: weighted sampling across datasets, fixed-shape numpy
batches, forked worker processes, and the move to device tensors.

Numpy port of egom2p_tpu/data/mixture.py (reference:
egom2p/data/unified_datasets.py:491-568): each sample comes from one dataset
(a weighted choice), modalities a dataset lacks get fully masked
placeholders, and integer tokens become int32 (float tensors float32).  The
draws come in the JAX package's order, so one seed gives the same batches in
both; with `num_workers` > 0 each forked worker reseeds as the JAX worker
does (`seed + 1000 * (worker_id + 1)`, plus a crc32 salt of the dataset's
name for its stream), so worker w's batch sequence is the JAX worker w's.

`iter(loader)` starts the producers at once: one background thread
(num_workers=0), or the forked workers.  The workers run numpy and the tar
reader only: they never touch CUDA, a torch tensor or pinned memory, so they
may be forked from a process whose CUDA context is up (chip_smoke.py does,
on the card); the trainer still forks them before its first CUDA call
(cli/run_training.py), so the children inherit no device state at all.
Closing the iterator (or dropping it) stops the thread, or terminates and
joins every worker.
"""
from __future__ import annotations

import inspect
import queue
import threading
import zlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from egom2p_torch.data.masking import IMG_TYPES

BATCH_KEYS = ("tensor", "input_mask", "target_mask", "decoder_attention_mask")


def make_empty_mod_entry(info: Dict) -> Dict[str, np.ndarray]:
    """Fully masked placeholder for a modality a dataset lacks (reference:
    unified_datasets.py:491-553): the shape and dtype UnifiedMasking gives a
    real sample of it, so that the batch stacks."""
    spec = info.get("embed_spec", {})
    L = info["max_tokens"]
    if spec.get("kind") == "sequence_emb":  # float rows, token-level masks
        tensor = np.zeros((L, spec["orig_emb_dim"]), dtype=np.float32)
    elif spec.get("kind") == "image_raw":  # pixels; the masks are per patch
        size = spec["image_size"]
        tensor = np.zeros((size, size, spec["num_channels"]), dtype=np.float32)
    elif info["type"] in IMG_TYPES:
        tensor = np.zeros(L, dtype=np.int32)
    else:  # seq / seq_token: the (max_tokens + 1) * 2 packed slots
        L = (L + 1) * 2
        tensor = np.zeros(L, dtype=np.int32)
    return {"tensor": tensor,
            "input_mask": np.ones(L, dtype=bool),
            "target_mask": np.ones(L, dtype=bool),
            "decoder_attention_mask": np.zeros(L, dtype=np.int32)}


class DatasetStream:
    """One dataset: a raw-sample iterator factory, restarted when it runs
    out, and its masking."""

    def __init__(self, sample_iter_factory, masking, name: str = "stream"):
        self.name = name
        self.factory = sample_iter_factory
        self.masking = masking
        self._factory_kw: Dict = {}
        self._it = iter(self.factory())

    def reseed(self, worker_seed: int, worker_id: int = 0, num_workers: int = 1) -> None:
        """A worker's own sample order: reseeds the masking and, where the
        factory takes them, rebuilds the raw stream with the worker's seed
        and its share of the shards, kept for every later pass
        (egom2p_tpu/data/mixture.py:DatasetStream.reseed)."""
        self.masking.rng = np.random.default_rng(worker_seed)
        params = inspect.signature(self.factory).parameters
        kw = {}
        if "seed" in params:
            kw["seed"] = worker_seed
        if "worker_id" in params and "num_workers" in params:
            kw["worker_id"] = worker_id
            kw["num_workers"] = num_workers
        self._factory_kw = kw
        self._it = iter(self.factory(**kw))

    def __next__(self):
        try:
            raw = next(self._it)
        except StopIteration:
            if "seed" in self._factory_kw:
                # the next pass shuffles with the next seed
                self._factory_kw = {**self._factory_kw, "seed": self._factory_kw["seed"] + 1}
            self._it = iter(self.factory(**self._factory_kw))
            try:
                raw = next(self._it)
            except StopIteration:
                raise RuntimeError(f"dataset {self.name}: a whole pass over its samples "
                                   "gave none") from None
        return self.masking(raw)


class MixtureLoader:
    """Weighted mixture of DatasetStreams -> fixed-shape numpy batches.

    `weights` weigh the datasets (None: uniform); `prefetch` batches wait
    in the queue; `num_workers` > 0 forks that many worker processes."""

    def __init__(self, streams: Sequence[DatasetStream], all_modality_info: Dict,
                 batch_size: int, seed: int = 0, weights: Optional[Sequence[float]] = None,
                 prefetch: int = 2, num_workers: int = 0):
        self.streams = list(streams)
        w = np.asarray(weights if weights is not None else [1.0] * len(self.streams),
                       dtype=np.float64)
        self.weights = w / w.sum()
        self.all_info = all_modality_info
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.num_workers = num_workers

    def _one_sample(self) -> Dict:
        idx = int(self.rng.choice(len(self.streams), p=self.weights))
        masked = next(self.streams[idx])
        for mod, info in self.all_info.items():
            if mod not in masked:
                masked[mod] = make_empty_mod_entry(info)
        return masked

    def _one_batch(self) -> Dict:
        samples = [self._one_sample() for _ in range(self.batch_size)]
        batch = {}
        for mod in self.all_info:
            batch[mod] = {k: np.stack([s[mod][k] for s in samples]) for k in BATCH_KEYS}
            # shards may hold narrow integers (the reference widens int16 on
            # load, unified_datasets.py:218-222)
            t = batch[mod]["tensor"]
            batch[mod]["tensor"] = t.astype(np.int32 if t.dtype.kind in "iu" else np.float32)
        return batch

    def _worker_setup(self, worker_id: int) -> None:
        """Worker `worker_id`'s seeds (egom2p_tpu/data/mixture.py:_worker_loop):
        crc32, not hash(), salts each stream (str hashes change between
        interpreters)."""
        base = self.seed + 1000 * (worker_id + 1)
        self.rng = np.random.default_rng(base)
        for s in self.streams:
            salt = zlib.crc32(s.name.encode()) % 997 + 1
            s.reseed(base + salt, worker_id=worker_id, num_workers=self.num_workers)

    def _worker_loop(self, out_queue, worker_id: int) -> None:
        """The body of a forked worker: its seeds, then batches into
        `out_queue` until the parent terminates it."""
        try:
            self._worker_setup(worker_id)
            while True:
                out_queue.put(self._one_batch())
        except Exception as e:  # raised again in the parent
            out_queue.put(e)

    def __iter__(self) -> "LoaderIterator":
        return LoaderIterator(self)


class LoaderIterator:
    """The producers of one pass: started on construction, stopped by
    close()."""

    def __init__(self, loader: MixtureLoader):
        self.workers = []
        self._thread = None
        self._closed = False
        if loader.num_workers > 0:
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            self._queue = ctx.Queue(maxsize=max(loader.prefetch, loader.num_workers))
            self.workers = [ctx.Process(target=loader._worker_loop, args=(self._queue, w),
                                        daemon=True) for w in range(loader.num_workers)]
            for p in self.workers:
                p.start()
        else:
            self._queue = queue.Queue(maxsize=loader.prefetch)
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._produce, args=(loader,), daemon=True)
            self._thread.start()

    def _produce(self, loader: MixtureLoader) -> None:
        try:
            while not self._stop.is_set():
                item = loader._one_batch()
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # raised again in the consumer
            self._queue.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        if self._closed:
            raise StopIteration
        item = self._queue.get()
        if isinstance(item, Exception):
            self.close()
            raise item
        return item

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._stop.set()
            try:
                self._queue.get_nowait()  # unblocks a put waiting on a full queue
            except queue.Empty:
                pass
            self._thread.join()
            return
        for p in self.workers:
            p.terminate()
        for p in self.workers:
            p.join()
        self._queue.cancel_join_thread()
        self._queue.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the modules may be gone
            pass


def batch_to_device(batch: Dict, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A numpy mod-dict batch as tensors on `device` (host copies pinned on
    a CUDA target, so the transfer is asynchronous)."""
    device = torch.device(device)
    out = {}
    for mod, d in batch.items():
        out[mod] = {}
        for k, v in d.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            out[mod][k] = t.to(device, non_blocking=True)
    return out
