"""Mixture data loader: sampling across datasets, fixed-shape numpy batches,
and their move to device tensors.

Numpy port of egom2p_tpu/data/mixture.py (reference:
egom2p/data/unified_datasets.py:491-568) for datasets that hold every
modality: each sample comes from one dataset (a uniform choice) and a
background thread keeps a few batches ready.  The draws come in the JAX
package's order, so one seed gives the same batches in both.  Not ported
yet: dataset weights, placeholders for modalities a dataset lacks, and
forked worker processes.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

BATCH_KEYS = ("tensor", "input_mask", "target_mask", "decoder_attention_mask")
PREFETCH = 2  # batches the background thread keeps ready


class DatasetStream:
    """One dataset: a raw-sample iterator factory, restarted when it runs
    out, and its masking."""

    def __init__(self, sample_iter_factory, masking):
        self.factory = sample_iter_factory
        self.masking = masking
        self._it = iter(self.factory())

    def __next__(self):
        try:
            raw = next(self._it)
        except StopIteration:
            self._it = iter(self.factory())
            raw = next(self._it)
        return self.masking(raw)


class MixtureLoader:
    """Uniform mixture of DatasetStreams -> fixed-shape numpy batches."""

    def __init__(self, streams: Sequence[DatasetStream], all_modality_info: Dict,
                 batch_size: int, seed: int = 0):
        self.streams = list(streams)
        self.weights = np.full(len(self.streams), 1.0 / len(self.streams))
        self.all_info = all_modality_info
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def _one_sample(self) -> Dict:
        idx = int(self.rng.choice(len(self.streams), p=self.weights))
        return next(self.streams[idx])

    def _one_batch(self) -> Dict:
        samples = [self._one_sample() for _ in range(self.batch_size)]
        batch = {}
        for mod in self.all_info:
            batch[mod] = {k: np.stack([s[mod][k] for s in samples]) for k in BATCH_KEYS}
            batch[mod]["tensor"] = batch[mod]["tensor"].astype(np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def worker():
            try:
                while not stop.is_set():
                    item = self._one_batch()
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.25)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # surfaces in the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # closing the iterator stops the thread
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join()


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
