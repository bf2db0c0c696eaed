"""Video clip dataset for rgb/depth VQ-VAE tokenizer training.

A numpy copy of egom2p_tpu/data/video_dataset.py, so that the port never
imports the JAX package: the same np.random.default_rng draws in the same
order, so samples are bitwise the JAX dataset's.  mp4 files are decoded by
the port's own native wrapper (data/video_ingest.py, which needs libav;
`.npy` clips need none).  The timm-style strong augmentations
(`auto_augment`, `reprob > 0`) are data/rand_augment.py's, drawn from the
dataset's generator where JAX draws them.  `VideoBatchLoader` makes the
batches in forked worker processes (data/loader.py:LoaderIterator), each
worker on its own seed; with no workers it is the JAX stream.

The JAX module's notes follow.  It is the equivalent of the reference VideoDataset
(reference: egom2p/data/video_dataset.py:392-457 decord clip sampling,
:242-251 train augmentations, :176-190 center-crop + normalize): mp4 decode
goes through the native ingest library instead of decord, the random
16-frame window uses the same linspace resampling, and the four train-time
augmentations (horizontal flip / rotation / brightness / scale, each p=0.3,
reference video_transforms.py:154-177) are reimplemented on numpy/scipy.

Output is channels-last float32 in [-1, 1] (Normalize(0.5, 0.5) like the
reference ClipToTensor+Normalize pipeline), shaped (T, H, W, C) — the TPU
conv layout, not the reference's (C, T, H, W).
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np


# ------------------------------------------------------------- augmentations
def horizontal_flip(video: np.ndarray) -> np.ndarray:
    """(reference: video_transforms.py:176-177)."""
    return np.flip(video, axis=2)


def random_rotation(video: np.ndarray, rng: np.random.Generator,
                    angle_range=(-10, 10)) -> np.ndarray:
    """Small random rotation with reflect padding
    (reference: video_transforms.py:169-174)."""
    from scipy import ndimage
    angle = rng.uniform(*angle_range)
    out = ndimage.rotate(video, angle, axes=(2, 1), reshape=False, order=1,
                         mode="reflect")
    if video.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    return out


def adjust_brightness(video: np.ndarray, rng: np.random.Generator,
                      factor_range=(0.7, 1.3)) -> np.ndarray:
    """(reference: video_transforms.py:165-167)."""
    factor = rng.uniform(*factor_range)
    return np.clip(video.astype(np.float32) * factor, 0, 255).astype(np.uint8)


def random_scaling(video: np.ndarray, rng: np.random.Generator,
                   scale_range=(1.0, 1.2)) -> np.ndarray:
    """Upscale then center-crop back to the original size
    (reference: video_transforms.py:154-163)."""
    from scipy import ndimage
    t, h, w, c = video.shape
    scale = rng.uniform(*scale_range)
    if abs(scale - 1.0) < 1e-3:
        return video
    out = ndimage.zoom(video, (1, scale, scale, 1), order=1)
    nh, nw = out.shape[1:3]
    y0, x0 = (nh - h) // 2, (nw - w) // 2
    return np.ascontiguousarray(out[:, y0:y0 + h, x0:x0 + w])


def center_crop(video: np.ndarray, size: int) -> np.ndarray:
    """(reference CenterCrop, video_dataset.py:178)."""
    h, w = video.shape[1:3]
    y0, x0 = max(0, (h - size) // 2), max(0, (w - size) // 2)
    return video[:, y0:y0 + size, x0:x0 + size]


def normalize_pm1(video_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 [-1, 1] (reference Normalize(0.5, 0.5))."""
    return video_u8.astype(np.float32) / 127.5 - 1.0


# ------------------------------------------------------------------- dataset
class VideoClipDataset:
    """Random fixed-length clip sampler over a set of mp4 (or .npy) files.

    Modes (reference: video_dataset.py __getitem__):
      * 'train': random clip window + augmentations,
      * 'val'  : deterministic clip (same linspace resample, centered window),
      * 'tokenize': sequential full-file iteration for pre-tokenization.
    """

    def __init__(self, data_path: str, mode: str = "train",
                 clip_len: int = 16, crop_size: int = 256,
                 frame_sample_rate: int = 4, domain: str = "rgb",
                 use_npy: bool = False, seed: int = 0,
                 files: Optional[Sequence[str]] = None,
                 auto_augment: Optional[str] = None, reprob: float = 0.0,
                 remode: str = "pixel", recount: int = 1):
        self.mode = mode
        self.clip_len = clip_len
        self.crop_size = crop_size
        self.frame_sample_rate = frame_sample_rate
        self.domain = domain
        self.use_npy = use_npy
        self.rng = np.random.default_rng(seed)
        # opt-in timm-style strong augs, mirroring the reference's
        # args.aa / reprob / remode / recount knobs
        # (reference: video_dataset.py:330-392 _aug_frame)
        self.rand_augment = self.rand_erasing = None
        if mode == "train" and auto_augment:
            from egom2p_torch.data.rand_augment import create_random_augment
            self.rand_augment = create_random_augment(crop_size, auto_augment, rng=self.rng)
        if mode == "train" and reprob > 0:
            from egom2p_torch.data.rand_augment import RandomErasing
            self.rand_erasing = RandomErasing(reprob, mode=remode, max_count=recount,
                                              num_splits=recount, cube=True, rng=self.rng)
        if files is not None:
            self.samples: List[str] = list(files)
        elif os.path.isdir(data_path):
            pat = "*.npy" if use_npy else "*.mp4"
            self.samples = sorted(glob.glob(os.path.join(data_path, pat)))
            if not self.samples:  # recursive fallback
                self.samples = sorted(
                    glob.glob(os.path.join(data_path, "**", pat),
                              recursive=True))
        else:
            self.samples = [data_path]
        if not self.samples:
            raise FileNotFoundError(f"no videos under {data_path}")

    def __len__(self):
        return len(self.samples)

    # -------------------------------------------------------------- loading
    def _load(self, path: str) -> np.ndarray:
        if self.use_npy or path.endswith(".npy"):
            buf = np.load(path)
            h, w = buf.shape[1:3]
            if min(h, w) < self.crop_size:
                # mp4s are pre-scaled by read_video; scale small npy clips
                # up too so center_crop always yields crop_size frames
                from scipy import ndimage
                th = max(self.crop_size,
                         int(np.ceil(h * self.crop_size / min(h, w))))
                tw = max(self.crop_size,
                         int(np.ceil(w * self.crop_size / min(h, w))))
                buf = ndimage.zoom(buf, (1, th / h, tw / w)
                                   + (1,) * (buf.ndim - 3), order=1)
            return buf
        from egom2p_torch.data.video_ingest import read_video
        return read_video(path, out_size=self.crop_size)

    def _sample_window(self, buffer: np.ndarray) -> np.ndarray:
        """Random (train) / centered (val) clip_len-frame window with linspace
        resample (reference: video_dataset.py:436-452)."""
        total = buffer.shape[0]
        converted = self.clip_len * self.frame_sample_rate
        if total <= converted:
            idx = np.linspace(0, max(total - 1, 0), num=self.clip_len)
        else:
            if self.mode == "train":
                end = self.rng.integers(converted, total)
            else:
                end = (total + converted) // 2
            start = end - converted
            idx = np.linspace(start, end - 1, num=self.clip_len)
        idx = np.clip(idx, 0, total - 1).astype(np.int64)
        return buffer[idx]

    def _augment(self, clip: np.ndarray) -> np.ndarray:
        """rgb train augs, each with p=0.3 (reference: video_dataset.py:242-251;
        the reference applies them to the rgb domain only)."""
        if self.domain != "rgb":
            return clip
        if self.rng.random() < 0.3:
            clip = horizontal_flip(clip)
        if self.rng.random() < 0.3:
            clip = random_rotation(clip, self.rng)
        if self.rng.random() < 0.3:
            clip = adjust_brightness(clip, self.rng)
        if self.rng.random() < 0.3:
            clip = random_scaling(clip, self.rng)
        return clip

    def __getitem__(self, index: int) -> np.ndarray:
        path = self.samples[index % len(self.samples)]
        try:
            buffer = self._load(path)
        except Exception:
            # decode failure -> resample a random index
            # (reference: video_dataset.py:220-226)
            import warnings
            warnings.warn(f"video {path} failed to load; resampling")
            return self[int(self.rng.integers(len(self.samples)))]
        clip = self._sample_window(buffer)
        if self.mode == "train":
            clip = self._augment(clip)
        clip = center_crop(clip, self.crop_size)
        if self.rand_augment is not None and self.domain == "rgb":
            clip = self.rand_augment(np.ascontiguousarray(clip), self.rng)
        out = normalize_pm1(np.ascontiguousarray(clip))
        if self.rand_erasing is not None and self.domain == "rgb":
            out = self.rand_erasing(out, self.rng)
        if self.domain == "depth" and out.ndim == 4 and out.shape[-1] == 3:
            out = out.mean(axis=-1, keepdims=True)  # depth stored as rgb mp4
        return out

    def iter_batches(self, batch_size: int, shuffle: bool = True):
        """Host-side batch iterator (single stream; the tokenizer trainer is
        compute-bound on device)."""
        order = np.arange(len(self.samples))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield np.stack([self[int(j)] for j in order[i:i + batch_size]])
            if len(order) < batch_size:  # tiny datasets: resample with repeats
                yield np.stack([self[int(self.rng.integers(len(order)))]
                                for _ in range(batch_size)])


class VideoBatchLoader:
    """`dataset.iter_batches(batch_size)` made in `num_workers` forked
    worker processes (data/loader.py:LoaderIterator; `iter()` starts them,
    `.close()` stops them).  Worker w reseeds the dataset's generator, and
    its augmentations, with `seed + 1000 * (w + 1)`, as the mixture
    loader's workers do.  The workers compute on the host only (numpy,
    scipy and CPU torch, one thread each) and never touch CUDA."""

    def __init__(self, dataset: VideoClipDataset, batch_size: int, seed: int = 0,
                 num_workers: int = 1, prefetch: int = 2, shuffle: bool = True):
        if num_workers < 1:
            raise ValueError("VideoBatchLoader forks workers: use dataset.iter_batches "
                             "for one stream in this process")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shuffle = shuffle

    def _worker_loop(self, out_queue, worker_id: int) -> None:
        import torch
        try:
            torch.set_num_threads(1)  # the parent's OpenMP pool does not survive the fork
            ds = self.dataset
            ds.rng = np.random.default_rng(self.seed + 1000 * (worker_id + 1))
            for aug in (ds.rand_augment, ds.rand_erasing):
                if aug is not None:
                    aug.rng = ds.rng
            for batch in ds.iter_batches(self.batch_size, self.shuffle):
                out_queue.put(batch)
        except Exception as e:  # raised again in the parent
            out_queue.put(e)

    def __iter__(self):
        from egom2p_torch.data.loader import LoaderIterator
        return LoaderIterator(self)
