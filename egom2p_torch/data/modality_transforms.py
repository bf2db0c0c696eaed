"""Per-modality transform + augmentation zoo (host-side, numpy).

Port of egom2p_tpu/data/modality_transforms.py, with no Pillow and no
OpenCV in the pixel work (the card's machine may have neither): crops are
resized by data/resample.py, Pillow's resample arithmetic in numpy / torch
(the JAX package's bytes for 8-bit and float images; 16-bit depth within
one level at exact halves), the SAM polygons are rasterized by
`fill_polygon` (cv2.fillPoly's scanline fill plus its 8-connected edges)
and tested by `point_polygon_test` (cv2.pointPolygonTest's crossing
rule, exact).  Pillow decodes image files only, inside
`ImageTransform.image_loader`.  The Python `random` and numpy draws come in
the JAX module's order.  tests/test_torch_modality_transforms.py holds each
transform against the JAX module.

The JAX module's notes follow.  It is a compact reimplementation of the reference's transform stack
(reference: egom2p/data/modality_transforms.py:39-1341,
image_augmenter.py:23-190): every transform is a 4-stage
load -> preprocess -> image_augment -> postprocess pipeline, and one
*image augmenter* draws the shared (crop, flip, size) settings that all
modalities of a sample must agree on.

TPU-idiomatic differences: images flow as numpy HWC arrays end to end
(channels-last matches the device layout, so the host never transposes), and
outputs are plain numpy (float32/int64/bool) ready for `jnp.asarray`.

The SAM-instance / human-pose / color-palette transforms of the dormant 4M
modalities are implemented too (they are pure data processing; the external
models are only needed upstream to *produce* their npy/json files).
"""
from __future__ import annotations

import gzip
import json
import math
import random
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


# --------------------------------------------------------------- helpers
def get_transform_key(mod_name: str) -> str:
    """'rgb@448' -> 'rgb' (reference: modality_transforms.py:39)."""
    return mod_name.split("@")[0]


def get_transform_resolution(mod_name: str, default_resolution,
                             to_tuple: bool = True):
    res = (int(mod_name.split("@")[1]) if "@" in mod_name
           else default_resolution)
    if to_tuple and not isinstance(res, (tuple, list)):
        return (res, res)
    return res


def get_transform(mod_name: str, transforms_dict: Dict):
    return transforms_dict.get(get_transform_key(mod_name),
                               IdentityTransform())


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


def _resample(mode: Optional[str]) -> str:
    if mode not in ("bilinear", "bicubic", "nearest", None):
        raise ValueError(f"Resample mode {mode} is not supported.")
    return mode or "bilinear"


def image_crop_and_resize(img: np.ndarray, crop_coords: Tuple,
                          target_size: Tuple,
                          resample_mode: str = None) -> np.ndarray:
    """Crop (top, left, h, w) then resize to (H, W).  Out-of-bounds crops
    zero-pad, matching torchvision's TF.crop semantics."""
    from egom2p_torch.data.resample import resize
    top, left, h, w = crop_coords
    th, tw = _to_2tuple(target_size)
    oh, ow = img.shape[:2]
    canvas_shape = (h, w) + img.shape[2:]
    canvas = np.zeros(canvas_shape, dtype=img.dtype)
    y0, x0 = max(0, top), max(0, left)
    y1, x1 = min(oh, top + h), min(ow, left + w)
    if y1 > y0 and x1 > x0:
        canvas[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    # float images resample as Pillow's 'F' mode (float32), channel by channel
    return resize(canvas, (th, tw), _resample(resample_mode))


def image_hflip(img: np.ndarray, flip: bool) -> np.ndarray:
    return img[:, ::-1].copy() if flip else img


# ------------------------------------------------------------ augmenters
class AbstractImageAugmenter(ABC):
    """Draws the per-sample (crop_coords, flip, orig_size, target_size,
    rand_aug_idx) shared by all modalities (reference:
    image_augmenter.py:23-29)."""

    @abstractmethod
    def __call__(self, mod_dict, crop_settings):
        ...

    @staticmethod
    def _main_image(mod_dict, main_domain):
        v = (mod_dict[main_domain] if main_domain in mod_dict
             else next(iter(mod_dict.values())))
        return np.asarray(v)


class RandomCropImageAugmenter(AbstractImageAugmenter):
    """torchvision RandomResizedCrop parameter sampling
    (reference: image_augmenter.py:32-59)."""

    def __init__(self, target_size=224, hflip=0.5, crop_scale=(0.2, 1.0),
                 crop_ratio=(0.75, 1.3333), main_domain="rgb"):
        self.target_size = _to_2tuple(target_size)
        self.hflip = hflip
        self.crop_scale = crop_scale
        self.crop_ratio = crop_ratio
        self.main_domain = main_domain

    def _get_params(self, height, width):
        area = height * width
        log_ratio = (math.log(self.crop_ratio[0]), math.log(self.crop_ratio[1]))
        for _ in range(10):
            target_area = area * random.uniform(*self.crop_scale)
            aspect = math.exp(random.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                top = random.randint(0, height - h)
                left = random.randint(0, width - w)
                return top, left, h, w
        # fallback: center crop at the clamped aspect ratio
        in_ratio = width / height
        if in_ratio < self.crop_ratio[0]:
            w, h = width, int(round(width / self.crop_ratio[0]))
        elif in_ratio > self.crop_ratio[1]:
            h, w = height, int(round(height * self.crop_ratio[1]))
        else:
            w, h = width, height
        return (height - h) // 2, (width - w) // 2, h, w

    def __call__(self, mod_dict, crop_settings):
        if crop_settings is not None:
            raise ValueError("Crop settings are provided but not used by "
                             "this augmenter.")
        image = self._main_image(mod_dict, self.main_domain)
        orig_size = image.shape[:2]
        crop_coords = self._get_params(*orig_size)
        flip = random.random() < self.hflip
        return crop_coords, flip, orig_size, self.target_size, None


class NoImageAugmenter(AbstractImageAugmenter):
    """(reference: image_augmenter.py:61-76)."""

    def __init__(self, no_aug=True, main_domain="human_poses"):
        self.no_aug = no_aug
        self.main_domain = main_domain
        self.target_size = None

    def __call__(self, mod_dict, crop_settings):
        return (0, 0, 224, 224), 0, (224, 224), self.target_size, 0


class PreTokenizedImageAugmenter(AbstractImageAugmenter):
    """Picks a stored crop-setting index so pre-tokenized modalities select
    the matching token grid (reference: image_augmenter.py:78-99)."""

    def __init__(self, target_size, no_aug=False, main_domain="rgb"):
        self.target_size = _to_2tuple(target_size)
        self.no_aug = no_aug
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings):
        if self.main_domain in mod_dict and "tok" not in self.main_domain:
            orig_size = self._main_image(mod_dict, self.main_domain).shape[:2]
        else:
            orig_size = None
        rand_aug_idx = 0 if self.no_aug else np.random.randint(
            len(crop_settings))
        top, left, h, w, flip = [int(v) for v in crop_settings[rand_aug_idx]]
        return (top, left, h, w), flip, orig_size, self.target_size, \
            rand_aug_idx


class CenterCropImageAugmenter(AbstractImageAugmenter):
    def __init__(self, target_size, hflip=0.0, main_domain="rgb"):
        self.target_size = _to_2tuple(target_size)
        self.hflip = hflip
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings=None):
        h0, w0 = self._main_image(mod_dict, self.main_domain).shape[:2]
        if h0 > w0:
            crop_coords = ((h0 - w0) // 2, 0, w0, w0)
        else:
            crop_coords = (0, (w0 - h0) // 2, h0, h0)
        return crop_coords, random.random() < self.hflip, (h0, w0), \
            self.target_size, None


class PaddingImageAugmenter(AbstractImageAugmenter):
    """Crop-to-enclosing-square (zero pad) (reference:
    image_augmenter.py:128-146)."""

    def __init__(self, target_size, hflip=0.0, main_domain="rgb"):
        self.target_size = _to_2tuple(target_size)
        self.hflip = hflip
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings):
        h0, w0 = self._main_image(mod_dict, self.main_domain).shape[:2]
        s = max(h0, w0)
        return (0, 0, s, s), random.random() < self.hflip, (h0, w0), \
            self.target_size, None


class ScaleJitteringImageAugmenter(AbstractImageAugmenter):
    """(reference: image_augmenter.py:148-178)."""

    def __init__(self, target_size, hflip=0.0, scale=(0.1, 2.0),
                 main_domain="rgb"):
        self.target_size = _to_2tuple(target_size)
        self.hflip = hflip
        self.scale = scale
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings):
        if crop_settings is not None:
            raise ValueError("Crop settings are provided but not used by "
                             "this augmenter.")
        h0, w0 = self._main_image(mod_dict, self.main_domain).shape[:2]
        rand_scale = np.random.uniform(*self.scale)
        s = round(max(h0, w0) / rand_scale)
        top = round(max(0, np.random.uniform(0, h0 - s)))
        left = round(max(0, np.random.uniform(0, w0 - s)))
        return (top, left, s, s), random.random() < self.hflip, (h0, w0), \
            self.target_size, None


class EmptyAugmenter(AbstractImageAugmenter):
    def __call__(self, mod_dict, crop_settings):
        return None, None, None, None, None


# ------------------------------------------------------------ transforms
class AbstractTransform(ABC):
    """load -> preprocess -> image_augment -> postprocess
    (reference: modality_transforms.py:141-158)."""

    def load(self, path):
        raise NotImplementedError

    def preprocess(self, sample):
        return sample

    def image_augment(self, v, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        return v

    def postprocess(self, v):
        return v


class IdentityTransform(AbstractTransform):
    def load(self, path):
        return np.load(path)


class ImageTransform(AbstractTransform):
    @staticmethod
    def image_loader(path: str) -> np.ndarray:
        """Decode an image file (.npy arrays load with numpy); PNG / JPEG
        files need Pillow."""
        if str(path).endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"decoding {path} needs Pillow (pip install pillow); .npy "
                              "arrays load without it") from e
        return np.asarray(Image.open(path))


class RGBTransform(ImageTransform):
    """(reference: modality_transforms.py:202-247).  Output float32 HWC,
    imagenet- or [-1,1]-normalized."""

    def __init__(self, imagenet_default_mean_and_std=True,
                 color_jitter=False, color_jitter_strength=0.5):
        default = imagenet_default_mean_and_std
        self.rgb_mean = np.asarray(
            IMAGENET_DEFAULT_MEAN if default else IMAGENET_INCEPTION_MEAN,
            np.float32)
        self.rgb_std = np.asarray(
            IMAGENET_DEFAULT_STD if default else IMAGENET_INCEPTION_STD,
            np.float32)
        self.color_jitter = color_jitter
        self.strength = color_jitter_strength

    def load(self, path):
        return self.image_loader(path)

    def _jitter(self, img: np.ndarray) -> np.ndarray:
        """Pix2Seq/SimCLR-style jitter: random brightness/contrast/saturation
        (p=0.8) + random grayscale (p=0.2)."""
        x = img.astype(np.float32)
        if random.random() < 0.8:
            s = 0.8 * self.strength
            x = x * np.random.uniform(1 - s, 1 + s)                # brightness
            x = (x - x.mean()) * np.random.uniform(1 - s, 1 + s) + x.mean()
            gray = x.mean(axis=-1, keepdims=True)                  # saturation
            x = gray + (x - gray) * np.random.uniform(1 - s, 1 + s)
        if random.random() < 0.2:
            lum = (x * np.asarray([0.299, 0.587, 0.114])).sum(-1, keepdims=True)
            x = np.repeat(lum, 3, axis=-1)
        return np.clip(x, 0, 255).astype(np.uint8)

    def preprocess(self, sample):
        sample = np.asarray(sample)
        if sample.ndim == 2:
            sample = np.stack([sample] * 3, axis=-1)
        sample = sample[..., :3]
        if self.color_jitter:
            sample = self._jitter(sample)
        return sample

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        img = image_crop_and_resize(img, crop_coords, target_size,
                                    resample_mode)
        return image_hflip(img, flip)

    def postprocess(self, sample):
        x = np.asarray(sample, np.float32) / 255.0
        return (x - self.rgb_mean) / self.rgb_std


class DepthTransform(ImageTransform):
    """uint16 depth png -> truncated-standardized float map
    (reference: modality_transforms.py:249-290)."""

    def __init__(self, standardize_depth=True):
        self.standardize_depth = standardize_depth

    @staticmethod
    def truncated_depth_standardization(depth: np.ndarray,
                                        thresh: float = 0.1) -> np.ndarray:
        trunc = np.sort(depth.reshape(-1))
        trunc = trunc[int(thresh * trunc.size): int((1 - thresh) * trunc.size)]
        return (depth - trunc.mean()) / np.sqrt(trunc.var() + 1e-6)

    def load(self, path):
        return self.image_loader(path)

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        img = image_crop_and_resize(np.asarray(img), crop_coords, target_size,
                                    resample_mode)
        return image_hflip(img, flip)

    def postprocess(self, sample):
        x = np.asarray(sample, np.float32) / (2 ** 16 - 1.0)
        if self.standardize_depth:
            x = self.truncated_depth_standardization(x)
        return x[..., None] if x.ndim == 2 else x


class NormalTransform(ImageTransform):
    """Surface normals; hflip negates the x component
    (reference: modality_transforms.py:293-329)."""

    def __init__(self, standardize_surface_normals=False):
        self.mean = np.asarray((0.5, 0.5, 0.5), np.float32)
        self.std = np.asarray((0.5, 0.5, 0.5), np.float32)

    def load(self, path):
        return self.image_loader(path)

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        img = image_crop_and_resize(np.asarray(img), crop_coords, target_size,
                                    resample_mode)
        if flip:
            img = image_hflip(img, True)
            img = img.copy()
            img[..., 0] = 255 - img[..., 0]
        return img

    def postprocess(self, sample):
        x = np.asarray(sample, np.float32) / 255.0
        return (x - self.mean) / self.std


class SemsegTransform(ImageTransform):
    """(reference: modality_transforms.py:331-386)."""

    def __init__(self, scale_factor=1.0, shift_idx_by_one=False,
                 id_mapping: Optional[Dict] = None, select_channel=None):
        self.scale_factor = scale_factor
        self.shift_idx_by_one = shift_idx_by_one
        self.id_mapping = id_mapping
        self.select_channel = select_channel

    def load(self, path):
        img = self.image_loader(path)
        if self.select_channel is not None and img.ndim == 3:
            img = img[..., self.select_channel]
        return img

    def preprocess(self, sample):
        sample = np.asarray(sample)
        if sample.ndim == 3:
            sample = sample[..., 0]
        if self.id_mapping is not None:
            lut = np.arange(256)
            for k, v in self.id_mapping.items():
                lut[k] = v
            sample = lut[sample].astype(sample.dtype)
        if self.shift_idx_by_one:
            sample = sample + 1
        return sample.astype(np.uint8)

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        # always nearest for label maps
        img = image_crop_and_resize(img, crop_coords, target_size, "nearest")
        return image_hflip(img, flip)

    def postprocess(self, sample):
        x = np.asarray(sample)
        if self.scale_factor != 1.0:
            from egom2p_torch.data.resample import resize
            h, w = x.shape[:2]
            x = resize(x, (int(h * self.scale_factor), int(w * self.scale_factor)), "nearest")
        return x.astype(np.int64)


class MaskTransform(ImageTransform):
    """Validity masks; min-pool expansion (reference:
    modality_transforms.py:574-604)."""

    def __init__(self, mask_pool_size=1):
        assert isinstance(mask_pool_size, int)
        self.mask_pool_size = mask_pool_size

    def load(self, path):
        return self.image_loader(path)

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        img = image_crop_and_resize(np.asarray(img), crop_coords, target_size,
                                    "nearest")
        return image_hflip(img, flip)

    def postprocess(self, sample):
        m = np.asarray(sample, np.float32)
        if m.max() > 1:
            m = m / 255.0
        if m.ndim == 3:
            m = m[..., 0]
        p = self.mask_pool_size
        if p > 1:
            h, w = m.shape
            # edge-pad to a multiple of p (pad with 1.0 = valid, the min
            # pool's identity) so the output keeps the input's shape
            ph, pw = -h % p, -w % p
            if ph or pw:
                m = np.pad(m, ((0, ph), (0, pw)), constant_values=1.0)
            pooled = m.reshape((h + ph) // p, p,
                               (w + pw) // p, p).min(axis=(1, 3))
            m = np.repeat(np.repeat(pooled, p, axis=0), p, axis=1)[:h, :w]
        return m == 1.0


class TokTransform(AbstractTransform):
    """Pre-tokenized npy/npz grids stored per crop setting
    (reference: modality_transforms.py:606-629)."""

    def load(self, path):
        if str(path).endswith(".npz"):
            return np.load(path)["arr_0"].astype(np.int64)
        return np.load(path).astype(np.int64)

    def image_augment(self, v, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        if rand_aug_idx is None:
            raise ValueError(
                "Crop settings / augmentation index are missing but a "
                "pre-tokenized modality is being used")
        return np.asarray(v[rand_aug_idx])


class DetectionTransform(AbstractTransform):
    """Bounding boxes (albumentations normalized-xyxy convention) -> coord-bin
    token string (reference: modality_transforms.py:632-759)."""

    def __init__(self, det_threshold=0.6, det_max_instances=None,
                 bbox_order="dist_to_orig", coord_bins=1000,
                 min_visibility=0.0, return_raw=False):
        self.det_threshold = det_threshold
        self.det_max_instances = det_max_instances
        self.coord_bins = coord_bins
        self.min_visibility = min_visibility
        self.return_raw = return_raw
        self.bbox_order = {
            "area": lambda bs: sorted(
                bs, key=lambda x: (x[2] - x[0]) * (x[3] - x[1]), reverse=True),
            "score": lambda bs: sorted(bs, key=lambda x: x[5], reverse=True),
            "random": lambda bs: random.sample(bs, len(bs)),
            "dist_to_orig": lambda bs: sorted(
                bs, key=lambda x: x[0] ** 2 + x[1] ** 2),
        }[bbox_order]

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        return [inst["boxes"] + [inst["class_name"], inst["score"]]
                for inst in sample["instances"]
                if inst["score"] >= self.det_threshold]

    def image_augment(self, bboxes, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx=None, resample_mode: str = None):
        oh, ow = orig_size
        top, left, h, w = crop_coords
        out = []
        for b in bboxes:
            xmin, ymin, xmax, ymax = b[:4]
            # to crop-local normalized coords
            nx0 = (xmin * ow - left) / w
            nx1 = (xmax * ow - left) / w
            ny0 = (ymin * oh - top) / h
            ny1 = (ymax * oh - top) / h
            cx0, cy0 = max(nx0, 0.0), max(ny0, 0.0)
            cx1, cy1 = min(nx1, 1.0), min(ny1, 1.0)
            if cx1 <= cx0 or cy1 <= cy0:
                continue
            vis = ((cx1 - cx0) * (cy1 - cy0)) / max(
                (nx1 - nx0) * (ny1 - ny0), 1e-12)
            if vis <= self.min_visibility:
                continue
            out.append((cx0, cy0, cx1, cy1) + tuple(b[4:]))
        if flip:
            out = [(1 - bb[2], bb[1], 1 - bb[0], bb[3]) + tuple(bb[4:])
                   for bb in out]
        if (self.det_max_instances is not None
                and len(out) > self.det_max_instances):
            out = sorted(out, key=lambda x: x[5],
                         reverse=True)[: self.det_max_instances]
        return self.bbox_order(out)

    def postprocess(self, bboxes):
        if self.return_raw:
            return bboxes
        bins = self.coord_bins
        parts = []
        for (xmin, ymin, xmax, ymax, cls, _score) in bboxes:
            parts.append(" ".join([
                f"v0={round(xmin * (bins - 1))}",
                f"v1={round(ymin * (bins - 1))}",
                f"v2={round(xmax * (bins - 1))}",
                f"v3={round(ymax * (bins - 1))}", str(cls)]))
        return " ".join(parts)


class CaptionTransform(AbstractTransform):
    """(reference: modality_transforms.py:762-800)."""

    def __init__(self, aligned_captions=True, no_aug=False):
        self.aligned_captions = aligned_captions
        self.no_aug = no_aug

    def load(self, path):
        path = str(path)
        if path.endswith(".txt"):
            return Path(path).read_text()
        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        if path.endswith(".json.gz"):
            with gzip.open(path, "rb") as f:
                return json.load(f)
        raise ValueError(f"unsupported caption file {path}")

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        if isinstance(val, (list, tuple)):
            if self.aligned_captions:
                val = val[0] if rand_aug_idx is None else val[rand_aug_idx]
            else:
                val = val[0] if self.no_aug else random.choice(val)
        if isinstance(val, dict):
            val = val["caption"]
        assert isinstance(val, str)
        return val


class CaptionEmbTransform(AbstractTransform):
    """Pre-computed (e.g. T5) caption embeddings, stored per crop setting
    (reference: modality_transforms.py:803-860)."""

    def __init__(self, aligned_captions=True, no_aug=False):
        self.aligned_captions = aligned_captions
        self.no_aug = no_aug

    def load(self, path):
        if str(path).endswith(".npz"):
            data = np.load(path)
            return {"emb": data["emb"], "mask_valid": data["mask_valid"]}
        raise ValueError(f"Invalid file format for caption embedding: {path}")

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        emb, mask = val["emb"], val["mask_valid"].astype(bool)
        if emb.shape[0] > 1:
            if self.aligned_captions:
                i = 0 if rand_aug_idx is None else rand_aug_idx
            else:
                i = 0 if self.no_aug else random.randrange(emb.shape[0])
            emb, mask = emb[i], mask[i]
        else:
            emb, mask = emb[0], mask[0]
        return {"emb": emb, "mask_valid": mask}

    def postprocess(self, val):
        emb = np.asarray(val["emb"], np.float32)
        mask = np.asarray(val["mask_valid"], bool)
        return {"tensor": emb[mask], "mask_valid": mask[mask]}


class MetadataTransform(AbstractTransform):
    """Scene-metadata dict -> 'key=value' token string with optional shuffle
    and chunking (compact version of reference:
    modality_transforms.py:863-1030)."""

    def __init__(self, special_vmin=0, special_vmax=999, shuffle=True,
                 random_trunc=False, return_chunks=True):
        self.special_vmin = special_vmin
        self.special_vmax = special_vmax
        self.shuffle = shuffle
        self.random_trunc = random_trunc
        self.return_chunks = return_chunks

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        items = []
        for k, v in sample.items():
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, float):
                v = round(v * (self.special_vmax - self.special_vmin)
                          + self.special_vmin)
            v = int(np.clip(int(v), self.special_vmin, self.special_vmax))
            items.append(f"{k}={v}")
        return items

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode: str = None):
        return val

    def postprocess(self, items: List[str]):
        items = list(items)
        if self.shuffle:
            random.shuffle(items)
        if self.random_trunc and len(items) > 1:
            items = items[: random.randint(1, len(items))]
        return " ".join(items)


def _clip_polygon(points: np.ndarray, rect) -> Optional[np.ndarray]:
    """Sutherland–Hodgman clip of an (N, 2) xy polygon against an axis-aligned
    rectangle (x0, y0, x1, y1).  Returns the clipped (M, 2) polygon or None.

    The reference reaches the same intersection polygon by inserting
    border-crossing points, clamping, and dropping points that left the
    original contour (reference: modality_transforms.py:403-484); SH is the
    standard exact algorithm for a convex clip region."""
    x0, y0, x1, y1 = rect
    # (axis, bound, keep-side sign): inside test is sign*(p[axis]-bound) <= 0
    edges = ((0, x0, -1), (1, y0, -1), (0, x1, 1), (1, y1, 1))
    poly = [p.astype(np.float64) for p in points.reshape(-1, 2)]
    for axis, bound, sign in edges:
        if not poly:
            return None
        out = []
        prev = poly[-1]
        prev_in = sign * (prev[axis] - bound) <= 0
        for cur in poly:
            cur_in = sign * (cur[axis] - bound) <= 0
            if cur_in != prev_in:  # edge crosses the boundary
                t = (bound - prev[axis]) / (cur[axis] - prev[axis])
                out.append(prev + t * (cur - prev))
            if cur_in:
                out.append(cur)
            prev, prev_in = cur, cur_in
        poly = out
    if len(poly) < 3:
        return None
    return np.stack(poly)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine: the segment's ends moved onto the image's edges (in
    cv2's integer steps), or None when it misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels of cv2.line's 8-connected segment on a (h, w) image,
    ends included: clipped to the image first, drawn left to right, the
    major axis stepped every pixel and the minor one while the error term
    is negative (cv2's LineIterator)."""
    clipped = _clip_line(w, h, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    if x1 > x2:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    y_major = dx < dy
    if y_major:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        yield x, y
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if y_major:
            y += sy
            x += minor
        else:
            x += 1
            y += sy if minor else 0


def fill_polygon(shape: Tuple[int, int], points: np.ndarray) -> np.ndarray:
    """cv2.fillPoly(zeros(shape), [points], 1) without OpenCV: integer
    (N, 2) xy vertices; a pixel is set when its centre row's even-odd span
    covers it (span ends rounded inwards from the edges' crossings) or when
    an edge's 8-connected line passes through it, as cv2 draws the edges.
    The boundary may differ from cv2 by a pixel where a crossing lands near
    a pixel's edge (tests/test_torch_modality_transforms.py counts them)."""
    h, w = shape
    m = np.zeros(shape, np.float32)
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    if len(pts) == 0:
        return m
    nxt = np.roll(pts, -1, axis=0)
    for y in range(max(0, int(pts[:, 1].min())), min(h, int(pts[:, 1].max()) + 1)):
        xs = []
        for (xa, ya), (xb, yb) in zip(pts, nxt):
            if (ya <= y < yb) or (yb <= y < ya):  # half-open: each vertex counted once
                xs.append(xa + (y - ya) * (xb - xa) / (yb - ya))
        xs.sort()
        for xl, xr in zip(xs[0::2], xs[1::2]):
            lo, hi = max(0, math.ceil(xl)), min(w - 1, math.floor(xr))
            if lo <= hi:
                m[y, lo:hi + 1] = 1
    for (xa, ya), (xb, yb) in zip(pts, nxt):
        for x, y in _line_pixels(w, h, int(xa), int(ya), int(xb), int(yb)):
            m[y, x] = 1
    return m


def point_polygon_test(contour: np.ndarray, point) -> int:
    """cv2.pointPolygonTest(contour, point, measureDist=False) without
    OpenCV: +1 inside, 0 on an edge, -1 outside, by cv2's crossing rule on
    a float contour."""
    px, py = float(point[0]), float(point[1])
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return -1
    counter = 0
    v0 = pts[-1]
    for v in pts:
        if ((v0[1] <= py and v[1] <= py) or (v0[1] > py and v[1] > py)
                or (v0[0] < px and v[0] < px)):
            if py == v[1] and (px == v[0] or (py == v0[1] and (
                    (v0[0] <= px <= v[0]) or (v[0] <= px <= v0[0])))):
                return 0
            v0 = v
            continue
        dist = (py - v0[1]) * (v[0] - v0[0]) - (px - v0[0]) * (v[1] - v0[1])
        if dist == 0:
            return 0
        if v[1] < v0[1]:
            dist = -dist
        counter += dist > 0
        v0 = v
    return -1 if counter % 2 == 0 else 1


class SAMInstanceTransform(AbstractTransform):
    """SAM instance polygons -> fixed-count binary masks + bboxes + validity
    (reference: modality_transforms.py:388-571).  Input files are npy object
    arrays of dicts with a 'points' (N, 1, 2) xy contour."""

    def __init__(self, mask_size: int = 64, max_instance_n: int = 20,
                 bbox_area_threshold: float = 0.0005):
        self.mask_size = mask_size
        self.max_instance_n = max_instance_n
        self.bbox_area_threshold = bbox_area_threshold

    def load(self, path):
        return np.load(path, allow_pickle=True)

    def preprocess(self, sample):
        n = len(sample)
        if self.max_instance_n is not None and n > self.max_instance_n:
            keep = set(np.random.choice(n, self.max_instance_n, replace=False))
        else:
            keep = set(range(n))
        return [np.asarray(p["points"], dtype=np.float64).reshape(-1, 2)
                for i, p in enumerate(sample) if i in keep]

    def image_augment(self, sample, crop_coords: Tuple, flip: bool,
                      orig_size: Tuple, target_size: Tuple,
                      rand_aug_idx: Optional[int] = None,
                      resample_mode: str = None):
        top, left, h, w = crop_coords
        th, tw = _to_2tuple(target_size)
        out = []
        for inst in sample:
            clipped = _clip_polygon(inst, (left, top, left + w, top + h))
            if clipped is None:
                continue
            # shift into crop frame, then scale to the target resolution
            clipped = clipped - np.array([left, top], dtype=np.float64)
            clipped = np.round(clipped * np.array([tw / w, th / h]))
            x0, y0 = clipped.min(axis=0)
            x1, y1 = clipped.max(axis=0)
            if (y1 - y0) * (x1 - x0) < self.bbox_area_threshold * th * tw:
                continue  # reference drops tiny instances (:498-508)
            if flip:
                clipped[:, 0] = tw - clipped[:, 0]
            out.append(clipped)
        return out

    def postprocess(self, sample):
        n = self.max_instance_n if self.max_instance_n is not None \
            else len(sample)
        masks = np.zeros((n, self.mask_size, self.mask_size), np.float32)
        bboxes = np.zeros((n, 4), np.float32)
        valid = np.zeros(n, dtype=bool)
        for i, inst in enumerate(sample[:n]):
            x0, y0 = inst.min(axis=0)
            x1, y1 = inst.max(axis=0)
            # normalize the contour into the mask grid and rasterize
            span = np.array([max(x1 - x0, 1e-9), max(y1 - y0, 1e-9)])
            grid = (inst - np.array([x0, y0])) / span * self.mask_size
            masks[i] = fill_polygon((self.mask_size, self.mask_size), grid.astype(np.int32))
            bboxes[i] = (y0, x0, y1, x1)  # reference order: min_h, min_w,
            valid[i] = True               # max_h, max_w (:395-400)
        return {"instance": masks, "bbox": bboxes, "valid": valid}


def _bbox_crop(bbox, x_min, y_min, x_max, y_max, rows, cols):
    """Re-normalize an (x0, y0, x1, y1) [0,1] bbox from a full image of size
    (rows, cols) into a pixel crop window (the albumentations `bbox_crop`
    the reference calls, modality_transforms.py:1057)."""
    b = np.asarray(bbox, dtype=np.float64).copy()
    b[0::2] = (b[0::2] * cols - x_min) / max(x_max - x_min, 1e-9)
    b[1::2] = (b[1::2] * rows - y_min) / max(y_max - y_min, 1e-9)
    return b


class HumanPoseTransform(AbstractTransform):
    """SMPL human-pose instances -> binned token string
    (reference: modality_transforms.py:1016-1178)."""

    def __init__(self, coord_bins: int = 1000, only_pose: bool = False,
                 return_raw: bool = False):
        self.coord_bins = coord_bins
        self.only_pose = only_pose
        self.return_raw = return_raw

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        if self.only_pose:  # tokenizer-training path: raw 207-D body pose
            if len(sample) == 0:
                return np.zeros(207, np.float32)
            return np.asarray(sample["pred_smpl_params"]["body_pose"][0],
                              np.float32).flatten()
        if len(sample) == 0:
            return "none"
        smpl = sample["pred_smpl_params"]
        out = []
        for i in range(len(sample["bbox_xyxy"])):
            out.append(
                ["human"] + list(np.asarray(sample["bbox_xyxy"][i],
                                            np.float64).flatten())
                + ["global"] + list(np.asarray(smpl["global_orient"][i],
                                               np.float64).flatten())
                + ["pose"] + list(np.asarray(sample["pose_tokenized"][i],
                                             np.float64).flatten())
                + ["shape"] + list(np.asarray(smpl["betas"][i],
                                              np.float64).flatten())
                + ["camera"] + list(np.asarray(sample["pred_cam"][i],
                                               np.float64).flatten()))
        return out

    def image_augment(self, poses, crop_coords: Tuple, flip: bool,
                      orig_size: Tuple, target_size: Tuple,
                      rand_aug_idx=None, resample_mode: str = None):
        if poses == "none" or self.only_pose:
            return poses
        oh, ow = orig_size
        top, left, h, w = crop_coords
        kept = []
        for inst in poses:
            bbox = _bbox_crop(np.asarray(inst[1:5]) / [ow, oh, ow, oh],
                              left, top, left + w, top + h, oh, ow)
            if (bbox[1::2] < 0).all() or (bbox[0::2] < 0).all():
                continue
            if (bbox[1::2] > 1).all() or (bbox[0::2] > 1).all():
                continue
            inst[1:5] = np.clip(bbox, 0.0, 1.0)
            kept.append(inst)
        return kept if kept else "none"

    def postprocess(self, poses):
        if poses == "none" or self.only_pose:
            return poses if not self.return_raw else []
        if self.return_raw:
            return poses
        return self._to_string(poses)

    def _to_string(self, all_poses) -> str:
        """Value binning per the reference (:1092-1152): bbox -> coord bins,
        global orient/shape scaled+offset, pose tokens split at 512, camera
        clipped to [-1, 19]; the four groups after the bbox are shuffled."""
        bins = self.coord_bins
        result = ""
        for inst in all_poses:
            bbox = [f"v{i}={round(float(inst[1 + i]) * (bins - 1))}"
                    for i in range(4)]
            glob = [f"v0={round(float(v) * 499.5 + 499.5)}"
                    for v in inst[6:15]]
            pose = [f"v0={round(float(v))}" if float(v) < 512
                    else f"v1={round(float(v) - 512)}" for v in inst[16:24]]
            shape = [f"v0={round(float(v) * 166.5 + 499.5)}"
                     for v in inst[25:35]]
            cam = [f"v0={round(np.clip(float(v), -1.0, 19.0) * 49.95 + 49.95)}"
                   for v in inst[36:]]
            groups = [[inst[15]] + pose, [inst[5]] + glob,
                      [inst[35]] + cam, [inst[24]] + shape]
            random.shuffle(groups)
            parts = [inst[0]] + bbox + sum(groups, [])
            result += " ".join(parts) + " "
        return result


class ColorPaletteTransform(AbstractTransform):
    """Color palettes -> binned token string
    (reference: modality_transforms.py:1181-1235)."""

    def __init__(self, coord_bins: int = 1000, return_raw: bool = False):
        self.coord_bins = coord_bins
        self.return_raw = return_raw

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        if self.return_raw:
            return sample
        length = random.randint(1, 7)  # random palette size per sample
        return list(np.asarray(sample[0][str(length)], np.float64).flatten())

    def image_augment(self, palettes, crop_coords: Tuple, flip: bool,
                      orig_size: Tuple, target_size: Tuple,
                      rand_aug_idx=None, resample_mode: str = None):
        return palettes  # palettes are crop/flip-invariant

    def postprocess(self, palettes):
        if self.return_raw:
            return palettes
        colors = [f"v1={round(len(palettes) / 3)}"]
        colors += [f"v0={round(float(v))}" for v in palettes]
        return " ".join(colors)


class SAMInstanceTokTransform(AbstractTransform):
    """Pre-tokenized SAM instances -> query-point-conditioned token string
    (reference: modality_transforms.py:1238-1341)."""

    def __init__(self, image_size=224, points_per_side=7,
                 point_order: str = "random"):
        self.H, self.W = _to_2tuple(image_size)
        self.points_per_h, self.points_per_w = _to_2tuple(points_per_side)
        if point_order not in ("random", "grid"):
            raise ValueError(f"unsupported point order {point_order}")
        self.point_order = point_order
        self._grid_points = None

    def _query_points(self) -> np.ndarray:
        if self.point_order == "grid":
            if self._grid_points is None:
                ys = np.linspace(0, self.H, self.points_per_h + 2)[1:-1]
                xs = np.linspace(0, self.W, self.points_per_w + 2)[1:-1]
                gy, gx = np.meshgrid(ys, xs)
                self._grid_points = np.stack(
                    (gx, gy), axis=2).astype(np.int32).reshape(-1, 2)
            return self._grid_points
        ys = np.random.randint(0, self.H, self.points_per_h)
        xs = np.random.randint(0, self.W, self.points_per_w)
        return np.stack((xs, ys), axis=1)

    def load(self, path):
        return np.load(path, allow_pickle=True)

    def preprocess(self, sample):
        for s in sample:
            s["token_ids"] = np.asarray(s["token_ids"], np.int32)
        return sample

    def image_augment(self, v, crop_coords: Tuple, flip: bool,
                      orig_size: Tuple, target_size: Tuple,
                      rand_aug_idx: Optional[int], resample_mode: str = None):
        if rand_aug_idx is None:
            raise ValueError("Crop settings are provided but not used by "
                             "this pre-tokenized modality")
        return v[rand_aug_idx]

    def postprocess(self, sample):
        """`sample` is ONE augmentation dict (selected by image_augment):
        'points' holds per-instance polygon coords, 'token_ids'/'bbox' the
        matching per-instance rows (reference: modality_transforms.py:
        1262-1278 zips sample['points']/['token_ids']/['bbox'])."""
        points = [tuple(int(c) for c in p) for p in self._query_points()]
        random.shuffle(points)
        coords_list = [np.asarray(c[0], np.float32) for c in sample["points"]]
        parts: List[str] = []
        for point in points:
            parts += ["point", f"v0={point[1]}", f"v1={point[0]}"]
            hits = []
            for coords, tok, bbox in zip(coords_list, sample["token_ids"],
                                         sample["bbox"]):
                if point_polygon_test(coords, point) >= 0:
                    hits.append((tok, bbox))
            if not hits:
                parts.append("none")
                continue
            random.shuffle(hits)
            for tok, bbox in hits:
                ymin, xmin, ymax, xmax = np.asarray(bbox).astype(np.int32)
                parts += ["polygon", f"v0={xmin}", f"v1={ymin}",
                          f"v2={xmax}", f"v3={ymax}"]
                parts += [f"v0={t}" if t < 512 else f"v1={t - 512}"
                          for t in np.asarray(tok).tolist()]
        return " ".join(parts)


# ------------------------------------------------------- unified transform
class UnifiedDataTransform:
    """Applies the full 4-stage pipeline with shared augmentation settings
    (reference: modality_transforms.py:67-138 — whose augmentation path is
    commented out for pre-tokenized training; here it is functional, and
    `augment=False` reproduces the reference's shipped tensor-only behavior)."""

    def __init__(self, transforms_dict, image_augmenter,
                 resample_mode: str = None, add_sizes: bool = False,
                 augment: bool = True, **kwargs):
        self.transforms_dict = transforms_dict
        self.image_augmenter = image_augmenter
        self.resample_mode = resample_mode
        self.add_sizes = add_sizes
        self.augment = augment

    def unified_image_augment(self, mod_dict, crop_settings):
        crop_coords, flip, orig_size, target_size, rand_aug_idx = \
            self.image_augmenter(mod_dict, crop_settings)
        mod_dict = {
            k: get_transform(k, self.transforms_dict).image_augment(
                v, crop_coords=crop_coords, flip=flip, orig_size=orig_size,
                target_size=get_transform_resolution(k, target_size),
                rand_aug_idx=rand_aug_idx, resample_mode=self.resample_mode)
            for k, v in mod_dict.items()
        }
        if self.add_sizes:
            mod_dict["crop_coords"] = np.asarray(crop_coords)
            mod_dict["orig_size"] = np.asarray(orig_size)
        return mod_dict

    def __call__(self, mod_dict):
        if not self.augment:
            return {k: np.asarray(v) for k, v in mod_dict.items()}
        crop_settings = mod_dict.pop("crop_settings", None)
        mod_dict = {k: get_transform(k, self.transforms_dict).preprocess(v)
                    for k, v in mod_dict.items()}
        mod_dict = self.unified_image_augment(mod_dict, crop_settings)
        mod_dict = {k: get_transform(k, self.transforms_dict).postprocess(v)
                    for k, v in mod_dict.items()}
        return mod_dict

    def __repr__(self):
        return "(UnifiedDataAugmentation,\n)"


# ----------------------------------------------------------- default maps
def default_modality_transforms() -> Dict[str, AbstractTransform]:
    """MODALITY_TRANSFORMS (reference: modality_info.py:445-473)."""
    return {
        "rgb": RGBTransform(imagenet_default_mean_and_std=True),
        "caption": CaptionTransform(aligned_captions=True),
        "det": DetectionTransform(det_threshold=0.6, bbox_order="dist_to_orig",
                                  coord_bins=1000, min_visibility=0.0),
        **{m: TokTransform() for m in (
            "tok_rgb", "tok_cam", "tok_gaze", "tok_depth", "tok_normal",
            "tok_semseg", "tok_clip", "tok_canny_edge", "tok_sam_edge",
            "tok_dinov2", "tok_imagebind", "tok_dinov2_global",
            "tok_imagebind_global")},
        "t5_caption": CaptionEmbTransform(),
        "metadata": MetadataTransform(special_vmin=0, special_vmax=999,
                                      shuffle=True, random_trunc=False,
                                      return_chunks=True),
        "human_poses": HumanPoseTransform(coord_bins=1000),
        "color_palette": ColorPaletteTransform(coord_bins=1000),
        "sam_instance": SAMInstanceTokTransform(image_size=224,
                                                points_per_side=7,
                                                point_order="random"),
        "mask_valid": MaskTransform(mask_pool_size=1),
    }


def divae_modality_transforms() -> Dict[str, AbstractTransform]:
    """MODALITY_TRANSFORMS_DIVAE (reference: modality_info.py:475-483)."""
    return {
        "rgb": RGBTransform(imagenet_default_mean_and_std=False),
        "depth": DepthTransform(standardize_depth=True),
        "normal": NormalTransform(standardize_surface_normals=False),
        "mask_valid": MaskTransform(mask_pool_size=1),
        "semseg_coco": SemsegTransform(shift_idx_by_one=True),
        "canny_edge": RGBTransform(imagenet_default_mean_and_std=False),
    }


def vqcontrolnet_modality_transforms() -> Dict[str, AbstractTransform]:
    """MODALITY_TRANSFORMS_VQCONTROLNET (reference: modality_info.py:485-488)."""
    return {
        "rgb": RGBTransform(imagenet_default_mean_and_std=False),
        "mask_valid": MaskTransform(mask_pool_size=1),
        "caption": CaptionTransform(aligned_captions=True),
    }
