"""Aligned per-modality directory datasets (small/local datasets).

Port of egom2p_tpu/data/folder_dataset.py on the port's
data/modality_transforms.py: .npy / .npz / json / txt files load with no
package; image files decode through Pillow inside the readers only.

Two layouts, both equivalents of the reference MultiModalDatasetFolder
(reference: egom2p/data/multimodal_dataset_folder.py:204-369) and the
local-folder pretraining path (unified_datasets.py:48-90):

  * MultiModalFolderDataset — flat: each modality is a directory of
    <key>.npz/<key>.npy files; samples are the key intersection.
  * MultiModalDatasetFolder — class trees:
    root/<modality>/<class_x>/<name>.<ext> with jpg/png/npy/json files,
    classes indexed from the rgb modality, per-modality loading through
    the modality-transform `.load()` zoo.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

# (reference: multimodal_dataset_folder.py:24-28 IMG_EXTENSIONS +
# UNIFIED_EXTENSIONS)
IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp", ".jpx", ".npy", ".npz")
UNIFIED_EXTENSIONS = IMG_EXTENSIONS + (".json", ".txt", ".json.gz")


class MultiModalFolderDataset:
    def __init__(self, modality_dirs: Dict[str, str]):
        """modality_dirs: {modality_name: directory}."""
        self.modality_dirs = dict(modality_dirs)
        per_mod = {}
        for mod, d in self.modality_dirs.items():
            files = {}
            for f in glob.glob(os.path.join(d, "*")):
                base = os.path.basename(f)
                if "." in base:
                    files[base.split(".", 1)[0]] = f
            per_mod[mod] = files
        self.keys = sorted(set.intersection(*(set(v) for v in per_mod.values()))) \
            if per_mod else []
        self.files = per_mod

    def __len__(self) -> int:
        return len(self.keys)

    def paths(self, idx: int) -> Dict[str, str]:
        """Per-modality file paths of sample idx (no loading)."""
        key = self.keys[idx]
        out = {mod: self.files[mod][key] for mod in self.modality_dirs}
        out["__key__"] = key
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        key = self.keys[idx]
        out = {}
        for mod in self.modality_dirs:
            f = self.files[mod][key]
            arr = np.load(f)
            if hasattr(arr, "files"):
                arr = arr[arr.files[0]]
            out[mod] = np.asarray(arr)
        out["__key__"] = key
        return out

    def iter_epoch(self, rng: np.random.Generator) -> Iterator[Dict]:
        for i in rng.permutation(len(self)):
            s = self[int(i)]
            s.pop("__key__")
            yield s


# --------------------------------------------------------------- class trees
def has_file_allowed_extension(filename: str,
                               extensions: Tuple[str, ...]) -> bool:
    return filename.lower().endswith(tuple(e.lower() for e in extensions))


def make_dataset(directory: str, class_to_idx: Dict[str, int],
                 extensions: Optional[Tuple[str, ...]] = None,
                 is_valid_file: Optional[Callable[[str], bool]] = None
                 ) -> List[Tuple[str, int]]:
    """Walk one modality's class tree into a sorted (path, class_idx) list
    (reference: multimodal_dataset_folder.py:56-118)."""
    if (extensions is None) == (is_valid_file is None):
        raise ValueError(
            "exactly one of extensions / is_valid_file must be given")
    if extensions is not None:
        def is_valid_file(x):  # noqa: F811
            return has_file_allowed_extension(x, extensions)
    instances = []
    for target_class in sorted(class_to_idx):
        class_idx = class_to_idx[target_class]
        target_dir = os.path.join(directory, target_class)
        if not os.path.isdir(target_dir):
            continue
        for root, _, fnames in sorted(os.walk(target_dir, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if is_valid_file(path):
                    instances.append((path, class_idx))
    return instances


class MultiModalDatasetFolder:
    """Class-folder multi-modal dataset:

        root/rgb/class_x/xxx.jpg      root/depth/class_x/xxx.png
        root/rgb/class_y/xxy.jpg      root/depth/class_y/xxy.png

    Classes come from the `rgb` modality's subdirectories; every modality
    must mirror the tree.  Loading goes through `modality_transforms`
    ({transform_key: AbstractTransform}, see
    egom2p_torch/data/modality_transforms.py) via their `.load()`; pass an
    IdentityTransform-style object for raw npy modalities.  Supports
    max_samples (seeded random subset), pre_shuffle, an in-memory cache,
    and return_path (class_id + file_name fields)
    (reference: multimodal_dataset_folder.py:204-369; the torch
    VisionDataset base and DataLoader integration are replaced by plain
    __getitem__/__len__, which the mixture loader wraps)."""

    def __init__(self, root: str, modalities: List[str],
                 modality_paths: Optional[Dict[str, str]] = None,
                 modality_transforms: Optional[Dict[str, object]] = None,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 is_valid_file: Optional[Callable[[str], bool]] = None,
                 max_samples: Optional[int] = None,
                 pre_shuffle: bool = False, cache: bool = False,
                 return_path: bool = False):
        from egom2p_torch.data.modality_transforms import get_transform_key
        self.root = root
        self.modalities = list(modalities)
        self.modality_paths = dict(modality_paths or {})
        for mod in self.modalities:
            self.modality_paths.setdefault(mod, mod)
        self.modality_transforms = dict(modality_transforms or {})
        self._key = get_transform_key
        self.transform = transform
        self.target_transform = target_transform
        self.return_path = return_path

        class_root = os.path.join(root, self.modality_paths.get("rgb", "rgb"))
        if not os.path.isdir(class_root):  # rgb-less datasets: first modality
            class_root = os.path.join(
                root, self.modality_paths[self.modalities[0]])
        self.classes, self.class_to_idx = self._find_classes(class_root)

        extensions = UNIFIED_EXTENSIONS if is_valid_file is None else None
        samples = {
            mod: make_dataset(os.path.join(root, self.modality_paths[mod]),
                              self.class_to_idx, extensions, is_valid_file)
            for mod in self.modalities}
        for mod, mod_samples in samples.items():
            if not mod_samples:
                raise RuntimeError(
                    f"Found 0 files in subfolders of "
                    f"{os.path.join(root, self.modality_paths[mod])} "
                    f"(supported extensions: {extensions})")
        lens = {mod: len(s) for mod, s in samples.items()}
        if len(set(lens.values())) > 1:
            raise RuntimeError(
                f"modalities are misaligned (per-modality sample counts "
                f"{lens}); every modality must mirror the rgb tree")
        self.samples = samples

        if isinstance(max_samples, int):
            total = len(next(iter(samples.values())))
            perm = np.random.RandomState(0).permutation(total)[:max_samples]
            for mod in samples:
                self.samples[mod] = [self.samples[mod][i] for i in perm]
        if pre_shuffle:
            total = len(next(iter(samples.values())))
            perm = np.random.RandomState(100).permutation(total)
            for mod in samples:
                self.samples[mod] = [self.samples[mod][i] for i in perm]

        self._use_cache = cache
        self.cache: Dict[int, tuple] = {}

    @staticmethod
    def _find_classes(directory: str) -> Tuple[List[str], Dict[str, int]]:
        classes = sorted(d.name for d in os.scandir(directory) if d.is_dir())
        return classes, {c: i for i, c in enumerate(classes)}

    @staticmethod
    def get_class_and_file(path: str) -> Tuple[str, str]:
        class_id, file_name = path.split(os.sep)[-2:]
        return class_id, file_name.split(".")[0]

    class _DefaultLoader:
        """Extension-dispatched fallback for modalities without an explicit
        transform: images via PIL, npy/npz via numpy, json/txt as text."""

        def load(self, path: str):
            lower = path.lower()
            if lower.endswith((".npy", ".npz")):
                arr = np.load(path)
                if hasattr(arr, "files"):
                    arr = arr[arr.files[0]]
                return np.asarray(arr)
            if lower.endswith((".json", ".json.gz")):
                import gzip
                import json
                op = gzip.open if lower.endswith(".gz") else open
                with op(path, "rt") as f:
                    return json.load(f)
            if lower.endswith(".txt"):
                with open(path) as f:
                    return f.read()
            from egom2p_torch.data.modality_transforms import ImageTransform
            return ImageTransform.image_loader(path)

    def _loader(self, mod: str):
        return self.modality_transforms.get(self._key(mod),
                                            self._DefaultLoader())

    def __len__(self) -> int:
        return len(next(iter(self.samples.values())))

    def __getitem__(self, index: int) -> Dict:
        if index in self.cache:
            sample_dict, target, path = self.cache[index]
            sample_dict = dict(sample_dict)
        else:
            sample_dict, target, path = {}, 0, ""
            for mod in self.modalities:
                path, target = self.samples[mod][index]
                sample_dict[mod] = self._loader(mod).load(path)
            if self._use_cache:
                self.cache[index] = (dict(sample_dict), target, path)
        if self.transform is not None:
            sample_dict = self.transform(sample_dict)
        if self.target_transform is not None:
            target = self.target_transform(target)
        sample_dict["class_idx"] = target
        if self.return_path:
            class_id, file_name = self.get_class_and_file(path)
            sample_dict["class_id"] = class_id
            sample_dict["file_name"] = file_name
        return sample_dict
