"""Conditioning datasets for generation-time evaluation.

Port of egom2p_tpu/data/generation_datasets.py on the port's transforms
(reference: egom2p/utils/generation_datasets/{empty_dataset,
image_caption_dataset,parti_prompts_dataset}.py).  Numpy-native: samples
are dicts of numpy arrays ready for the GenerationSampler's host mod_dicts.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, Dict, Optional

import numpy as np

from egom2p_torch.data.modality_transforms import (CaptionTransform, RGBTransform,
                                                   UnifiedDataTransform, get_transform_key)


class EmptyDataset:
    """Index-only dataset for unconditional generation
    (reference: empty_dataset.py:17-27)."""

    def __init__(self, dataset_size: int):
        self.dataset_size = dataset_size

    def __getitem__(self, index):
        return {}

    def __len__(self):
        return self.dataset_size


class ImageCaptionDataset:
    """Aligned rgb/ + caption/ class-folder dataset
    (reference: image_caption_dataset.py:23-98)."""

    def __init__(self, root: str, augmenter: Optional[Callable] = None,
                 modality_paths: Dict[str, str] = None):
        from egom2p_torch.data.folder_dataset import MultiModalFolderDataset
        self.root = root
        modality_paths = modality_paths or {}
        dirs = {mod: os.path.join(root, modality_paths.get(mod, mod))
                for mod in ("rgb", "caption")}
        self.modality_transforms = {
            "rgb": RGBTransform(imagenet_default_mean_and_std=False),
            "caption": CaptionTransform(),
        }
        self.transform = (UnifiedDataTransform(
            transforms_dict=self.modality_transforms,
            image_augmenter=augmenter) if augmenter is not None else None)
        self.folder = MultiModalFolderDataset(dirs)
        if not len(self.folder):
            raise RuntimeError(f"Found 0 aligned samples under {dirs}")

    def __getitem__(self, index):
        paths = self.folder.paths(index)
        sample = {
            mod: self.modality_transforms[get_transform_key(mod)].load(
                paths[mod])
            for mod in ("rgb", "caption")
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def __len__(self):
        return len(self.folder)


class PartiPromptsDataset:
    """Parti Prompts caption dataset (reference:
    parti_prompts_dataset.py:20-114): tokenized + padded caption tensors,
    with optional precomputed T5 embeddings."""

    def __init__(self, text_tokenizer, max_length: int = 128,
                 parti_prompts_tsv: str = None,
                 parti_prompts_t5_embs: str = None):
        self.text_tokenizer = text_tokenizer
        self.max_length = max_length
        if parti_prompts_tsv is None or not os.path.exists(parti_prompts_tsv):
            raise FileNotFoundError(
                "PartiPrompts.tsv not found — download it from the "
                "google-research/parti repo and pass parti_prompts_tsv= "
                f"(got {parti_prompts_tsv!r}; this environment has no "
                "network egress).")
        with open(parti_prompts_tsv, newline="") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        self.prompts = [r["Prompt"] for r in rows]
        self.pad_id = text_tokenizer.token_to_id("[PAD]")
        self.eos_id = text_tokenizer.token_to_id("[EOS]")
        if parti_prompts_t5_embs is not None:
            data = np.load(parti_prompts_t5_embs)
            self.t5_embs, self.t5_masks = data["emb"], data["mask_valid"]
        else:
            self.t5_embs = self.t5_masks = None

    def __getitem__(self, index):
        # truncate BEFORE appending EOS so the longest prompts still end
        # with an end-of-sequence marker
        seq_ids = (self.text_tokenizer.encode(self.prompts[index])
                   .ids[: self.max_length - 1] + [self.eos_id])
        tensor = np.full(self.max_length, self.pad_id, np.int32)
        tensor[: len(seq_ids)] = seq_ids
        out = {"caption": {"tensor": tensor}}
        if self.t5_embs is not None:
            emb = np.asarray(self.t5_embs[index], np.float32)
            mask = np.asarray(self.t5_masks[index], bool)
            out["t5_caption"] = {"tensor": emb[mask]}
        return out

    def __len__(self):
        return len(self.prompts)
