"""Hugging Face datasets from a local directory, as a training source.

Copy of egom2p_tpu/data/hf_datasets.py (reference:
egom2p/data/unified_datasets.py:448-489 and pretrain_utils.py:266-289),
kept here so that the port never loads the JAX package, with the torch
process group's rank and world in place of JAX's processes: a dataset
written by `save_to_disk` (a Dataset, or a DatasetDict and its split) read
with `load_from_disk`, streamed, split across the ranks with
`split_dataset_by_node`, shuffled through a buffer with a seed, and `text`
renamed to `caption`; the masking is applied downstream by the loader's
DatasetStream, as for every other source.  Only local directories: a hub
name would download, and this path never does.  The `datasets` package is
imported on first use, and its absence raises, naming it.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional


def _datasets():
    try:
        import datasets
    except ImportError as e:
        raise RuntimeError("the huggingface dataset type needs the `datasets` package, which is "
                           "not installed here") from e
    return datasets


def huggingface_samples(data_path: str, split: str = "train", streaming: bool = True,
                        shuffle_buffer: int = 1_000, seed: Optional[int] = 0,
                        rename_text_to_caption: bool = True) -> Iterator[dict]:
    """Sample dicts of the dataset saved at `data_path`, this rank's share
    of them (egom2p_tpu/data/hf_datasets.py:huggingface_samples)."""
    from egom2p_torch.core import distributed

    hfds = _datasets()
    if not (os.path.isdir(data_path) and (
            os.path.exists(os.path.join(data_path, "dataset_info.json"))
            or os.path.exists(os.path.join(data_path, "dataset_dict.json")))):
        raise FileNotFoundError(f"{data_path}: not a dataset directory written by save_to_disk "
                                "(the port reads local Hugging Face datasets only)")
    ds = hfds.load_from_disk(data_path)
    if hasattr(ds, "keys"):  # a DatasetDict: the split must exist
        if split not in ds.keys():
            raise ValueError(f"split {split!r} not found in {data_path}; "
                             f"available: {sorted(ds.keys())}")
        ds = ds[split]
    if streaming:
        ds = ds.to_iterable_dataset()
    if distributed.world_size() > 1:
        from datasets.distributed import split_dataset_by_node
        ds = split_dataset_by_node(ds, rank=distributed.rank(),
                                   world_size=distributed.world_size())
    if shuffle_buffer and hasattr(ds, "shuffle"):
        try:
            ds = ds.shuffle(buffer_size=shuffle_buffer, seed=seed)
        except TypeError:  # a map-style Dataset's shuffle has no buffer
            ds = ds.shuffle(seed=seed)
    for ex in ds:
        if rename_text_to_caption and "text" in ex and "caption" not in ex:
            ex = dict(ex)
            ex["caption"] = ex.pop("text")
        yield ex
