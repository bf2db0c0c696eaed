"""Aligned multi-tar reader for token shards (host side, pure Python).

Copy of egom2p_tpu/data/tar_reader.py (reference:
egom2p/data/unified_datasets.py:240-398), kept here so that the port never
loads the JAX package: per-modality tar shards with aligned keys
(`[rgb,depth,cam,gaze]/.../shard-{000..195}.tar`), zip-iterated with a
key-alignment check, npz / npy members decoded to numpy, a streaming
shuffle with a buffer, a split of the shards across processes or workers,
and each sample repeated n times.

An s3:// shard streams through data/s3_utils.py (tarfile's streaming
mode over the object's body; a boto3 client made on first use in each
process, for the endpoint the caller names, or an injected one).
"""
from __future__ import annotations

import io
import itertools
import random
import re
import tarfile
import zipfile
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def braceexpand(pattern: str) -> List[str]:
    """Expand `{000..195}` ranges and `[a,b,c]` alternatives
    (reference data_path syntax, unified_datasets.py:240-320)."""
    m = re.search(r"\[([^\]]+)\]", pattern)
    if m:
        out = []
        for alt in m.group(1).split(","):
            out.extend(braceexpand(pattern[:m.start()] + alt + pattern[m.end():]))
        return out
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [e for i in range(int(lo), int(hi) + 1)
                for e in braceexpand(pattern[:m.start()] + f"{i:0{width}d}" + pattern[m.end():])]
    return [pattern]


def _decode_member(name: str, data: bytes):
    """npz / npy / text decode (reference: unified_datasets.py:162-190)."""
    if name.endswith(".npz"):
        with np.load(io.BytesIO(data)) as z:
            keys = z.files
            return z[keys[0]] if len(keys) == 1 else {k: z[k] for k in keys}
    if name.endswith(".npy"):
        return np.load(io.BytesIO(data))
    if name.endswith((".txt", ".json")):
        return data.decode()
    return data


def iter_tar_samples(path: str, s3_client=None,
                     s3_endpoint: Optional[str] = None) -> Iterator[Dict]:
    """Yield {__key__, <ext>: decoded} grouped by key prefix within one tar;
    an s3:// path streams through `s3_client` (or this process's client
    for `s3_endpoint`: data/s3_utils.py)."""
    from egom2p_torch.data.s3_utils import is_s3_path, open_stream
    if is_s3_path(path):
        ctx = tarfile.open(fileobj=open_stream(path, s3_client, s3_endpoint), mode="r|*")
    else:
        ctx = tarfile.open(path, "r")
    with ctx as tar:
        current_key, sample = None, {}
        for member in tar:
            if not member.isfile():
                continue
            base = member.name.split("/")[-1]
            if "." not in base:
                continue
            key, ext = base.split(".", 1)
            if key != current_key:
                if sample:
                    yield {"__key__": current_key, **sample}
                current_key, sample = key, {}
            f = tar.extractfile(member)
            if f is not None:
                sample[ext] = _decode_member(base, f.read())
        if sample:
            yield {"__key__": current_key, **sample}


def multi_tarfile_samples(paths_per_modality: Dict[str, Sequence[str]],
                          handler: str = "warn", s3_client=None,
                          s3_endpoint: Optional[str] = None) -> Iterator[Dict]:
    """Zip-iterate aligned per-modality shards; on a shard whose keys or
    sample counts diverge, or that cannot be read, print and skip the rest of
    it (handler="warn") or raise (reference: unified_datasets.py:240-320).
    s3:// shards go through `s3_client` or `s3_endpoint`'s client
    (iter_tar_samples); a missing boto3 raises either way."""
    mods = list(paths_per_modality)
    n_shards = len(paths_per_modality[mods[0]])
    if not all(len(paths_per_modality[m]) == n_shards for m in mods):
        raise ValueError("modalities must have the same number of shards")
    for shard_idx in range(n_shards):
        iters = {m: iter_tar_samples(paths_per_modality[m][shard_idx], s3_client, s3_endpoint)
                 for m in mods}
        try:
            for rows in itertools.zip_longest(*iters.values()):
                if any(r is None for r in rows):
                    raise ValueError(f"shard {shard_idx}: unequal sample counts across "
                                     "modalities")
                keys = {r["__key__"] for r in rows}
                if len(keys) != 1:
                    raise ValueError(f"shard {shard_idx}: key mismatch across modality "
                                     f"tars: {keys}")
                merged = {"__key__": rows[0]["__key__"]}
                for mod, r in zip(mods, rows):
                    payload = {k: v for k, v in r.items() if k != "__key__"}
                    merged[mod] = next(iter(payload.values())) if len(payload) == 1 else payload
                yield merged
        # BadZipFile (a truncated .npz member, from np.load) is neither an
        # OSError nor a ValueError
        except (tarfile.TarError, ValueError, OSError, zipfile.BadZipFile) as e:
            if handler == "warn":
                print(f"[tar_reader] skipping bad shard {shard_idx}: {e}")
                continue
            raise


def shard_split(items: Sequence, rank: int, world_size: int) -> List:
    """Every world_size-th shard from `rank` (reference wds nodesplitter,
    unified_datasets.py:392)."""
    return [x for i, x in enumerate(items) if i % world_size == rank]


def shuffled(it: Iterator, buffer_size: int, rng: random.Random) -> Iterator:
    """Streaming shuffle through a buffer of `buffer_size` samples (wds
    .shuffle); buffer_size <= 0 passes the stream through."""
    if buffer_size <= 0:
        yield from it
        return
    buf = []
    for x in it:
        if len(buf) < buffer_size:
            buf.append(x)
            continue
        i = rng.randrange(buffer_size)
        yield buf[i]
        buf[i] = x
    rng.shuffle(buf)
    yield from buf


def repeated(it_factory, n_repeats: int) -> Iterator:
    """One pass over the stream with each sample yielded n times
    (wds_n_repeats, reference: unified_datasets.py:356); the next pass is
    the caller's (data/loader.py:DatasetStream rebuilds the stream)."""
    for x in it_factory():
        for _ in range(n_repeats):
            yield x
