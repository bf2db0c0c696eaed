"""A reader of the safetensors format with no package: an 8-byte
little-endian header length, a JSON header {name: {"dtype", "shape",
"data_offsets"}, "__metadata__": ...}, then the tensors' raw little-endian
bytes."""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
           "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: numpy array} of a .safetensors file; BF16 tensors come back
    as float32 (exactly: a bf16 value is the top half of an fp32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        buf, shape = data[lo:hi], tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif info["dtype"] in _DTYPES:
            out[name] = np.frombuffer(buf, dtype=_DTYPES[info["dtype"]]).reshape(shape).copy()
        else:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, not read here")
    return out

