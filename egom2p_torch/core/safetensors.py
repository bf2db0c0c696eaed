"""A reader and a writer of the safetensors format with no package: an
8-byte little-endian header length, a JSON header {name: {"dtype", "shape",
"data_offsets"}, "__metadata__": ...}, then the tensors' raw little-endian
bytes."""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

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



_WRITE_DTYPES = {torch.float32: ("F32", np.float32), torch.float64: ("F64", np.float64),
                 torch.float16: ("F16", np.float16), torch.int64: ("I64", np.int64),
                 torch.int32: ("I32", np.int32), torch.int16: ("I16", np.int16),
                 torch.int8: ("I8", np.int8), torch.uint8: ("U8", np.uint8),
                 torch.bool: ("BOOL", np.bool_)}


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> str:
    """{name: tensor} (any device) as a .safetensors file: the header padded
    with spaces to 8 bytes, the tensors' bytes in name order."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach()
        if t.dtype == torch.bfloat16:
            code, buf = "BF16", t.cpu().contiguous().view(torch.int16).numpy().astype("<i2")
        elif t.dtype in _WRITE_DTYPES:
            code, npt = _WRITE_DTYPES[t.dtype]
            buf = t.cpu().contiguous().numpy().astype(np.dtype(npt).newbyteorder("<"))
        else:
            raise ValueError(f"tensor {name}: dtype {t.dtype} is not written here")
        data = buf.tobytes()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
    return path
