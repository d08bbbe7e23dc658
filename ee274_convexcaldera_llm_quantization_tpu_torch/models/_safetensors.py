"""The safetensors file format, read and written without the ``safetensors``
package (the card's host has none).

A file is an 8-byte little-endian header length, a JSON header of
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` of strings), padded with spaces, then the
tensors' raw little-endian bytes, each at its offsets from the end of the
header. The writer lays tensors out as the ``safetensors`` package does
(larger elements first, then by name) and pads the header to 8 bytes.

:func:`load_file` reads every dtype the reference reads: ``safetensors``'
numpy reader with ``ml_dtypes`` loaded, as JAX loads it, reads BF16 as
well (not the float8 types), so a BF16 tensor's bits are read here as
16-bit integers and viewed as ``torch.bfloat16`` (ROADMAP.md, R12).
"""

from __future__ import annotations

import json
from typing import Dict, Mapping

import numpy as np
import torch

_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
    "BOOL": "?",
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors in their stored
    dtype."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        dtype = info["dtype"]
        raw = "<i2" if dtype == "BF16" else _DTYPES.get(dtype)
        if raw is None:
            raise TypeError(f"{path}: tensor {name!r} has dtype {dtype}, "
                            "which the reference's reader cannot read "
                            "either (ROADMAP.md, R12)")
        begin, end = info["data_offsets"]
        t = torch.from_numpy(np.frombuffer(data[begin:end], dtype=raw)
                             .reshape(info["shape"]).copy())
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    del data
    return out


def save_file(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write numpy arrays (of the dtypes :func:`load_file` reads) as one
    safetensors file."""
    arrays = {name: np.asarray(a, dtype=a.dtype.newbyteorder("<"))
              for name, a in tensors.items()}
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.itemsize, k))
    header = {}
    offset = 0
    for name in order:
        a = arrays[name]
        kind = _NAMES.get(a.dtype)
        if kind is None:
            raise TypeError(f"tensor {name!r}: dtype {a.dtype} cannot be "
                            "written as safetensors")
        header[name] = {"dtype": kind, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for name in order:
            f.write(arrays[name].tobytes(order="C"))
