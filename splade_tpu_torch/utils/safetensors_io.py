"""A self-contained reader and writer of the safetensors file format.

The port reads and writes ``*.safetensors`` weight files without the
``safetensors`` package, so a machine that lacks it (and the HF dirs the
reference's export writes) takes the same code path as one that has it.

The format: an 8-byte little-endian unsigned header length N, then N bytes
of a UTF-8 JSON header, then the data. The header maps each tensor's name to
``{"dtype": ..., "shape": [...], "data_offsets": [begin, end]}``, offsets in
bytes from the start of the data; an optional ``"__metadata__"`` maps
strings to strings. Tensors are raw little-endian bytes, C order. The
offsets must tile the data exactly: no gap, no overlap, nothing after the
last tensor.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

#: safetensors dtype name -> (torch dtype, numpy dtype of the stored bytes)
DTYPES: Dict[str, Tuple[torch.dtype, np.dtype]] = {
    "F64": (torch.float64, np.dtype("<f8")),
    "F32": (torch.float32, np.dtype("<f4")),
    "F16": (torch.float16, np.dtype("<f2")),
    "BF16": (torch.bfloat16, np.dtype("<u2")),  # numpy has no bfloat16
    "I64": (torch.int64, np.dtype("<i8")),
    "I32": (torch.int32, np.dtype("<i4")),
    "I16": (torch.int16, np.dtype("<i2")),
    "I8": (torch.int8, np.dtype("i1")),
    "U8": (torch.uint8, np.dtype("u1")),
    "BOOL": (torch.bool, np.dtype("?")),
}
_BY_TORCH = {t: name for name, (t, _) in DTYPES.items()}
_BY_NUMPY = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
             np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
             np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
             np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
             np.dtype(np.bool_): "BOOL"}
#: the order the writer puts tensors in, last first (the reference
#: implementation's dtype order; item sizes never grow along it, so every
#: tensor starts aligned to its item size)
_WRITE_RANK = ("BOOL", "U8", "I8", "I16", "F16", "BF16", "I32", "F32", "F64",
               "I64")
#: the largest header the reader accepts (the package's own limit)
MAX_HEADER_BYTES = 100_000_000

Array = Union[torch.Tensor, np.ndarray]


def _entry_bytes(name: str, entry) -> Tuple[str, Tuple[int, ...], int, int]:
    if not isinstance(entry, dict):
        raise ValueError(f"safetensors header: {name!r} is not an object")
    dtype, shape, offsets = (entry.get("dtype"), entry.get("shape"),
                             entry.get("data_offsets"))
    if dtype not in DTYPES:
        raise ValueError(f"safetensors header: {name!r} has dtype {dtype!r}")
    if not (isinstance(shape, list) and all(
            isinstance(d, int) and not isinstance(d, bool) and d >= 0
            for d in shape)):
        raise ValueError(f"safetensors header: {name!r} has shape {shape!r}")
    if not (isinstance(offsets, list) and len(offsets) == 2 and all(
            isinstance(o, int) and not isinstance(o, bool) for o in offsets)
            and 0 <= offsets[0] <= offsets[1]):
        raise ValueError(f"safetensors header: {name!r} has data_offsets "
                         f"{offsets!r}")
    size = int(np.prod(shape, dtype=np.int64)) * DTYPES[dtype][1].itemsize
    if offsets[1] - offsets[0] != size:
        raise ValueError(f"safetensors header: {name!r} spans "
                         f"{offsets[1] - offsets[0]} bytes, its dtype and "
                         f"shape {size}")
    return dtype, tuple(shape), offsets[0], offsets[1]


def read_header(buf: bytes) -> Tuple[dict, Dict[str, str], int]:
    """Parse and check a file's header -> ({name: (dtype, shape, begin,
    end)}, metadata, the data's start). Raises ValueError on a malformed
    header, offsets that overlap or leave a gap, or a short file."""
    if len(buf) < 8:
        raise ValueError("safetensors: the file is shorter than its 8-byte "
                         "header length")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > MAX_HEADER_BYTES or 8 + n > len(buf):
        raise ValueError(f"safetensors: a header of {n} bytes does not fit "
                         f"a file of {len(buf)}")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"safetensors: the header is not JSON ({e})") from e
    if not isinstance(header, dict):
        raise ValueError("safetensors: the header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    if not (isinstance(metadata, dict) and all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in metadata.items())):
        raise ValueError("safetensors: __metadata__ must map strings to "
                         "strings")
    entries = {name: _entry_bytes(name, e) for name, e in header.items()}
    end = 0
    for name, (_, _, b, e) in sorted(entries.items(),
                                     key=lambda kv: kv[1][2:]):
        if b != end:
            raise ValueError(f"safetensors: {name!r} starts at byte {b}, "
                             f"the tensor before it ends at {end} (offsets "
                             "overlap or leave a gap)")
        end = e
    data_start = 8 + n
    if data_start + end != len(buf):
        raise ValueError(f"safetensors: the tensors take {end} bytes, the "
                         f"file holds {len(buf) - data_start} after its "
                         "header")
    return entries, metadata, data_start


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU torch tensors."""
    return load_file_with_metadata(path)[0]


def load_file_with_metadata(path) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, str]]:
    buf = Path(path).read_bytes()
    entries, metadata, start = read_header(buf)
    out: Dict[str, torch.Tensor] = {}
    for name, (dtype, shape, b, e) in entries.items():
        ndtype = DTYPES[dtype][1]
        arr = (np.frombuffer(buf, dtype=ndtype, count=(e - b) // ndtype.itemsize,
                             offset=start + b) if e > b
               else np.empty(0, ndtype)).reshape(shape)
        t = torch.from_numpy(arr.astype(ndtype.newbyteorder("="), copy=True))
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    return out, metadata


def _as_bytes(value: Array) -> Tuple[str, Tuple[int, ...], bytes]:
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        if t.dtype not in _BY_TORCH:
            raise ValueError(f"safetensors: no dtype for {t.dtype}")
        name = _BY_TORCH[t.dtype]
        arr = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
    else:
        arr = np.asarray(value)
        if arr.dtype.newbyteorder("=") not in _BY_NUMPY:
            raise ValueError(f"safetensors: no dtype for {arr.dtype}")
        name = _BY_NUMPY[arr.dtype.newbyteorder("=")]
    stored = arr.astype(DTYPES[name][1], copy=False)  # keeps a 0-d shape
    return name, tuple(int(d) for d in stored.shape), stored.tobytes("C")


def save_file(tensors: Mapping[str, Array], path,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) as one safetensors
    file. Tensors go in ``_WRITE_RANK``'s order from its end, then by name;
    the header is padded with spaces to a multiple of 8 bytes (so the file
    is byte for byte the reference implementation's). Written to a
    temporary name and renamed."""
    parts = {k: _as_bytes(v) for k, v in tensors.items()}
    order = sorted(parts, key=lambda k: (-_WRITE_RANK.index(parts[k][0]), k))
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in metadata.items()):
            raise ValueError("safetensors: metadata must map strings to "
                             "strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for k in order:
        dtype, shape, data = parts[k]
        header[k] = {"dtype": dtype, "shape": list(shape),
                     "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    out = Path(path)
    tmp = out.with_suffix(out.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for k in order:
            f.write(parts[k][2])
    os.replace(tmp, out)
