"""The port's safetensors reader and writer (splade_tpu_torch.utils
.safetensors_io) against the ``safetensors`` package, in both directions:
every dtype it covers (F32, F16, BF16, I64, I32, I16, I8, U8, BOOL, and
F64), metadata, empty tensors; the port's files are byte-identical to the
package's for the same tensors. Malformed files raise: a short file, a
header longer than the file, a header that is not JSON or not an object,
an unknown dtype, a size that disagrees with dtype and shape, overlapping
offsets, a gap, bytes after the last tensor, metadata that is not strings."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy
from safetensors import torch as st_torch

from splade_tpu_torch.utils import safetensors_io as io

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64,
          torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
          torch.float64]


def tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn(3, i + 2, generator=g) * 50
        out[f"t{i}.{str(dt)[6:]}"] = (x > 0) if dt == torch.bool else x.to(dt)
    out["empty"] = torch.zeros(0, 4)
    out["scalar"] = torch.tensor(2.5)
    out["big.weight"] = torch.randn(64, 48, generator=g)
    return out


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_the_ports_file_reads_in_the_package(tmp_path):
    want = tensors()
    io.save_file(want, tmp_path / "port.safetensors",
                 metadata={"format": "pt", "note": "x"})
    same(st_torch.load_file(str(tmp_path / "port.safetensors")), want)
    from safetensors import safe_open
    with safe_open(str(tmp_path / "port.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt", "note": "x"}


def test_the_packages_file_reads_in_the_port(tmp_path):
    want = tensors(1)
    st_torch.save_file(want, str(tmp_path / "pkg.safetensors"),
                       metadata={"format": "pt"})
    got, meta = io.load_file_with_metadata(tmp_path / "pkg.safetensors")
    same(got, want)
    assert meta == {"format": "pt"}
    same(io.load_file(tmp_path / "pkg.safetensors"), want)


def test_byte_identical_to_the_package(tmp_path):
    want = tensors(2)
    io.save_file(want, tmp_path / "a", metadata={"format": "pt"})
    st_torch.save_file(want, str(tmp_path / "b"), metadata={"format": "pt"})
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_numpy_arrays_in_and_out(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "i": rng.integers(-9, 9, (4,)).astype(np.int64),
              "t": rng.standard_normal((3, 2)).astype(np.float32).T,  # a view
              "b": np.array([True, False])}
    io.save_file(arrays, tmp_path / "n.safetensors")
    got = st_numpy.load_file(str(tmp_path / "n.safetensors"))
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    st_numpy.save_file(arrays | {"t": np.ascontiguousarray(arrays["t"])},
                       str(tmp_path / "p.safetensors"))
    back = io.load_file(tmp_path / "p.safetensors")
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_no_metadata_and_an_empty_file(tmp_path):
    io.save_file({}, tmp_path / "e.safetensors")
    assert st_torch.load_file(str(tmp_path / "e.safetensors")) == {}
    assert io.load_file_with_metadata(tmp_path / "e.safetensors") == ({}, {})


def _file(tmp_path, header, data=b"", raw_header=None):
    text = raw_header if raw_header is not None else json.dumps(
        header).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(text)) + text + data)
    return path


F32_2 = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}


@pytest.mark.parametrize("case", [
    "short_length", "header_past_end", "not_json", "not_object",
    "unknown_dtype", "size_mismatch", "overlap", "gap", "trailing_bytes",
    "short_data", "bad_metadata", "bad_shape", "reversed_offsets"])
def test_malformed_files_raise(tmp_path, case):
    data8 = bytes(8)
    if case == "short_length":
        path = tmp_path / "bad.safetensors"
        path.write_bytes(b"\x05\x00\x00")
    elif case == "header_past_end":
        path = tmp_path / "bad.safetensors"
        path.write_bytes(struct.pack("<Q", 1000) + b"{}")
    elif case == "not_json":
        path = _file(tmp_path, None, raw_header=b"{not json")
    elif case == "not_object":
        path = _file(tmp_path, [1, 2])
    elif case == "unknown_dtype":
        path = _file(tmp_path, {"a": dict(F32_2, dtype="F8")}, data8)
    elif case == "size_mismatch":
        path = _file(tmp_path, {"a": dict(F32_2, shape=[3])}, data8)
    elif case == "overlap":
        path = _file(tmp_path, {"a": F32_2, "b": dict(
            F32_2, data_offsets=[4, 12])}, bytes(12))
    elif case == "gap":
        path = _file(tmp_path, {"a": F32_2, "b": dict(
            F32_2, data_offsets=[12, 20])}, bytes(20))
    elif case == "trailing_bytes":
        path = _file(tmp_path, {"a": F32_2}, bytes(12))
    elif case == "short_data":
        path = _file(tmp_path, {"a": F32_2}, bytes(6))
    elif case == "bad_metadata":
        path = _file(tmp_path, {"__metadata__": {"a": 1}, "x": F32_2}, data8)
    elif case == "bad_shape":
        path = _file(tmp_path, {"a": dict(F32_2, shape=[-2])}, data8)
    else:
        path = _file(tmp_path, {"a": dict(F32_2, data_offsets=[8, 0])}, data8)
    with pytest.raises(ValueError, match="safetensors"):
        io.load_file(path)
    # the package refuses each of them as well
    with pytest.raises(Exception):
        st_torch.load_file(str(path))


def test_the_writer_refuses_what_it_cannot_store(tmp_path):
    with pytest.raises(ValueError, match="metadata"):
        io.save_file({"a": torch.zeros(1)}, tmp_path / "x", metadata={"a": 1})
    with pytest.raises(ValueError, match="dtype"):
        io.save_file({"a": torch.zeros(1, dtype=torch.complex64)},
                     tmp_path / "x")
