"""Minimal ONNX checkpoint reader: initializer tensors -> numpy arrays (copy
of `densemonoslam_tpu.models.onnx_import`, numpy only).

Deployments hold trained depth-network weights as ONNX.  This module loads
them WITHOUT the `onnx` package by decoding just enough of the protobuf wire
format:

    ModelProto.graph        = field 7  (GraphProto)
    GraphProto.initializer  = field 5  (repeated TensorProto)
    TensorProto.dims        = field 1  (repeated int64)
    TensorProto.data_type   = field 2  (enum: 1=f32, 7=i64, 10=f16, 11=f64)
    TensorProto.float_data  = field 4  (repeated float)
    TensorProto.name        = field 8  (string)
    TensorProto.raw_data    = field 9  (bytes, little-endian)

`load_initializers(path)` returns ``{name: np.ndarray}``.  ONNX convolution
weights are OIHW, torch's own layout, so `load_depthnet_params` copies them
as they are; `flax_conv_to_torch` converts the JAX package's HWIO kernels
(`models.depthnet.params_from_flax`) and `torch_conv_to_flax` converts back
(`models.depthnet.params_to_flax`).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
}


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message body.
    Values: varint -> int, length-delimited -> bytes, fixed32/64 -> bytes."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 0x7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
            yield field, wt, v
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            yield field, wt, buf[i : i + ln]
            i += ln
        elif wt == 5:  # fixed32
            yield field, wt, buf[i : i + 4]
            i += 4
        elif wt == 1:  # fixed64
            yield field, wt, buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype = np.float32
    name = ""
    raw = None
    floats = []
    for field, wt, v in _fields(buf):
        if field == 1:  # dims
            if wt == 0:
                dims.append(int(v))
            else:  # packed
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    dims.append(int(d))
        elif field == 2 and wt == 0:
            dtype = _DTYPES.get(int(v), np.float32)
        elif field == 4:  # float_data
            if wt == 5:
                floats.append(np.frombuffer(v, np.float32))
            elif wt == 2:  # packed
                floats.append(np.frombuffer(v, np.float32))
        elif field == 8 and wt == 2:
            name = v.decode()
        elif field == 9 and wt == 2:
            raw = v
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif floats:
        arr = np.concatenate(floats).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def load_initializers(path: str) -> Dict[str, np.ndarray]:
    """All initializer tensors of an ONNX model file, by name."""
    with open(path, "rb") as f:
        model = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wt, v in _fields(model):
        if field == 7 and wt == 2:  # ModelProto.graph
            for gf, gwt, gv in _fields(v):
                if gf == 5 and gwt == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gv)
                    out[name] = arr
    return out


def flax_conv_to_torch(w: np.ndarray) -> np.ndarray:
    """flax/JAX conv kernel HWIO -> torch/ONNX OIHW."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    """torch/ONNX conv kernel OIHW -> flax/JAX HWIO (the JAX package's
    `onnx_conv_to_flax`)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def load_depthnet_params(path: str, name_map: Dict[str, str]) -> Dict[str, np.ndarray]:
    """A state dict for `models.depthnet.DepthNet` from ONNX initializers.
    `name_map` maps ONNX initializer names to the port's parameter names
    like ``"blocks.0.conv.weight"``; ONNX OIHW conv weights need no
    relayout."""
    raw = load_initializers(path)
    return {name: raw[onnx_name].astype(np.float32) for onnx_name, name in name_map.items()}
