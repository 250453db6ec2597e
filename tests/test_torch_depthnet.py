"""The port's depth CNN (`densemonoslam_tpu_torch.models.depthnet`) against
the JAX package's flax network with the packaged weights, and the port's
ONNX initializer reader."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.models import depthnet as jdepthnet
from densemonoslam_tpu.models.depthnet import DepthPredictor as JDepth
from densemonoslam_tpu_torch.models import onnx_import
from densemonoslam_tpu_torch.models.depthnet import DepthNet, DepthPredictor, params_from_flax

torch.set_num_threads(2)

# the JAX package's packaged weight files (the port holds byte-equal copies)
JAX_WEIGHTS = Path(jdepthnet.__file__).resolve().parent / "weights"


@pytest.fixture(scope="module")
def nets():
    return {
        name: (getattr(JDepth, f"pretrained_{name}")(),
               getattr(DepthPredictor, f"pretrained_{name}")(device="cpu"))
        for name in ("street", "synthetic")
    }


@pytest.mark.parametrize("shape", [(120, 160), (75, 97)], ids=["even", "odd"])
@pytest.mark.parametrize("name", ["street", "synthetic"])
def test_depthnet_matches_flax(nets, name, shape):
    """`params_from_flax` carries the packaged weights across, and the
    forward pass (asymmetric SAME padding of the stride-2 convolutions,
    GroupNorm eps 1e-6, bilinear upsampling to odd skip sizes) matches flax
    to 1e-4 relative depth on a random image."""
    jp, tp = nets[name]
    rgb = np.random.default_rng(1).integers(0, 256, shape + (3,)).astype(np.uint8)
    a = np.asarray(jp.predict(jnp.asarray(rgb)))
    b = tp.predict(rgb).numpy()
    assert b.shape == shape and b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=1e-4)


def test_predict_synthetic_frame(nets):
    """`predict` on a synthetic-orbit frame: the same depth as the JAX
    predictor (1e-4 relative) and under the packaged net's 12% error bar
    against the true depth (`tests/test_depthnet.py`)."""
    jp, tp = nets["synthetic"]
    rgb, depth = SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3).frame(0)
    a = np.asarray(jp.predict(jnp.asarray(rgb)))
    b = tp.predict(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4)
    m = depth > 0
    assert np.mean(np.abs(b[m] - depth[m]) / depth[m]) < 0.12


def test_reduced_precision_and_weight_io(nets, tmp_path):
    """`compute_dtype=torch.bfloat16` returns f32 depth within 3% (mean
    relative) of the f32 forward; `save` then `load` restores the weights
    bit for bit, and `load` also takes the JAX package's npz."""
    _, tp = nets["street"]
    rgb = np.random.default_rng(2).integers(0, 256, (80, 256, 3)).astype(np.uint8)
    ref = tp.predict(rgb).numpy()
    lp = DepthPredictor.pretrained_street(device="cpu", compute_dtype=torch.bfloat16)
    out = lp.predict(rgb).numpy()
    assert out.dtype == np.float32
    assert np.mean(np.abs(out - ref) / ref) < 0.03
    tp.save(str(tmp_path / "w.npz"))
    other = DepthPredictor(widths=(16, 32, 64), min_depth=2.0, max_depth=80.0, device="cpu")
    other.load(str(tmp_path / "w.npz"))
    np.testing.assert_array_equal(other.predict(rgb).numpy(), ref)
    other.load(str(JAX_WEIGHTS / "depthnet_street.npz"))
    np.testing.assert_array_equal(other.predict(rgb).numpy(), ref)


def _encode_varint(x):
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num, wt, payload):
    key = _encode_varint((num << 3) | wt)
    if wt == 2:
        return key + _encode_varint(len(payload)) + payload
    return key + payload


def _tensor_proto(name, arr):
    body = b""
    for d in arr.shape:
        body += _field(1, 0, _encode_varint(d))
    body += _field(2, 0, _encode_varint(1))  # f32
    body += _field(8, 2, name.encode())
    body += _field(9, 2, arr.astype("<f4").tobytes())
    return body


def test_onnx_initializer_roundtrip(tmp_path):
    """The reader recovers initializer tensors by name, and OIHW conv
    weights arrive in the port's layout unchanged."""
    w = np.random.default_rng(0).normal(size=(8, 3, 3, 3)).astype(np.float32)
    b = np.arange(8, dtype=np.float32)
    graph = _field(5, 2, _tensor_proto("conv1.weight", w)) + _field(5, 2, _tensor_proto("conv1.bias", b))
    p = tmp_path / "tiny.onnx"
    p.write_bytes(_field(7, 2, graph))
    out = onnx_import.load_initializers(str(p))
    np.testing.assert_array_equal(out["conv1.weight"], w)
    np.testing.assert_array_equal(out["conv1.bias"], b)
    params = onnx_import.load_depthnet_params(
        str(p), {"conv1.weight": "blocks.0.conv.weight", "conv1.bias": "blocks.0.conv.bias"}
    )
    np.testing.assert_array_equal(params["blocks.0.conv.weight"], w)
    # the flax relayout: HWIO -> OIHW
    hwio = np.transpose(w, (2, 3, 1, 0))
    np.testing.assert_array_equal(onnx_import.flax_conv_to_torch(hwio), w)


def test_onnx_full_depthnet_import(tmp_path, nets):
    """A normnet-shaped ONNX file holding every tensor of the packaged
    synthetic net (conv weights OIHW) imports into a `DepthNet` whose
    predictions equal the original's bit for bit."""
    _, tp = nets["synthetic"]
    graph, name_map = b"", {}
    for name, v in tp.params.items():
        graph += _field(5, 2, _tensor_proto("normnet." + name, v.numpy()))
        name_map["normnet." + name] = name
    p = tmp_path / "normnet_like.onnx"
    p.write_bytes(_field(7, 2, graph))
    params = onnx_import.load_depthnet_params(str(p), name_map)
    net = DepthPredictor(
        params={k: torch.from_numpy(v) for k, v in params.items()}, widths=(16, 32, 64),
        min_depth=0.5, max_depth=10.0, device="cpu",
    )
    rgb = np.random.default_rng(1).integers(0, 256, (120, 160, 3)).astype(np.uint8)
    np.testing.assert_array_equal(net.predict(rgb).numpy(), tp.predict(rgb).numpy())
    # every tensor of the flax tree lands on one of the port's parameters
    with np.load(JAX_WEIGHTS / "depthnet_synthetic.npz") as z:
        carried = params_from_flax({k: z[k] for k in z.files})
    assert set(carried) == set(DepthNet((16, 32, 64)).state_dict())
