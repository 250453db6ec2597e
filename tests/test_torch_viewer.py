"""The PyTorch port's live web viewer (CPU): mirrors of the six tests of
`tests/test_viewer.py` on the torch engine, driving the real HTTP server;
the decimated cloud blob against the JAX package's on the same map, bit for
bit; the batch-align status repair (ROADMAP R5) and the cloud index wrap of
the JAX version (R8)."""

import json
import os
import struct
import threading
import time
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu import viewer as jviewer
from densemonoslam_tpu.mapping import surfel_map as jsm
from densemonoslam_tpu_torch import viewer as tviewer
from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.viewer import ViewerServer

torch.set_num_threads(2)


def _get(url, binary=False):
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read()
        return r.status, body if binary else body.decode()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    W, H = 80, 60
    camera = CameraConfig(
        FrameResolution(W, H), CameraIntrinsics(66.0, 66.0, W / 2 - 0.5, H / 2 - 0.5), "cam0"
    )
    seq = SyntheticSequence(camera=camera, num_frames=10)
    cfg = EngineConfig(max_surfels=1 << 14, depth_cutoff=10.0, depth_factor=1.0,
                       open_loop=True, nid_keyframing=False)
    eng = Engine(camera, cfg, device="cpu")
    eng.frontend("cam0")
    out = str(tmp_path_factory.mktemp("viewer_out"))
    srv = ViewerServer(eng, out_dir=out, cloud_max_points=5000)
    port = srv.start()
    for i in range(6):
        rgb, depth = seq.frame(i)
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
    srv.sync(["cam0"])  # services the initial cloud request
    srv.publish("cam0")
    yield eng, srv, f"http://127.0.0.1:{port}", out
    srv.stop()


def test_page_and_status(served):
    eng, srv, base, _ = served
    status, html = _get(base + "/")
    assert status == 200 and "densemonoslam_tpu" in html
    status, body = _get(base + "/api/status")
    st = json.loads(body)
    assert st["cams"]["cam0"]["tick"] == 6
    assert st["cams"]["cam0"]["surfels"] > 0
    fe = eng.frontends["cam0"]
    assert st["cams"]["cam0"]["keyframes"] == fe.num_keyframes == int(fe.stats_log[-1][10]) > 0
    assert len(st["cams"]["cam0"]["icp_err"]) == 6
    assert "confidence_threshold" in st["params"]
    assert st["maps"] == {"cam0": eng.surfel_count("cam0")}


def test_view_images_and_traj(served):
    """The three PNGs decode (PIL) to `Engine.view_images`' arrays."""
    import io

    from PIL import Image

    eng, _, base, _ = served
    arrays = eng.view_images("cam0")
    for kind in ("rgb", "depth", "normals"):
        status, blob = _get(base + f"/api/view/cam0/{kind}.png", binary=True)
        assert status == 200 and blob[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), arrays[kind])
    assert arrays["rgb"].shape == (60, 80, 3) and arrays["depth"].max() == 255
    status, body = _get(base + "/api/traj/cam0")
    traj = json.loads(body)
    assert len(traj) == 6 and len(traj[0]) == 3


def test_cloud_blob(served):
    """The blob parses, and equals the JAX package's `_cloud_bytes` on the
    same map bit for bit (the decimation is a gather)."""
    eng, _, base, _ = served
    status, blob = _get(base + "/api/cloud/cam0", binary=True)
    assert status == 200
    (n,) = struct.unpack_from("<I", blob, 0)
    assert n > 0
    assert len(blob) == 4 + n * 12 + n * 3
    pos = np.frombuffer(blob, np.float32, n * 3, 4).reshape(n, 3)
    assert np.isfinite(pos).all()
    m = eng.map_of("cam0")
    shim = types.SimpleNamespace(
        config=eng.config,
        map_of=lambda name: jsm.SurfelMap(data=jnp.asarray(m.data.numpy()),
                                          count=jnp.asarray(int(m.count), jnp.int32)),
    )
    for max_points in (5000, 777):
        assert tviewer._cloud_bytes(eng, "cam0", max_points) == jviewer._cloud_bytes(
            shim, "cam0", max_points)


def test_live_param_sync(served):
    eng, srv, base, _ = served
    old_step = eng.frontends["cam0"].step_fn
    status, _ = _post(base + "/api/param", {"confidence_threshold": 5.0})
    assert status == 200
    srv.sync(["cam0"])
    assert eng.config.confidence_threshold == 5.0
    assert eng.frontends["cam0"].step_fn is not old_step
    # sliding back to the original value reuses the cached step (no rebuild)
    _post(base + "/api/param", {"confidence_threshold": 10.0})
    srv.sync(["cam0"])
    assert eng.frontends["cam0"].step_fn is old_step
    status, body = _post(base + "/api/param", {"max_surfels": 1})
    assert status == 400  # shape-changing fields are not tunable


def test_pause_step_resume(served):
    eng, srv, base, _ = served
    _post(base + "/api/control", {"action": "pause"})
    assert srv.paused
    done = threading.Event()

    def runner():
        srv.sync(["cam0"])  # blocks until step/resume
        done.set()

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    time.sleep(0.15)
    assert not done.is_set()  # paused: sync is blocking
    _post(base + "/api/control", {"action": "step"})
    done.wait(5.0)
    assert done.is_set()  # single-step released exactly one frame
    _post(base + "/api/control", {"action": "resume"})
    assert not srv.paused
    srv.sync(["cam0"])  # non-blocking now
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_save_requests(served):
    """Saves of the map, the trajectory and the view images (as PNGs equal
    to `Engine.view_images`); an unknown action is refused."""
    from PIL import Image

    eng, srv, base, out = served
    for action in ("save_ply", "save_traj", "save_images"):
        _post(base + "/api/control", {"action": action})
    srv.sync(["cam0"])
    assert os.path.exists(os.path.join(out, "cam0.ply"))
    assert os.path.exists(os.path.join(out, "cam0.freiburg"))
    for kind, arr in eng.view_images("cam0").items():
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(out, f"cam0_{kind}.png"))), arr)
    status, _ = _post(base + "/api/control", {"action": "no_such"})
    assert status == 400


def test_batch_align_status_names_the_failure(served):
    """ROADMAP R5 repaired: with no camera in another map the status reads
    `no_candidate` (the JAX viewer reads `rejected`); a second camera in its
    own map whose alignment fails the gates reads `rejected`."""
    eng, srv, base, _ = served
    _post(base + "/api/control", {"action": "batch_align"})
    srv.sync(["cam0"])
    assert json.loads(_get(base + "/api/status")[1])["batch_align"] == "no_candidate"
    eng.frontend("camX")  # its own map, nothing seen yet: no correspondences
    try:
        _post(base + "/api/control", {"action": "batch_align"})
        srv.sync(["cam0", "camX"])
        assert json.loads(_get(base + "/api/status")[1])["batch_align"] == "rejected"
    finally:
        del eng.frontends["camX"], eng.maps["camX"]


def test_cloud_indices_do_not_wrap():
    """ROADMAP R8: the JAX decimation forms `i * count` in int32, which wraps
    once `max_points * count` passes 2**31 (200,000 points of a map holding
    more than 10,737 rows); the port's int64 indices stay exact."""
    cap, count, max_points = 1 << 15, 20000, 200_000
    data = np.zeros((cap + 1, 16), np.float32)
    data[:count, 0] = np.arange(count)  # x = row index
    data[:count, 3] = 20.0
    tpos = tviewer._decimate_cloud(torch.from_numpy(data), torch.tensor(count), 10.0,
                                   max_points)[0][:, 0].numpy()
    want = (np.arange(max_points, dtype=np.int64) * count) // max_points
    np.testing.assert_array_equal(tpos, want.astype(np.float32))
    jpos = np.asarray(jviewer._decimate_cloud(jnp.asarray(data), jnp.asarray(count, jnp.int32),
                                              np.float32(10.0), max_points)[0])[:, 0]
    first_wrap = -(-(2**31) // count)  # the first i with i * count >= 2**31
    np.testing.assert_array_equal(jpos[:first_wrap], tpos[:first_wrap])
    assert (jpos[first_wrap:] != tpos[first_wrap:]).mean() > 0.9
