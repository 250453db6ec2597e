"""The port's street sequence (`densemonoslam_tpu_torch.io.street`, a numpy
copy) renders the same frames, bit for bit, as the JAX package's."""

import numpy as np
import pytest

from densemonoslam_tpu.io.street import StreetSequence as JStreet
from densemonoslam_tpu_torch.io.street import StreetSequence as TStreet


@pytest.mark.parametrize(
    "kw",
    [dict(exposure_jitter=0.03), dict(depth_noise=0.005, exposure_jitter=0.03, aliased=True),
     dict(num_frames=420, radius=40.0, seed=13)],
    ids=["mono-lap", "noisy-aliased", "second-geometry"],
)
def test_street_frames_bit_equal(kw):
    """At the quarter-KITTI default camera (256x80): RGB, depth and the
    ground-truth poses at the start, mid-lap and the lap's end."""
    kw = {"num_frames": 520, **kw}
    js, ts = JStreet(**kw), TStreet(**kw)
    assert len(ts) == len(js)
    for i in (0, len(js) // 2, len(js) - 1):
        (rj, dj), (rt, dt) = js.frame(i), ts.frame(i)
        assert rt.dtype == np.uint8 and dt.dtype == np.float32
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(ts.gt_pose(i), js.gt_pose(i))
