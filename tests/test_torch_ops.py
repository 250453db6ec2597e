"""Parity of the PyTorch port's elementwise/stencil modules (se3, warp,
geometry, preprocess) with the JAX package on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-5: both sides compute in f32 with the same
operation order, so only fused multiply-adds and transcendental rounding
differ (a few ulps); atol 1e-4 where values are pixel coordinates or
[0,255] intensities (a few ulps of numbers up to ~255)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.ops import geometry as jgeo
from densemonoslam_tpu.ops import preprocess as jpre
from densemonoslam_tpu.ops import warp as jwarp
from densemonoslam_tpu.utils import se3 as jse3
from densemonoslam_tpu_torch.config import CameraIntrinsics as TIntr
from densemonoslam_tpu_torch.ops import geometry as tgeo
from densemonoslam_tpu_torch.ops import preprocess as tpre
from densemonoslam_tpu_torch.ops import warp as twarp
from densemonoslam_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def close(t_out, j_out, **tol):
    np.testing.assert_allclose(
        np.asarray(t_out.detach().cpu()), np.asarray(j_out), **(tol or TOL)
    )


@pytest.fixture(scope="module")
def frame():
    seq = SyntheticSequence(num_frames=12)
    rgb, depth = seq.frame(3)
    i = seq.camera.intrinsics
    return rgb, depth, JIntr(i.fx, i.fy, i.cx, i.cy), TIntr(i.fx, i.fy, i.cx, i.cy)


@pytest.mark.parametrize("scale", [0.3, 1e-5, 0.0])
def test_se3_exp_log_inverse_match(rng, scale):
    for _ in range(4):
        xi = (rng.normal(0, 1, 6) * scale).astype(np.float32)
        Tj = jse3.se3_exp(jnp.asarray(xi))
        Tt = tse3.se3_exp(torch.from_numpy(xi))
        close(Tt, Tj)
        close(tse3.so3_exp(torch.from_numpy(xi[:3])), jse3.so3_exp(jnp.asarray(xi[:3])))
        T = np.array(Tj)
        close(tse3.se3_log(torch.from_numpy(T)), jse3.se3_log(jnp.asarray(T)))
        close(tse3.so3_log(torch.from_numpy(T[:3, :3])), jse3.so3_log(jnp.asarray(T[:3, :3])))
        close(tse3.se3_inverse(torch.from_numpy(T)), jse3.se3_inverse(jnp.asarray(T)))
        p = rng.normal(0, 2, (50, 3)).astype(np.float32)
        close(tse3.transform_points(torch.from_numpy(T), torch.from_numpy(p)),
              jse3.transform_points(jnp.asarray(T), jnp.asarray(p)))
        close(tse3.rotate_vectors(torch.from_numpy(T), torch.from_numpy(p)),
              jse3.rotate_vectors(jnp.asarray(T), jnp.asarray(p)))
        close(tse3.apply_update(torch.from_numpy(T), torch.from_numpy(xi)),
              jse3.apply_update(jnp.asarray(T), jnp.asarray(xi)))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_warp_decimate_and_shift_match(rng, k):
    img = rng.normal(0, 1, (13, 17, 3)).astype(np.float32)
    close(twarp.decimate(torch.from_numpy(img), k), jwarp.decimate(jnp.asarray(img), k))
    close(twarp.decimate(torch.from_numpy(img[..., 0]), k), jwarp.decimate(jnp.asarray(img[..., 0]), k))
    for dy, dx in [(0, 0), (k, -1), (-k, 2), (20, 0)]:
        close(twarp.shift(torch.from_numpy(img), dy, dx), jwarp.shift(jnp.asarray(img), dy, dx))
    x, y = twarp.pixel_grid(13, 17)
    jx, jy = jwarp.pixel_grid(13, 17)
    close(x, jx)
    close(y, jy)


@pytest.mark.parametrize("sampler", ["sample_nearest_local", "sample_bilinear_local"])
def test_warp_local_sampling_out_of_range_semantics(rng, sampler):
    """Displacements up to 1.5x the radius: taps leaving the shift stack or
    the image must sample zero exactly as the reference's shifted stack."""
    img = rng.normal(0, 1, (20, 24, 2)).astype(np.float32)
    du = rng.uniform(-4.5, 4.5, (20, 24)).astype(np.float32)
    dv = rng.uniform(-4.5, 4.5, (20, 24)).astype(np.float32)
    du[0, :5] = [-3.0, 3.0, 2.5, -2.5, 0.0]  # integer and half-pixel edges
    out_t, val_t = getattr(twarp, sampler)(torch.from_numpy(img), torch.from_numpy(du),
                                           torch.from_numpy(dv), radius=3)
    out_j, val_j = getattr(jwarp, sampler)(jnp.asarray(img), jnp.asarray(du),
                                           jnp.asarray(dv), radius=3)
    assert (val_t.numpy() == np.asarray(val_j)).all()
    close(out_t, out_j)


def test_geometry_backproject_normals_project_match(frame):
    rgb, depth, ji, ti = frame
    vj = jgeo.backproject(jnp.asarray(depth), ji)
    vt = tgeo.backproject(torch.from_numpy(depth), ti)
    close(vt, vj)
    nj = jgeo.normal_map(vj)
    nt = tgeo.normal_map(vt)
    close(nt, nj)
    assert (nt[0].abs().sum() == 0) and (nt[:, -1].abs().sum() == 0)  # border mask
    for a, b in zip(tgeo.project(vt, ti), jgeo.project(vj, ji)):
        close(a, b, rtol=1e-5, atol=1e-4)  # pixel coordinates up to ~160


def test_geometry_in_bounds_match(rng):
    u = rng.uniform(-5, 170, 500).astype(np.float32)
    v = rng.uniform(-5, 125, 500).astype(np.float32)
    u[:4] = [0.0, 1.0, 158.0, 159.0]  # on the margins
    for margin in (0, 1):
        t = tgeo.in_bounds(torch.from_numpy(u), torch.from_numpy(v), 160, 120, margin)
        j = jgeo.in_bounds(jnp.asarray(u), jnp.asarray(v), 160, 120, margin)
        assert (t.numpy() == np.asarray(j)).all()


def test_preprocess_match(frame):
    rgb, depth, _, _ = frame
    raw = (depth * 1000.0).astype(np.float32)
    dj = jpre.metricise_depth(jnp.asarray(raw), 1000.0, 3.0)
    dt = tpre.metricise_depth(torch.from_numpy(raw), 1000.0, 3.0)
    close(dt, dj)
    close(tpre.rgb_to_intensity(torch.from_numpy(rgb)), jpre.rgb_to_intensity(jnp.asarray(rgb)),
          rtol=1e-5, atol=1e-4)  # [0,255] units
    close(tpre.bilateral_filter_depth(dt), jpre.bilateral_filter_depth(dj))
    for a, b in zip(tpre.build_pyramid(dt, 3, depth=True), jpre.build_pyramid(dj, 3, depth=True)):
        close(a, b)
    inten = rgb[..., 0].astype(np.float32)
    pt = tpre.build_pyramid(torch.from_numpy(inten), 3)
    pj = jpre.build_pyramid(jnp.asarray(inten), 3)
    for a, b in zip(pt, pj):
        close(a, b, rtol=1e-5, atol=1e-4)
        for ga, gb in zip(tpre.sobel_gradients(a), jpre.sobel_gradients(jnp.asarray(b))):
            close(ga, gb, rtol=1e-5, atol=1e-4)
