"""The port's per-pixel Gauss-Newton rows (`ops.reductions.icp_rows`,
`rgb_rows`, `so3_rows`) and the geometry they sample through
(`ops.geometry.transform_maps`, `bilinear_sample`, `nearest_sample`), held
against the JAX package on the same numpy inputs (the bumpy-plane scene and
intrinsics of `tests/test_reductions.py`, 80x60), and each builder's Gram
held against autodiff of its own gate-frozen residual, as
`tests/test_reductions.py` holds the JAX builders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densemonoslam_tpu.config import CameraIntrinsics as JIntr
from densemonoslam_tpu.ops import geometry as jgeo
from densemonoslam_tpu.ops import reductions as jred
from densemonoslam_tpu.utils import se3 as jse3
from densemonoslam_tpu_torch.config import CameraIntrinsics as TIntr
from densemonoslam_tpu_torch.ops import geometry as tgeo
from densemonoslam_tpu_torch.ops import gram as tgram
from densemonoslam_tpu_torch.ops import reductions as tred
from densemonoslam_tpu_torch.utils import se3 as tse3

torch.set_num_threads(2)

H, W = 60, 80
JI = JIntr(80.0, 80.0, 39.5, 29.5)
TI = TIntr(80.0, 80.0, 39.5, 29.5)
# f32 Gram of the same rows summed in another order (`tests/test_pallas.py`)
GRAM_TOL = dict(rtol=2e-5, atol=1e-2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))


@pytest.fixture(scope="module")
def scene():
    """`test_reductions.py`'s model maps of a bumpy plane, the current frame
    the same plane seen through A_true^-1 with a hole cut out, a textured
    model image with its Sobel-free analytic gradients, and a current image
    offset by a few grey levels."""
    gen = np.random.default_rng(7)
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    depth_m = (1.5 + 0.1 * np.sin(uu / 9.0) * np.cos(vv / 7.0)).astype(np.float32)
    vmap_m = np.asarray(jgeo.backproject(jnp.asarray(depth_m), JI))
    nmap_m = np.asarray(jgeo.normal_map(jnp.asarray(vmap_m)))
    A_true = _pose([0.02, -0.01, 0.015, 0.01, 0.02, -0.015])
    Ainv = np.linalg.inv(A_true.astype(np.float64))
    vmap_c = ((Ainv[:3, :3] @ vmap_m.reshape(-1, 3).T).T + Ainv[:3, 3]).reshape(H, W, 3)
    nmap_c = (Ainv[:3, :3] @ nmap_m.reshape(-1, 3).T).T.reshape(H, W, 3)
    vmap_c[20:28, 30:44] = 0.0  # invalid current pixels
    nmap_c[20:28, 30:44] = 0.0
    vmap_m = vmap_m.copy()
    vmap_m[40:50, 10:20, 2] += 5.0  # far model geometry: the ICP distance gate
    i_m = (120 + 60 * np.sin(uu / 6.0) * np.cos(vv / 5.0) + 0.5 * uu).astype(np.float32)
    gx = (60 / 6.0 * np.cos(uu / 6.0) * np.cos(vv / 5.0) + 0.5).astype(np.float32)
    gy = (-60 / 5.0 * np.sin(uu / 6.0) * np.sin(vv / 5.0)).astype(np.float32)
    i_c = (i_m + gen.normal(0, 2.0, (H, W))).astype(np.float32)
    return dict(
        vmap_c=vmap_c.astype(np.float32), nmap_c=nmap_c.astype(np.float32),
        vmap_m=vmap_m, nmap_m=nmap_m, depth_m=vmap_m[..., 2].copy(),
        i_m=i_m, i_c=i_c, gx=gx, gy=gy,
        A=_pose([0.004, 0.003, -0.002, -0.003, 0.002, 0.001]),
        R=_pose([0.0, 0.0, 0.0, 0.01, -0.008, 0.004])[:3, :3].copy(),
    )


def test_geometry_matches_reference(scene):
    """transform_maps, bilinear_sample and nearest_sample on the same maps
    and coordinates (inside, on the border, outside and on exact half
    pixels) within 1e-6, relative to the values' size: the same f32
    operations in the same order, XLA's fusion aside."""
    gen = np.random.default_rng(3)
    T = _pose([0.1, -0.2, 0.3, 0.05, -0.04, 0.03])
    jv, jn = jgeo.transform_maps(jnp.asarray(scene["vmap_c"]), jnp.asarray(scene["nmap_c"]),
                                 jnp.asarray(T))
    tv, tn = tgeo.transform_maps(_t(scene["vmap_c"]), _t(scene["nmap_c"]), _t(T))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)
    assert (tv.numpy()[20:28, 30:44] == 0).all() and (tn.numpy()[20:28, 30:44] == 0).all()
    u = np.concatenate([gen.uniform(-3, W + 3, 4000), np.arange(-1.5, W + 1, 0.5)])
    v = np.concatenate([gen.uniform(-3, H + 3, 4000), np.resize(np.arange(-1.5, H + 1, 0.5),
                                                                 2 * W + 5)])
    u, v = u.astype(np.float32), v.astype(np.float32)
    for img in (scene["i_m"], scene["gx"], scene["depth_m"]):
        jb = jgeo.bilinear_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
        tb = tgeo.bilinear_sample(_t(img), _t(u), _t(v))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    for img in (scene["i_m"], scene["vmap_m"]):
        jn_ = jgeo.nearest_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
        tn_ = tgeo.nearest_sample(_t(img), _t(u), _t(v))
        np.testing.assert_array_equal(tn_.numpy(), np.asarray(jn_))


def _rows(pkg, kind, s):
    """The rows of `kind` from the JAX package (`pkg == "jax"`) or the port."""
    red, conv, intr = (jred, jnp.asarray, JI) if pkg == "jax" else (tred, _t, TI)
    if kind == "icp":
        return red.icp_rows(conv(s["vmap_c"]), conv(s["nmap_c"]), conv(s["vmap_m"]),
                            conv(s["nmap_m"]), conv(s["A"]), intr)
    if kind in ("rgb", "rgb_occlusion"):
        depth = conv(s["depth_m"]) if kind == "rgb_occlusion" else None
        return red.rgb_rows(conv(s["vmap_c"]), conv(s["i_c"]), conv(s["i_m"]), conv(s["gx"]),
                            conv(s["gy"]), conv(s["A"]), intr, depth_m=depth)
    return red.so3_rows(conv(s["i_c"]), conv(s["i_m"]), conv(s["gx"]), conv(s["gy"]),
                        conv(s["R"]), intr, min_grad=1.0)


@pytest.mark.parametrize("kind", ["icp", "rgb", "rgb_occlusion", "so3"])
def test_rows_match_reference(scene, kind):
    """[H*W, 8] rows of both packages: the masks exactly, the values within
    1e-5 relative to each column's largest entry (Jacobian columns reach
    ~1e3 in grey levels per metre, so that is ~10 f32 ulps); their Grams
    through the port's `reductions.gram` (on the CPU `gram_reference`)
    against JAX `reductions.gram` at the Gram tolerance, in units of each
    column's size."""
    Mj = np.asarray(_rows("jax", kind, scene))
    Mt = _rows("torch", kind, scene).numpy()
    assert Mt.shape == Mj.shape == (H * W, 8) and Mt.dtype == np.float32
    keep = Mj[:, 7] > 0
    np.testing.assert_array_equal(Mt[:, 7] > 0, keep)
    assert 500 < keep.sum() < H * W  # the gates keep some rows and drop others
    assert (Mt[~keep] == 0).all()
    scale = np.maximum(np.abs(Mj).max(axis=0), 1e-30)
    np.testing.assert_allclose(Mt / scale, Mj / scale, rtol=0, atol=1e-5)
    # the Gram tolerance is for rows of unit size: scale each column by the
    # power of two nearest its largest entry (exact in f32) in both packages
    pow2 = np.exp2(-np.round(np.log2(scale))).astype(np.float32)
    assert tred.gram is tgram.gram
    np.testing.assert_allclose(tred.gram(_t(Mt * pow2)).numpy(),
                               np.asarray(jred.gram(jnp.asarray(Mj * pow2))), **GRAM_TOL)


def _exp(fn, x):
    """se3_exp / so3_exp of one vector, batched as [1, n]: under
    `torch.func.jacfwd` a 0-dim tensor meeting a Python float promotes the
    tangents to f64."""
    return fn(x[None])[0]


def _jacobian_check(residuals, G, n, r_col, atol_rel):
    """JtJ = G[:n,:n], Jtr = G[:n, r_col] against `torch.func.jacfwd` of the
    frozen residual at 0, within `atol_rel` of each reference's largest
    entry (the JAX package's own tolerances)."""
    x0 = torch.zeros(n, dtype=torch.float32)
    J = torch.func.jacfwd(residuals)(x0)
    r0 = residuals(x0)
    JtJ, Jtr = (J.T @ J).numpy(), (J.T @ r0).numpy()
    np.testing.assert_allclose(G[:n, :n].numpy(), JtJ, rtol=0,
                               atol=atol_rel * (np.abs(JtJ).max() + 1e-9))
    np.testing.assert_allclose(G[:n, r_col].numpy(), Jtr, rtol=0,
                               atol=atol_rel * (np.abs(Jtr).max() + 1e-9))
    return r0


def test_icp_gram_matches_autodiff(scene):
    """`test_reductions.py:37` on the port: association and gates frozen at
    xi = 0, the point-to-plane residual differentiated by `torch.func`."""
    vc, nc = _t(scene["vmap_c"]), _t(scene["nmap_c"])
    vm, nm = _t(scene["vmap_m"]), _t(scene["nmap_m"])
    A = torch.eye(4)
    M = tred.icp_rows(vc, nc, vm, nm, A, TI)
    G = tred.gram(M)
    u, v, _ = tgeo.project(tse3.transform_points(A, vc.reshape(-1, 3)), TI)
    v_m, n_m = tgeo.nearest_sample(vm, u, v), tgeo.nearest_sample(nm, u, v)
    mask = M[:, 7]

    def residuals(xi):
        p = tse3.transform_points(_exp(tse3.se3_exp, xi) @ A, vc.reshape(-1, 3))
        return torch.sum(n_m * (p - v_m), dim=-1) * mask

    r0 = _jacobian_check(residuals, G, 6, 6, 2e-4)
    np.testing.assert_allclose(float(G[6, 6]), float(torch.sum(r0 * r0)), rtol=1e-4)
    assert float(G[7, 7]) == float(mask.sum())


def _linear_image(a, b, c):
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return _t(a * uu + b * vv + c)


def test_rgb_gram_matches_autodiff():
    """`test_reductions.py:93` on the port: a globally linear model image,
    whose constant gradient is the bilinear sample's true derivative."""
    gen = np.random.default_rng(42)
    depth = _t((1.5 + 0.1 * gen.standard_normal((H, W))).astype(np.float32))
    vmap_c = tgeo.backproject(depth, TI)
    i_m, i_c = _linear_image(0.8, -0.5, 100.0), _linear_image(0.8, -0.5, 98.0)
    gx, gy = torch.full((H, W), 0.8), torch.full((H, W), -0.5)
    A = torch.eye(4)
    M = tred.rgb_rows(vmap_c, i_c, i_m, gx, gy, A, TI, min_grad=0.1)
    mask = M[:, 7]
    assert mask.sum() > 1000

    def residuals(xi):
        p = tse3.transform_points(_exp(tse3.se3_exp, xi) @ A, vmap_c.reshape(-1, 3))
        u, v, _ = tgeo.project(p, TI)
        return (tgeo.bilinear_sample(i_m, u, v) - i_c.reshape(-1)) * mask

    _jacobian_check(residuals, tred.gram(M), 6, 6, 3e-3)


def test_so3_gram_matches_autodiff():
    """`test_reductions.py:126` on the port: rotation-only rows against the
    rotated-ray warp residual."""
    R = torch.eye(3)
    i_m, i_c = _linear_image(0.6, 0.4, 90.0), _linear_image(0.6, 0.4, 92.0)
    gx, gy = torch.full((H, W), 0.6), torch.full((H, W), 0.4)
    M = tred.so3_rows(i_c, i_m, gx, gy, R, TI)
    mask = M[:, 7]
    assert mask.sum() > 1000
    d = tred.unit_rays(H, W, TI, "cpu")

    def residuals(w):
        rd = torch.einsum("ij,pj->pi", _exp(tse3.so3_exp, w) @ R, d)
        u, v, _ = tgeo.project(rd, TI)
        return (tgeo.bilinear_sample(i_m, u, v) - i_c.reshape(-1)) * mask

    _jacobian_check(residuals, tred.gram(M), 3, 3, 3e-3)
