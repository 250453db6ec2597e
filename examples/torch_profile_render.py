"""Bisect `ops/splat.py:render`'s internals on the PyTorch port (the twin of
`examples/profile_render.py`, a dev tool).

Builds a 10-frame map at 640x480, then times render's phases over the
whole map, each through `examples/torch_xbench.py` (device time per call on
the card, CPU time with `--platform cpu`): 0 transform + project, 1 the
float z scatter-min and 1p the packed-key scatter-min that `render` takes
when the key fits, 2 the exact path's winner scatter, 3 the winner gathers
into the candidate rows, 4 the dense 3x3 resolve; then `render` itself.

    python examples/torch_profile_render.py [--platform cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from densemonoslam_tpu_torch.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
from densemonoslam_tpu_torch.mapping import surfel_map as sm
from densemonoslam_tpu_torch.ops import splat, warp
from densemonoslam_tpu_torch.utils import se3

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_xbench import xbench  # noqa: E402

W, H = 640, 480
REPS = 10
_BIG = 2**30
_FAR = 1e9
_I32_MAX = 2**31 - 1


def main(argv=None, width: int = W, height: int = H, reps: int = REPS) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = args.platform
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --platform cpu to run on the CPU")
    HW = height * width
    camera = CameraConfig(
        FrameResolution(width, height),
        CameraIntrinsics(528.0 * width / 640, 528.0 * height / 480, width / 2 - 0.5,
                         height / 2 - 0.5), "p",
    )
    cfg = EngineConfig(
        max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0,
        nid_keyframing=True, pyramid_levels=4, track_row_stride=2, open_loop=True,
    )
    intr = camera.intrinsics
    seq = SyntheticSequence(camera=camera, num_frames=12, radius=0.12, max_angle=0.12)
    eng = Engine(camera, cfg, device=dev)
    eng.frontend("cam0")
    for i in range(10):
        r, d = seq.frame(i)
        eng.process_frame("cam0", r, d, float(i), sync=False)
    state = eng.frontends["cam0"].state
    data, count, pose = state.map_data, state.map_count, state.pose
    N = data.shape[0] - 1
    t_now = state.tick.to(torch.float32)
    depth_max = 100.0

    def phase0(data):
        rows = data[:-1]
        idx = torch.arange(N, device=data.device)
        conf = rows[:, sm.CONF]
        seen = sm.last_seen_any(rows)
        Tinv = se3.se3_inverse(pose)
        p_c = se3.transform_points(Tinv, rows[:, sm.POS])
        z = p_c[:, 2]
        zs = torch.clamp(z, min=1e-6)
        u = p_c[:, 0] / zs * intr.fx + intr.cx
        v = p_c[:, 1] / zs * intr.fy + intr.cy
        alive = (conf > 0) & (idx < count) & (t_now - seen < cfg.time_delta)
        visible = alive & (z > 0.05) & (z < depth_max)
        ui = torch.round(u).long()
        vi = torch.round(v).long()
        inb = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
        ok = visible & inb
        tid = torch.where(ok, vi * width + ui, HW)
        return tid, z, ok, u, v, p_c

    tid, z, ok, u, v, p_c = phase0(data)

    def phase1(tid, z, ok):
        zb = torch.full((HW + 1,), _FAR, dtype=torch.float32, device=z.device)
        return zb.scatter_reduce_(0, tid, torch.where(ok, z, _FAR), "amin")

    zbuf = phase1(tid, z, ok)
    idx_bits, z_shift = splat.packed_key_params(N, depth_max, False) or (21, 0)

    def phase1p(tid, z, ok):
        zc = torch.clamp(z, 0.05, depth_max).to(torch.float32)
        depth_key = (zc.view(torch.int32) - splat._Z_FLOOR_BITS) >> z_shift
        key = depth_key * (1 << idx_bits) + torch.arange(N, device=z.device, dtype=torch.int32)
        kbuf = torch.full((HW + 1,), _I32_MAX, dtype=torch.int32, device=z.device)
        return kbuf.scatter_reduce_(0, tid, torch.where(ok, key, _I32_MAX), "amin")

    def phase2(tid, z, ok, zbuf):
        is_win = ok & (z <= zbuf[tid])
        ib = torch.full((HW + 1,), _BIG, dtype=torch.int64, device=z.device)
        return ib.scatter_reduce_(
            0, tid, torch.where(is_win, torch.arange(N, device=z.device), _BIG), "amin")

    ibuf = phase2(tid, z, ok, zbuf)
    win = ibuf[:HW]
    has_win = win < _BIG
    win_safe = torch.where(has_win, win, N - 1)

    def phase3(data, u, v, z, p_c):
        w_rows = data[win_safe]
        w_u = torch.where(has_win, u[win_safe], -1e9)
        w_v = torch.where(has_win, v[win_safe], -1e9)
        w_z = torch.where(has_win, z[win_safe], _FAR)
        w_p = p_c[win_safe]
        Tinv = se3.se3_inverse(pose)
        w_n = se3.rotate_vectors(Tinv, w_rows[:, sm.NORMAL])
        r = torch.clamp(w_rows[:, sm.RADIUS] * intr.fx / torch.clamp(w_z, min=1e-6), 0.5, 2.25)
        return torch.cat(
            [
                w_u[:, None], w_v[:, None], w_z[:, None], w_p, w_n, r[:, None],
                torch.where(has_win, win, -1)[:, None].to(torch.float32),
                w_rows[:, sm.COLOR], sm.last_seen_any(w_rows)[:, None],
                w_rows[:, sm.CONF][:, None],
            ],
            dim=-1,
        ).reshape(height, width, 16)

    cand = phase3(data, u, v, z, p_c)

    def phase4(cand):
        x_pix, y_pix = warp.pixel_grid(height, width, cand.device)
        best_z = torch.full((height, width), _FAR, dtype=torch.float32, device=cand.device)
        best = torch.zeros((height, width, 16), dtype=torch.float32, device=cand.device)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cc = warp.shift(cand, dy, dx)
                du = cc[..., 0] - x_pix
                dv = cc[..., 1] - y_pix
                r_px = cc[..., 9]
                covers = (du * du + dv * dv) <= r_px * r_px
                valid = (cc[..., 2] > 0.05) & (cc[..., 2] < depth_max) & covers
                better = valid & (cc[..., 2] < best_z)
                best_z = torch.where(better, cc[..., 2], best_z)
                best = torch.where(better[..., None], cc, best)
        return best_z, best

    win_rows = cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    def render_active(data):
        return splat.render(data, count, pose, intr, width, height, state.tick,
                            time_delta=cfg.time_delta, mode=splat.MODE_ACTIVE, window=win_rows)

    res = xbench({
        "phase0 transform+project [N]": (phase0, (data,)),
        "phase1 scatter-min z": (phase1, (tid, z, ok)),
        "phase1p packed-key scatter-min": (phase1p, (tid, z, ok)),
        "phase2 is_win + scatter-min idx": (phase2, (tid, z, ok, zbuf)),
        "phase3 winner gathers+cand": (phase3, (data, u, v, z, p_c)),
        "phase4 dense 3x3 resolve": (phase4, (cand,)),
        "render (ACTIVE, windowed)": (render_active, (data,)),
    }, iters=reps, quiet=True)
    where = "device" if dev == "cuda" else "cpu"
    for k, val in res.items():
        print(f"{k:34s} {val:8.3f} ms ({where})")
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"platform={dev} {name}; {int(count)} surfels of {N} rows")
    return res


if __name__ == "__main__":
    main()
