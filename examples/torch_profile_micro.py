"""Micro-benchmarks of the render / track / fuse internals of the PyTorch
port (the twin of `examples/profile_micro.py`).

Decomposes the three expensive stages that `torch_profile_stages.py`
finds into their candidate bottleneck operations (the scatter-min
z-buffer, the attribute gather, the disk resolve, the GN iteration's
gather and Gram, the packing sorts) and times each through
`examples/torch_xbench.py`: device time per call on the card (CPU time
with `--platform cpu`).  The z-buffer case is the port's own code path,
`ops/splat.py`'s `scatter_reduce_(..., "amin")` on the packed int32 key;
the Gram case goes through kernel K1.

    python examples/torch_profile_micro.py [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from densemonoslam_tpu_torch.config import CameraIntrinsics
from densemonoslam_tpu_torch.ops import reductions, warp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_xbench import xbench  # noqa: E402

H, W = 480, 640
N_WIN = 1 << 19  # active window rows in the render
_I32_MAX = int(np.iinfo(np.int32).max)


def cases(device="cuda", height: int = H, width: int = W, n_win: int = N_WIN) -> dict:
    """{name: (fn, args)} of every micro case on `device`, inputs from a
    seeded generator."""
    rng = np.random.default_rng(0)
    HW = height * width

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)

    out = {}

    # ---- render internals -------------------------------------------------
    key = t(rng.integers(0, 2**30, n_win), torch.int32)
    tid = t(rng.integers(0, HW, n_win), torch.int64)

    def scatter_min(key, tid):
        # ops/splat.py's z-buffer: one scatter-min of the packed int32 key
        kbuf = torch.full((HW + 1,), _I32_MAX, dtype=torch.int32, device=key.device)
        return kbuf.scatter_reduce_(0, tid, key, "amin")

    out["render/scatter_min_512k"] = (scatter_min, (key, tid))

    rows = t(rng.normal(size=(n_win, 16)))

    def row_transform(rows):
        # the per-surfel projection work before the scatter
        T = torch.eye(4, dtype=torch.float32, device=rows.device)
        p = rows[:, 0:3] @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp(p[:, 2], min=1e-6)
        u = p[:, 0] / z * 500.0 + 320.0
        v = p[:, 1] / z * 500.0 + 240.0
        return u, v, z

    out["render/project_512k"] = (row_transform, (rows,))

    win = t(rng.integers(0, n_win, HW), torch.int64)

    def attr_gather(rows, win):
        return rows[win]

    out["render/row_gather_307k_of_512k"] = (attr_gather, (rows, win))

    cand = t(rng.normal(size=(height, width, 16)))

    def disk_resolve(cand):
        x_pix, y_pix = warp.pixel_grid(height, width, cand.device)
        best_z = torch.full((height, width), 1e9, dtype=torch.float32, device=cand.device)
        best = torch.zeros((height, width, 16), dtype=torch.float32, device=cand.device)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                c = warp.shift(cand, dy, dx)
                du = c[..., 0] - x_pix
                dv = c[..., 1] - y_pix
                covers = (du * du + dv * dv) <= c[..., 9] * c[..., 9]
                better = (c[..., 2] > 0.05) & covers & (c[..., 2] < best_z)
                best_z = torch.where(better, c[..., 2], best_z)
                best = torch.where(better[..., None], c, best)
        return best_z, best

    out["render/disk_resolve_3x3"] = (disk_resolve, (cand,))

    # ---- track internals --------------------------------------------------
    intr = CameraIntrinsics(528.0, 528.0, width / 2 - 0.5, height / 2 - 0.5)
    pack = t(rng.normal(size=(height, width, 12)))
    P = HW // 4  # stride-2 rows at level 0
    u = t(rng.uniform(0, width - 2, P))
    v = t(rng.uniform(0, height - 2, P))

    def sample_near(pack, u, v):
        return reductions.sample_model(pack, u, v, bilinear=False)

    def sample_bilin(pack, u, v):
        return reductions.sample_model(pack, u, v, bilinear=True)

    out["track/sample_nearest_77k"] = (sample_near, (pack, u, v))
    out["track/sample_bilinear_77k"] = (sample_bilin, (pack, u, v))

    M = t(rng.normal(size=(P, 16)))

    def gram16(M):
        return reductions.gram(M)

    out["track/gram_77k_x16"] = (gram16, (M,))

    vmap_c = t(rng.normal(size=(height // 2, width // 2, 3)))
    nmap_c = t(rng.normal(size=(height // 2, width // 2, 3)))
    int_c = t(rng.normal(size=(height // 2, width // 2)))
    A = torch.eye(4, dtype=torch.float32, device=device)

    def one_gn_iter(vmap_c, nmap_c, int_c, pack, A):
        M_icp, M_rgb = reductions.joint_rows_packed(
            vmap_c, nmap_c, int_c, pack, A, intr, bilinear=False
        )
        return reductions.combined_system(M_icp, M_rgb, icp_weight=10.0)

    out["track/one_gn_iter_L0s2"] = (one_gn_iter, (vmap_c, nmap_c, int_c, pack, A))

    # ---- fuse internals ---------------------------------------------------
    is_new = t(rng.uniform(size=HW) < 0.05, torch.bool)
    rows_hw = t(rng.normal(size=(HW, 16)))

    def pack_sort(is_new, rows_hw):
        order = torch.argsort((~is_new).to(torch.uint8), stable=True)
        return rows_hw[order]

    out["fuse/argsort_pack_307k"] = (pack_sort, (is_new, rows_hw))

    def cumsum_pack(is_new, rows_hw):
        # scatter-based compaction: destination = prefix-sum rank
        dest = torch.cumsum(is_new.to(torch.int64), 0) - 1
        dest = torch.where(is_new, dest, HW)
        outp = torch.zeros((HW + 1, 16), dtype=torch.float32, device=rows_hw.device)
        return outp.index_copy_(0, dest, rows_hw)[:HW]

    out["fuse/cumsum_scatter_pack_307k"] = (cumsum_pack, (is_new, rows_hw))

    payload = t(rng.normal(size=(height, width, 12)))
    win_f = t(rng.integers(-1, n_win, (height, width)))

    def pull_accum(payload, win_f):
        acc = torch.zeros((height, width, 12), dtype=torch.float32, device=payload.device)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                s = warp.shift(payload, dy, dx)
                hit = (s[..., 0] == win_f) & (win_f >= 0)
                acc = acc + torch.where(hit[..., None], s, 0.0)
        return acc

    out["fuse/pull_accum_3x3"] = (pull_accum, (payload, win_f))

    big = torch.zeros((2 * n_win, 16), dtype=torch.float32, device=device)
    blk = t(rng.normal(size=(n_win, 16)))

    def dyn_update(big, blk):
        # the window write of `fusion.place_updates`: rows at a device-side start
        start = torch.full((), 7, dtype=torch.int64, device=big.device)
        return big.index_copy_(0, start + torch.arange(blk.shape[0], device=big.device), blk)

    out["fuse/dyn_update_512k_into_1M"] = (dyn_update, (big, blk))
    return out


def main(argv=None, height: int = H, width: int = W, n_win: int = N_WIN,
         iters: int = 50) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = args.platform
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --platform cpu to run on the CPU")
    res = xbench(cases(dev, height, width, n_win), iters=iters, quiet=True)
    where = "device" if dev == "cuda" else "cpu"
    for k, v in res.items():
        print(f"{k:<34} {v:7.3f} ms ({where})")
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"platform={dev} {name}")
    return res


if __name__ == "__main__":
    main()
