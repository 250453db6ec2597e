"""KITTI odometry -> .klg converter on the PyTorch port (the twin of
`examples/convert_kitti.py`: the reference's `logs/kitti/kitti_odom_to_lcm.py`
rescales frames to the network feed size, corrects intrinsics, optionally
runs depth prediction, and writes ground-truth trajectories).

Usage:
    python examples/torch_convert_kitti.py --seq /data/kitti/sequences/00 \\
        --out kitti00.klg [--depth-dir DIR | --predict-depth WEIGHTS.npz] \\
        [--gt poses.txt --gt-out kitti00.freiburg] [--device cuda|cpu]

Depth comes from (a) a precomputed depth dir (uint16 mm PNGs), (b) the
port's depth network with the given weights, or (c) zeros (track-only
stream).  With (b) the network's widths and depth range come from the json
beside the weights (`WEIGHTS.json`, as the packaged files have), else the
`DepthPredictor` defaults; it runs on the card unless `--device cpu` is
given.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def load_predictor(path: str, device: str):
    """A `DepthPredictor` holding the weights at `path`, built at the widths
    and depth range of the json beside them when there is one."""
    from densemonoslam_tpu_torch.models.depthnet import DepthPredictor

    meta_path = os.path.splitext(path)[0] + ".json"
    kw = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        kw = dict(widths=tuple(meta["widths"]), min_depth=meta["min_depth"],
                  max_depth=meta["max_depth"])
    predictor = DepthPredictor(device=device, **kw)
    predictor.load(path)
    return predictor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True, help="KITTI sequence dir (contains image_2/)")
    ap.add_argument("--out", required=True, help="output .klg path")
    ap.add_argument("--depth-dir", default=None)
    ap.add_argument("--predict-depth", default=None, help="depth net weights npz")
    ap.add_argument("--frames", type=int, default=10**9)
    ap.add_argument("--feed-width", type=int, default=1024)
    ap.add_argument("--feed-height", type=int, default=320)
    ap.add_argument("--gt", default=None, help="KITTI poses .txt (r11..tz rows)")
    ap.add_argument("--gt-out", default=None, help="write .freiburg gt here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the depth network runs (with --predict-depth)")
    args = ap.parse_args(argv)

    from densemonoslam_tpu_torch.io.datasets import KittiOdometryReader
    from densemonoslam_tpu_torch.io.klg import write_klg

    reader = KittiOdometryReader(args.seq, args.depth_dir, args.feed_width, args.feed_height)
    predictor = load_predictor(args.predict_depth, args.device) if args.predict_depth else None

    def frames():
        n = 0
        while reader.has_more() and n < args.frames:
            rgb, depth, ts = reader.get_next()
            if predictor is not None:
                depth = predictor.predict(rgb).cpu().numpy()
            yield rgb, (depth * 1000.0).astype(np.uint16), int(ts)
            n += 1

    n = write_klg(args.out, frames())
    print(f"wrote {n} frames to {args.out}")

    if args.gt and args.gt_out:
        from densemonoslam_tpu_torch.io.writers import save_freiburg

        poses = []
        with open(args.gt) as f:
            for line in f:
                vals = [float(x) for x in line.split()]
                T = np.eye(4)
                T[:3] = np.array(vals).reshape(3, 4)
                poses.append(T)
        save_freiburg(args.gt_out, list(range(len(poses))), poses)
        print(f"wrote gt to {args.gt_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
