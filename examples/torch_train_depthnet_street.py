"""Train the PyTorch port's monocular DepthNet on the street-scale procedural
scene (the twin of `examples/train_depthnet_street.py`).

The monocular KITTI mode needs a depth CNN; with no checkpoint to download,
the street weights are trained on the analytic street loop (`io/street.py`),
the scene the monocular pipeline is evaluated on, with held-out views and
exposure jitter so the net learns appearance -> depth, not frame identity.
Two laps at 256x80 (radius 50 and 38 m) and one at the full KITTI 1024x320
(radius 44 m): conv receptive fields are fixed in pixels, so training at one
resolution does not carry across a 4x change of scale.

Usage:  python examples/torch_train_depthnet_street.py [--steps 800]
            [--batch 4] [--frames 260] [--device cuda|cpu] [--out DIR]
Writes: DIR/depthnet_street.{npz,json}; DIR defaults to the port's packaged
weights, densemonoslam_tpu_torch/models/weights.  It runs on the card unless
`--device cpu` is given, and raises without one.
"""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from densemonoslam_tpu_torch.config import CameraConfig  # noqa: E402
from densemonoslam_tpu_torch.io.street import StreetSequence  # noqa: E402
from densemonoslam_tpu_torch.models.depthnet import (  # noqa: E402
    WEIGHTS_DIR, DepthPredictor, make_train_step,
)
from torch_train_depthnet import LR, rel_err, upload  # noqa: E402

MIN_D, MAX_D = 2.0, 80.0
WIDTHS = (16, 32, 64)
N_HELD, N_HELD_KITTI = 16, 8


def sequences(n_frames: int = 260) -> tuple:
    """([the two 256x80 laps], the 1024x320 KITTI lap)."""
    laps = [
        StreetSequence(num_frames=n_frames, radius=50.0, exposure_jitter=0.05),
        StreetSequence(num_frames=n_frames // 2, radius=38.0, exposure_jitter=0.05),
    ]
    kitti = StreetSequence(camera=CameraConfig.kitti_default(), num_frames=n_frames // 2,
                           radius=44.0, exposure_jitter=0.05)
    return laps, kitti


def render_frames(n_frames: int = 260) -> tuple:
    """(the 256x80 views of both laps, the KITTI lap's views), each a list of
    (RGB u8, depth f32)."""
    laps, kitti = sequences(n_frames)
    frames = [seq.frame(i) for seq in laps for i in range(len(seq))]
    return frames, [kitti.frame(i) for i in range(len(kitti))]


def train(frames=None, frames_k=None, steps: int = 800, batch: int = 4, n_frames: int = 260,
          device="cuda", out=WEIGHTS_DIR) -> dict:
    """Train from flax's initialisation (seed 0) with Adam 1e-3: every third
    step a batch of `batch // 2` KITTI views, the others `batch` 256x80
    views; save the weights and their json into `out`.

    `frames` / `frames_k` default to `render_frames(n_frames)`.  The batches
    are drawn from `numpy.random.default_rng(0)` in the JAX trainer's order;
    the frames go to the device once, and a step reads nothing back.
    Returns both held-out errors, every step's loss and the seconds the
    steps took."""
    pred = DepthPredictor(widths=WIDTHS, min_depth=MIN_D, max_depth=MAX_D, device=device)
    if frames is None:
        frames, frames_k = render_frames(n_frames)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(frames))
    held, train_ids = idx[:N_HELD], idx[N_HELD:]
    idx_k = rng.permutation(len(frames_k))
    held_k, train_k = idx_k[:N_HELD_KITTI], idx_k[N_HELD_KITTI:]
    print(f"{len(train_ids)}+{len(train_k)} train / {len(held)}+{len(held_k)} held")
    takes, takes_k = [], []
    for it in range(steps):
        if it % 3 == 2:
            takes_k.append(rng.choice(train_k, max(batch // 2, 1), replace=False))
        else:
            takes.append(rng.choice(train_ids, batch, replace=False))
    data = [upload(frames, pred.device), upload(frames_k, pred.device)]
    takes = [torch.from_numpy(np.stack(t)).to(pred.device) if t else None for t in (takes, takes_k)]
    used = [0, 0]
    opt = torch.optim.Adam(pred.net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(pred.net, opt)

    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        k = int(it % 3 == 2)  # 1: a KITTI batch
        (rgb_all, dep_all), take = data[k], takes[k][used[k]]
        used[k] += 1
        rgb = rgb_all.index_select(0, take).to(torch.float32) / 255.0
        losses.append(step(rgb, dep_all.index_select(0, take)))
        if it % 50 == 0 or it == steps - 1:
            print(f"step {it}: loss {float(losses[-1]):.4f}  ({time.perf_counter() - t0:.0f}s)")
    losses = torch.stack(losses).cpu().numpy()
    train_s = time.perf_counter() - t0

    rel = rel_err(pred, frames, held)
    rel_k = rel_err(pred, frames_k, held_k)
    H, W = frames[0][1].shape
    K_H, K_W = frames_k[0][1].shape
    print(f"held-out rel depth err: {rel * 100:.1f}% ({W}x{H}), {rel_k * 100:.1f}% ({K_W}x{K_H})")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "depthnet_street.npz")
    pred.save(path)
    with open(path.replace(".npz", ".json"), "w") as f:
        json.dump(
            {
                "widths": list(WIDTHS), "min_depth": MIN_D, "max_depth": MAX_D,
                "held_out_rel_err": rel, "held_out_rel_err_kitti": rel_k,
                "train_res": [H, W],
            },
            f,
        )
    print("saved depthnet_street.npz")
    return dict(rel=rel, rel_kitti=rel_k, losses=losses, train_s=train_s, steps=steps, path=path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=260)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=str(WEIGHTS_DIR))
    args = ap.parse_args()
    train(steps=args.steps, batch=args.batch, n_frames=args.frames, device=args.device,
          out=args.out)


if __name__ == "__main__":
    main()
