"""Train the PyTorch port's monocular DepthNet on the synthetic RGB-D scene
(the twin of `examples/train_depthnet.py`).

No public depth checkpoint is available, so the packaged weights are
distilled from the analytic synthetic scene: four orbits at different radii
and angles, 148 training and 12 held-out views, and the net must reach <10%
mean relative depth error on the held-out views, which makes the monocular
engine mode (`predict_depth=True`) work end to end.

Usage:  python examples/torch_train_depthnet.py [--steps 600] [--batch 4]
            [--device cuda|cpu] [--out DIR]
Writes: DIR/depthnet_synthetic.{npz,json}; DIR defaults to the port's
packaged weights, densemonoslam_tpu_torch/models/weights.  It runs on the
card unless `--device cpu` is given, and raises without one.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from densemonoslam_tpu_torch.models.depthnet import (  # noqa: E402
    WEIGHTS_DIR, DepthPredictor, make_train_step,
)

WIDTHS, MIN_D, MAX_D = (16, 32, 64), 0.5, 10.0
ORBITS = ((0.15, 0.15), (0.35, 0.3), (0.5, 0.45), (0.25, 0.6))  # (radius, max angle)
N_HELD = 12
LR = 1e-3


def sequences() -> list:
    """The four orbits of the scene whose views the net learns."""
    return [SyntheticSequence(num_frames=40, radius=r, max_angle=a) for r, a in ORBITS]


def render_frames() -> list:
    """Every (RGB u8, depth f32) view of `sequences()`, in order."""
    return [seq.frame(i) for seq in sequences() for i in range(len(seq))]


def upload(frames: list, device: torch.device) -> tuple:
    """The frames as one u8 RGB and one f32 depth tensor on `device`."""
    rgb = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    return rgb, torch.from_numpy(np.stack([f[1] for f in frames])).to(device)


def rel_err(pred: DepthPredictor, frames: list, ids) -> float:
    """Mean over the views `ids` of the mean relative depth error on pixels
    with true depth."""
    rels = []
    for i in ids:
        rgb, dep = frames[i]
        d_hat = pred.predict(rgb).cpu().numpy()
        m = dep > 0
        rels.append(np.mean(np.abs(d_hat[m] - dep[m]) / dep[m]))
    return float(np.mean(rels))


def train(frames=None, steps: int = 600, batch: int = 4, device="cuda", out=WEIGHTS_DIR) -> dict:
    """Train from flax's initialisation (seed 0) with Adam 1e-3, save the
    weights and their json into `out`, and require <10% held-out error.

    `frames` defaults to `render_frames()`.  The batches are drawn from
    `numpy.random.default_rng(0)` in the JAX trainer's order; the frames go
    to the device once, and a step reads nothing back: the loss is read only
    when it is printed.  Returns the held-out error, every step's loss and
    the seconds the steps took."""
    pred = DepthPredictor(widths=WIDTHS, min_depth=MIN_D, max_depth=MAX_D, device=device)
    if frames is None:
        frames = render_frames()
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(frames))
    held, train_ids = idx[:N_HELD], idx[N_HELD:]
    print(f"{len(train_ids)} train / {len(held)} held-out frames")
    takes = torch.from_numpy(np.stack(
        [rng.choice(train_ids, batch, replace=False) for _ in range(steps)]
    )).to(pred.device)
    rgb_all, dep_all = upload(frames, pred.device)
    opt = torch.optim.Adam(pred.net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(pred.net, opt)

    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        rgb = rgb_all.index_select(0, takes[it]).to(torch.float32) / 255.0
        losses.append(step(rgb, dep_all.index_select(0, takes[it])))
        if it % 50 == 0 or it == steps - 1:
            print(f"step {it}: loss {float(losses[-1]):.4f}  ({time.perf_counter() - t0:.0f}s)")
    losses = torch.stack(losses).cpu().numpy()
    train_s = time.perf_counter() - t0

    rel = rel_err(pred, frames, held)
    print(f"held-out mean relative depth error: {rel * 100:.2f}%")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "depthnet_synthetic.npz")
    pred.save(path)
    with open(path.replace(".npz", ".json"), "w") as f:
        json.dump(
            {
                "widths": list(WIDTHS),
                "min_depth": MIN_D,
                "max_depth": MAX_D,
                "holdout_rel_err": rel,
                "train_frames": len(train_ids),
                "steps": steps,
            },
            f,
            indent=2,
        )
    print(f"saved {path}")
    assert rel < 0.10, "training did not reach <10% relative error"
    return dict(rel=rel, losses=losses, train_s=train_s, steps=steps, path=path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=str(WEIGHTS_DIR))
    args = ap.parse_args()
    train(steps=args.steps, batch=args.batch, device=args.device, out=args.out)


if __name__ == "__main__":
    main()
