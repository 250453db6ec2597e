"""The flagship step with example arguments: the port's twin of the
repository's `__graft_entry__.entry()`.

`entry()` returns `(fn, example_args)`: one full dense-SLAM frame step
(preprocess, prediction, SO3 + ICP + RGB tracking, the NID gate, fusion,
cleaning, keyframe promotion) over the device-resident state, at the same
shapes and with the same example arguments as the JAX entry.  On the card
`fn` is the graphed step (one CUDA graph, captured at its first call);
`device="cpu"` gives the eager step.
"""

from __future__ import annotations

import numpy as np
import torch

from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.config import CameraIntrinsics, EngineConfig

H, W = 96, 128
CAPACITY = 1 << 14


def config() -> tuple[EngineConfig, CameraIntrinsics]:
    """The entry's configuration and intrinsics (those of the JAX entry)."""
    intr = CameraIntrinsics(100.0, 100.0, W / 2 - 0.5, H / 2 - 0.5)
    cfg = EngineConfig(
        max_surfels=CAPACITY, depth_cutoff=100.0, depth_factor=1.0,
        nid_keyframing=True, open_loop=True,
    )
    return cfg, intr


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): `fn(state_tuple, rgb, depth, in_pose, use_in,
    weight, cluster) -> (new_state_tuple, stats[29])`, the state a tuple of
    `step.SlamState`'s fields in their order."""
    cfg, intr = config()
    step = stepmod.make_device_step(intr, H, W, cfg, 0, device)

    def fn(state_tuple, rgb, depth, in_pose, use_in, weight, cluster):
        new_state, stats = step(stepmod.SlamState(*state_tuple), rgb, depth, in_pose, use_in,
                                weight, cluster)
        return tuple(getattr(new_state, f) for f in stepmod.STATE_FIELDS), stats

    rng = np.random.default_rng(0)
    state0 = stepmod.init_state(CAPACITY, H, W, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    example_args = (
        tuple(getattr(state0, f) for f in stepmod.STATE_FIELDS),
        torch.from_numpy(rng.uniform(0, 255, (H, W, 3)).astype(np.float32)).to(device),
        torch.from_numpy(rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)).to(device),
        torch.eye(4, **f32),
        torch.zeros((), dtype=torch.bool, device=device),
        torch.ones((), **f32),
        torch.zeros((), **f32),
    )
    return fn, example_args
