"""What the monocular checks share: the reference's depth CNN, read from
the packaged weight files that the configuration's ``depth_net`` names
(the raw files the program reads too), once per run."""

from __future__ import annotations

import os
from pathlib import Path

from reference.depthnet import DepthNet


def reference_net(ctx) -> DepthNet:
    net = ctx.probes.get("reference_net")
    if net is None:
        root = Path(os.path.dirname(os.path.abspath(ctx.spec.bench_dir)))
        base = root / "densemonoslam_tpu_torch" / "models" / "weights" / f"depthnet_{ctx.config['depth_net']}"
        net = ctx.probes["reference_net"] = DepthNet.from_files(
            base.with_suffix(".npz"), base.with_suffix(".json"), ctx.device)
    return net
