"""Per-stage breakdown of the monocular-hybrid street frame on the PyTorch
port (the twin of `examples/profile_mono.py`).

Runs the bench's configuration (`torch_bench._run_mono_street`) twice over
the same frames:

1. **pipelined**: as the bench runs it (no added syncs): the honest fps,
   and on the card the host syncs per frame from CUDA's sync-debug mode;
2. **staged**: every pipeline stage wrapped with `torch.cuda.synchronize()`
   after it: wall time attributed to depth CNN / sparse detect / sparse
   match+pose / dense step / tracker flush (keyframes, loop retrieval,
   local BA) / loop machinery, with calls per frame and the kernel builds
   (`ops/cuda_build.py`, the counterpart of the JAX script's recompiles)
   inside the timed frames.

    python examples/torch_profile_mono.py [--platform cuda|cpu]

`PROFILE_FRAMES` (default 72) sets the frames, the first 12 untimed.
"""

import argparse
import collections
import functools
import os
import sys
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import torch

from densemonoslam_tpu_torch import loops as loopsmod
from densemonoslam_tpu_torch.config import CameraConfig, EngineConfig
from densemonoslam_tpu_torch.engine import Engine
from densemonoslam_tpu_torch.io.street import StreetSequence
from densemonoslam_tpu_torch.models.depthnet import DepthPredictor
from densemonoslam_tpu_torch.ops import cuda_build
from densemonoslam_tpu_torch.tracking.sparse import SparseTracker

N_FRAMES = int(os.environ.get("PROFILE_FRAMES", "72"))
WARM = 12


class Stages:
    """Wall time and calls per stage name; nested stages subtract their
    time from the stage that called them."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.times = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self.active = []  # stage stack

    def clear(self) -> None:
        self.times.clear()
        self.calls.clear()

    def staged(self, name, fn):
        """Wrap fn: wait for the device after it, attribute wall time."""

        @functools.wraps(fn)
        def wrap(*a, **k):
            t0 = time.perf_counter()
            self.active.append(0.0)
            try:
                out = fn(*a, **k)
                if self.on_card:
                    torch.cuda.synchronize()
            finally:
                dt = time.perf_counter() - t0
                child = self.active.pop()
                if self.active:
                    self.active[-1] += dt
                self.times[name] += dt - child
                self.calls[name] += 1
            return out

        return wrap


def build(seq, device="cuda"):
    cfg = EngineConfig(
        max_surfels=1 << 22, depth_cutoff=40.0, max_depth=80.0,
        depth_factor=1.0, depth_gate_rel=0.1, nid_keyframing=True,
        open_loop=True, predict_depth=True, orb_tracking=True,
        hybrid_loops=True, time_delta=200, pyramid_levels=4,
        track_row_stride=2,
    )
    eng = Engine(seq.camera, cfg, device=device)
    eng.frontend("cam0")
    eng.set_depth_predictor(DepthPredictor.pretrained_street(device=device))
    fe = eng.frontends["cam0"]
    fe.pose = seq.gt_pose(0).astype(np.float32)
    fe.sparse_tracker = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=100, device=device,
    )
    fe.sparse_tracker.pose = fe.pose
    return eng, fe


def instrument(eng, fe, stages: Stages):
    """Wrap the stages of one engine; returns a function that undoes the
    module-level wrap (`loops.apply_hybrid_loop`)."""
    st = fe.sparse_tracker
    eng._depth_predictor.predict = stages.staged("depth_cnn", eng._depth_predictor.predict)
    st.detect = stages.staged("sparse_detect", st.detect)
    st.track = stages.staged("sparse_track_total", st.track)
    st.flush = stages.staged("tracker_flush", st.flush)
    st._process_batch = stages.staged("flush_batch", st._process_batch)
    st._advance_async = stages.staged("flush_async", st._advance_async)
    fe.step_fn = stages.staged("dense_step", fe.step_fn)
    orig = loopsmod.apply_hybrid_loop
    loopsmod.apply_hybrid_loop = stages.staged("hybrid_loop", orig)

    def undo():
        loopsmod.apply_hybrid_loop = orig

    return undo


def run(eng, fe, frames, stages: Stages, count_syncs: bool = False):
    """Warm up on the first `WARM` frames, then time the rest; returns
    (seconds, host syncs in the timed frames or None, kernel builds in
    the timed frames)."""
    dev = eng.device
    for i in range(WARM):
        eng.process_frame("cam0", frames[i], None, float(i), sync=False)
    if stages.on_card:
        torch.cuda.synchronize()
    stages.clear()
    builds0 = cuda_build.BUILDS
    syncs = None
    caught = []
    if count_syncs and dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            for i in range(WARM, len(frames)):
                t_f0 = time.perf_counter()
                eng.process_frame("cam0", frames[i], None, float(i), sync=False)
                stages.times["_frame_wall"] += time.perf_counter() - t_f0
                stages.calls["_frame_wall"] += 1
            if stages.on_card:
                torch.cuda.synchronize()
            total = time.perf_counter() - t0
    finally:
        if count_syncs and dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchroniz" in str(w.message) for w in caught)
    return total, syncs, cuda_build.BUILDS - builds0


def report(stages: Stages, total: float, n_timed: int) -> None:
    print(f"\n{'stage':24s} {'ms/frame':>9s} {'calls/frame':>12s} {'total s':>8s}")
    other = total
    for k in sorted(stages.times, key=lambda k: -stages.times[k]):
        if k.startswith("_"):
            continue
        print(f"{k:24s} {1e3 * stages.times[k] / n_timed:9.2f} "
              f"{stages.calls[k] / n_timed:12.2f} {stages.times[k]:8.2f}")
        other -= stages.times[k]
    print(f"{'(host gaps / other)':24s} {1e3 * other / n_timed:9.2f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = args.platform
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --platform cpu to run on the CPU")
    seq = StreetSequence(
        camera=CameraConfig.kitti_default(), num_frames=N_FRAMES,
        exposure_jitter=0.03,
    )
    frames = [seq.frame(i)[0] for i in range(N_FRAMES)]
    n_timed = N_FRAMES - WARM

    # ---- leg 1: pipelined (bench-identical) -------------------------------
    eng, fe = build(seq, dev)
    total, syncs, _ = run(eng, fe, frames, Stages(dev), count_syncs=True)
    per = f"{syncs / n_timed:.3f}" if syncs is not None else "not measured (CPU)"
    print(f"pipelined: {n_timed / total:.2f} fps "
          f"({1e3 * total / n_timed:.1f} ms/frame), host syncs/frame {per}")

    # ---- leg 2: staged ----------------------------------------------------
    eng, fe = build(seq, dev)
    stages = Stages(dev)
    undo = instrument(eng, fe, stages)
    try:
        total_s, _, builds = run(eng, fe, frames, stages)
    finally:
        undo()
    print(f"\nstaged:    {n_timed / total_s:.2f} fps "
          f"({1e3 * total_s / n_timed:.1f} ms/frame) — sync overhead included")
    report(stages, total_s, n_timed)
    print(f"\nkernel builds in timed region: {builds}")
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"platform={dev} {name}")
    return dict(fps=n_timed / total, staged_fps=n_timed / total_s, syncs=syncs,
                stages=dict(stages.times), calls=dict(stages.calls), builds=builds)


if __name__ == "__main__":
    main()
