"""Multi-host collaborative session launcher on the PyTorch port (the twin of
`examples/run_multihost.py`).

Starts N "hosts" as separate processes on this machine, joined into ONE
collaborative SLAM session by the port's `parallel.multihost.initialize`
(gloo over localhost).  Every host feeds its own synthetic camera to
`MultiHostSession.step`, and each prints the session-wide per-camera
surfels it sees (the reference's LCM-shared session state,
`Tools/networking/*`).  Each host's output goes to a file, printed when all
have ended, and one time limit holds for all of them, so a host cannot stall
its peers on a full pipe.

Usage: python examples/torch_run_multihost.py [--hosts 2] [--frames 5]
           [--device cuda|cpu]
The hosts run on the card (rank r on card r modulo the cards present)
unless `--device cpu` is given.  On a real multi-host deployment, run ONE
process per host instead with DMS_COORDINATOR, DMS_NUM_HOSTS, DMS_HOST_ID
and DMS_BACKEND set, then `multihost.initialize()`.
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_LIMIT_S = 600.0  # for all hosts together

WORKER = textwrap.dedent(
    """
    import os, sys
    pid, n, frames, device = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    from densemonoslam_tpu_torch import step as stepmod
    from densemonoslam_tpu_torch.config import CameraConfig, CameraIntrinsics, FrameResolution
    from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence
    from densemonoslam_tpu_torch.parallel import multihost

    assert multihost.initialize()
    if device == "cuda":
        device = f"cuda:{pid %% torch.cuda.device_count()}"
    W, H = 160, 120
    intr = CameraIntrinsics(132.0, 132.0, W / 2 - 0.5, H / 2 - 0.5)
    sess = multihost.MultiHostSession(intr, H, W, device=device)
    cam = CameraConfig(FrameResolution(W, H), intr)
    seqs = [SyntheticSequence(camera=cam, num_frames=frames + 4) for _ in sess.my_cam_slots]
    for t in range(frames):
        rgb = np.stack([s.frame(t)[0] for s in seqs])
        dep = np.stack([np.asarray(s.frame(t)[1], np.float32) for s in seqs])
        stats, total = sess.step(rgb, dep)
        per_cam = stats[:, stepmod.STAT_SURFELS].astype(int).tolist()
        print(f"[host {pid} view] t={t} session surfels/cam={per_cam} global={total}", flush=True)
    print(f"host {pid} done ({sess.n_cams}-camera session)", flush=True)
    torch.distributed.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the session runs on the card by default and no CUDA device is "
                               "available: pass --device cpu to run on the CPU")
    worker = WORKER % {"repo": REPO}
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(DMS_COORDINATOR=f"127.0.0.1:{_free_port()}", DMS_NUM_HOSTS=str(args.hosts),
               DMS_BACKEND="gloo")
    rc = 0
    with tempfile.TemporaryDirectory(prefix="multihost_") as logs:
        procs = []
        try:
            for p in range(args.hosts):
                with open(os.path.join(logs, f"host{p}.log"), "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", worker, str(p), str(args.hosts),
                         str(args.frames), args.device],
                        stdout=log, stderr=subprocess.STDOUT, env={**env, "DMS_HOST_ID": str(p)},
                    ))
            deadline = time.monotonic() + TIME_LIMIT_S
            for p in procs:
                try:
                    rc |= p.wait(timeout=max(deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    rc |= 1
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for p in range(len(procs)):
            with open(os.path.join(logs, f"host{p}.log")) as log:
                sys.stdout.write(log.read())
    if rc:
        print(f"a host failed or the session exceeded {TIME_LIMIT_S:.0f} s", file=sys.stderr)
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
