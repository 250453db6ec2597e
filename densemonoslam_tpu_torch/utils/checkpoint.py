"""Mid-session checkpoint / resume (port of
`densemonoslam_tpu.utils.checkpoint`).

A frontend's whole session state is its `step.SlamState`, its fern keyframe
database and coder, and its host logs, so a checkpoint is one `.npz` of
arrays.  The keys and dtypes are the JAX package's (`state_<field>`,
`ferndb_<field>`, `coder_<field>`, `pose_log`, `hist_times`, `ts_log`,
`stats_log`, `tick`; integer scalars and fern test positions as int32), so
a checkpoint written by either package loads into the other, and it loads
onto any device.  A resumed session continues bit-exactly on the device
that wrote it.
"""

from __future__ import annotations

import numpy as np
import torch

from densemonoslam_tpu_torch import loops as loopsmod
from densemonoslam_tpu_torch import step as stepmod
from densemonoslam_tpu_torch.mapping import ferns as fernmod

# integer fields the port keeps as int64 (int32 in the files)
_INT64_FERN_FIELDS = ("count", "ux", "vy")


def _to_file(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _fern_tensor(name: str, a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a)).to(device)
    if name in _INT64_FERN_FIELDS:
        return t.to(torch.int64)
    return t.to(torch.int32) if name == "codes" else t.to(torch.float32)


def save_frontend(path: str, fe) -> None:
    """Write a frontend's device state and host logs to one `.npz`."""
    payload = {f"state_{k}": v for k, v in stepmod.state_to_numpy(fe.state).items()}
    if fe.fern_state is not None:
        payload.update({f"ferndb_{k}": _to_file(v) for k, v in fe.fern_state.db._asdict().items()})
        payload.update(
            {f"coder_{k}": _to_file(v) for k, v in fe.fern_state.coder._asdict().items()}
        )
    n = len(fe.ts_log)
    payload["pose_log"] = (
        fe.pose_hist[:n].cpu().numpy() if fe.pose_hist is not None
        else np.zeros((0, 4, 4), np.float32)
    )
    payload["hist_times"] = (
        fe.hist_times[:n].cpu().numpy() if fe.hist_times is not None
        else np.zeros((0,), np.float32)
    )
    payload["ts_log"] = np.asarray(fe.ts_log, np.float64)
    payload["stats_log"] = (
        torch.stack(fe.stats_log).cpu().numpy() if fe.stats_log
        else np.zeros((0, stepmod.N_STATS_TOTAL), np.float32)
    )
    payload["tick"] = np.asarray(fe.tick)
    np.savez_compressed(path, **payload)


def load_frontend(path: str, fe) -> None:
    """Restore a frontend saved by `save_frontend` (of either package), in
    place, onto the device of the frontend's state."""
    dev = fe.state.map_data.device
    z = np.load(path)
    fields = {}
    for k in stepmod.STATE_FIELDS:
        if f"state_{k}" in z:
            dtype = torch.int64 if k in stepmod._INT_FIELDS else torch.float32
            fields[k] = torch.from_numpy(np.array(z[f"state_{k}"])).to(device=dev, dtype=dtype)
        else:
            # a field the writer's build did not have: keep the fresh default
            # (init_state marks the model invalid, so the first step re-renders)
            fields[k] = getattr(fe.state, k)
    fe.state = stepmod.SlamState(**fields)
    if "ferndb_codes" in z:
        fe.fern_state = loopsmod.FernLoopState(
            coder=fernmod.FernCoder(
                **{k: _fern_tensor(k, z[f"coder_{k}"], dev) for k in fernmod.FernCoder._fields}
            ),
            db=fernmod.FernDB(
                **{k: _fern_tensor(k, z[f"ferndb_{k}"], dev) for k in fernmod.FernDB._fields}
            ),
        )
    pose_log = z["pose_log"]
    n = pose_log.shape[0]
    cap = 1024
    while cap < max(n + 1, 1):
        cap *= 2
    hist = np.zeros((cap, 4, 4), np.float32)
    hist[:n] = pose_log
    htimes = np.zeros((cap,), np.float32)
    if "hist_times" in z:
        htimes[:n] = z["hist_times"]
    else:  # older checkpoint: session ticks = frame index (single camera)
        htimes[:n] = np.arange(n, dtype=np.float32)
    fe.pose_hist = torch.from_numpy(hist).to(dev)
    fe.hist_times = torch.from_numpy(htimes).to(dev)
    fe.ts_log = [float(t) for t in z["ts_log"]]
    stats_arr = np.asarray(z["stats_log"], np.float32)
    if stats_arr.shape[0] > 0 and stats_arr.shape[1] < stepmod.N_STATS_TOTAL:
        # a checkpoint from before the stats rows carried the pose: pad each
        # row with its frame's pose from the history so new rows stack
        pad = np.zeros((stats_arr.shape[0], stepmod.N_STATS_TOTAL - stats_arr.shape[1]), np.float32)
        n_pose = min(stats_arr.shape[0], n)
        if pad.shape[1] == 16 and n_pose > 0:
            pad[:n_pose] = pose_log[:n_pose].reshape(n_pose, 16)
        stats_arr = np.concatenate([stats_arr, pad], axis=1)
    fe.stats_log = list(torch.from_numpy(stats_arr).to(dev).unbind(0))
    fe.tick = int(z["tick"])
