"""Collaborative session formation over `torch.distributed` (port of
`densemonoslam_tpu.parallel.multihost`): one camera per rank, each rank
feeding its own camera's frames.

The reference forms distributed sessions over LCM multicast, with every
host publishing frames to one GPU machine.  Here compute is what is
distributed: `initialize` joins the ranks into one process group, each rank
runs its camera's full per-frame step on its own device (`parallel.collab`)
and only the session-wide collectives cross between ranks: the stats
gather, the surfel total, the inter-map rounds.

The backend is the caller's choice (`backend=` or `DMS_BACKEND`), never a
default: NCCL when each rank has a GPU of its own; gloo on the CPU, or for
several ranks sharing one GPU, which NCCL refuses.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from densemonoslam_tpu_torch.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu_torch.parallel import mesh as meshmod

BACKENDS = ("gloo", "nccl")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join (or form) the session's process group.

    Values default from the environment: `DMS_COORDINATOR` (``host:port``
    of rank 0), `DMS_NUM_HOSTS`, `DMS_HOST_ID` and `DMS_BACKEND` (``gloo``
    or ``nccl``).  With no coordinator and no process count configured this
    is a single-process session: nothing is joined and it returns False."""
    coordinator_address = coordinator_address or os.environ.get("DMS_COORDINATOR")
    if num_processes is None and "DMS_NUM_HOSTS" in os.environ:
        num_processes = int(os.environ["DMS_NUM_HOSTS"])
    if process_id is None and "DMS_HOST_ID" in os.environ:
        process_id = int(os.environ["DMS_HOST_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    backend = backend or os.environ.get("DMS_BACKEND")
    if backend not in BACKENDS:
        raise ValueError(f"choose the session's backend explicitly, one of {BACKENDS}: got {backend!r}")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a session needs its coordinator address, process count and process id")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    return True


def session_mesh(n_cams: Optional[int] = None) -> meshmod.Mesh:
    """The session's mesh: one camera per rank, in rank order, on `cam`."""
    return meshmod.make_mesh(n_cams=n_cams, n_map=1)


class MultiHostSession:
    """A running collaborative session; each rank runs::

        multihost.initialize()                   # join the process group
        sess = multihost.MultiHostSession(intr, H, W, cfg)
        for ...:
            stats, total = sess.step(rgb_local, depth_local)   # this rank's camera

    `rgb_local` [1, H, W, 3] and `depth_local` [1, H, W] carry this rank's
    camera only; `stats` [n_cams, 29] is every camera's stats row (the same
    on every rank) and `total` the surfels of all maps."""

    def __init__(
        self,
        intr: CameraIntrinsics,
        height: int,
        width: int,
        config: Optional[EngineConfig] = None,
        device: torch.device | str = "cuda",
    ):
        from densemonoslam_tpu_torch.parallel import collab

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the session runs on the card by default and no CUDA device is available: "
                'pass device="cpu" to run on the CPU'
            )
        self.process_id = dist.get_rank()
        self.n_cams = dist.get_world_size()
        self.height, self.width = height, width
        self.intr = intr
        self.cfg = config or EngineConfig(
            max_surfels=1 << 15, depth_cutoff=100.0, depth_factor=1.0, nid_keyframing=False,
            open_loop=True,
        )
        self.mesh = session_mesh(self.n_cams)
        self.step_fn = collab.make_collab_step(self.mesh, intr, height, width, self.cfg)
        self.state = collab.init_state(self.cfg.max_surfels, height, width, device=self.device)
        self._im_round = None
        self._im_state = None
        self.ticks = 0

    def _local(self, batch, dtype=None) -> torch.Tensor:
        """This rank's one camera's frame from its [1, ...] batch."""
        t = torch.as_tensor(np.asarray(batch), device=self.device)
        if t.shape[0] != 1:
            raise ValueError(f"a rank feeds one camera: got a batch of {t.shape[0]}")
        return t[0] if dtype is None else t[0].to(dtype)

    def step(self, rgb_local, depth_local) -> Tuple[np.ndarray, int]:
        self.state, stats, total = self.step_fn(
            self.state, self._local(rgb_local), self._local(depth_local, torch.float32)
        )
        self.ticks += 1
        return stats.cpu().numpy(), int(total)

    def enable_intermap(self, **kw) -> None:
        """Arm collective inter-map rounds (`parallel.intermap`): every
        camera starts in its own map, and `intermap_round` merges maps when
        cameras recognise each other's places; every rank applies the same
        merge."""
        from densemonoslam_tpu_torch.parallel import intermap

        self._im_round = intermap.make_intermap_round(
            self.mesh, self.intr, self.height, self.width, self.cfg, **kw
        )
        self._im_state = intermap.init_state(self.mesh.cam, self.cfg.num_ferns, device=self.device)

    def intermap_round(self, rgb_local, depth_local):
        """One collective inter-map round with this rank's frame; returns the
        replicated `intermap.MergeInfo` as numpy arrays."""
        if self._im_round is None:
            raise RuntimeError("call enable_intermap() first")
        self.state, self._im_state, info = self._im_round(
            self.state, self._im_state, self._local(rgb_local),
            self._local(depth_local, torch.float32),
        )
        return type(info)(*(v.cpu().numpy() for v in info))

    @property
    def my_cam_slots(self) -> range:
        """The session camera indices this rank feeds."""
        return range(self.process_id, self.process_id + 1)
