from densemonoslam_tpu_torch.io.camera_manager import (
    LogCamera,
    MultiLogCameraManager,
    MultiMixedCameraManager,
    make_camera_manager,
    run_session,
)
from densemonoslam_tpu_torch.io.datasets import (
    GroundTruthClusters,
    GroundTruthOdometry,
    IclNuimReader,
    KittiOdometryReader,
    TumRgbdReader,
    load_freiburg_trajectory,
)
from densemonoslam_tpu_torch.io.klg import KlgReader, write_klg
from densemonoslam_tpu_torch.io.stream import FrameReceiver, FrameSender, StreamCameraManager
from densemonoslam_tpu_torch.io.street import StreetScene, StreetSequence, street_trajectory
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence, BoxRoomScene, render_frame
from densemonoslam_tpu_torch.io.writers import save_freiburg, save_ply, load_ply, png_bytes

__all__ = [
    "LogCamera",
    "MultiLogCameraManager",
    "MultiMixedCameraManager",
    "make_camera_manager",
    "run_session",
    "GroundTruthClusters",
    "GroundTruthOdometry",
    "IclNuimReader",
    "KittiOdometryReader",
    "TumRgbdReader",
    "load_freiburg_trajectory",
    "KlgReader",
    "write_klg",
    "FrameReceiver",
    "FrameSender",
    "StreamCameraManager",
    "StreetScene",
    "StreetSequence",
    "street_trajectory",
    "SyntheticSequence",
    "BoxRoomScene",
    "render_frame",
    "save_freiburg",
    "save_ply",
    "load_ply",
    "png_bytes",
]
