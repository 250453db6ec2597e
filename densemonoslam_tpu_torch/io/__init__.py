from densemonoslam_tpu_torch.io.street import StreetScene, StreetSequence, street_trajectory
from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence, BoxRoomScene, render_frame
from densemonoslam_tpu_torch.io.writers import save_freiburg, save_ply, load_ply

__all__ = [
    "StreetScene",
    "StreetSequence",
    "street_trajectory",
    "SyntheticSequence",
    "BoxRoomScene",
    "render_frame",
    "save_freiburg",
    "save_ply",
    "load_ply",
]
