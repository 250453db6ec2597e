from densemonoslam_tpu_torch.io.synthetic import SyntheticSequence, BoxRoomScene, render_frame
from densemonoslam_tpu_torch.io.writers import save_freiburg, save_ply, load_ply

__all__ = [
    "SyntheticSequence",
    "BoxRoomScene",
    "render_frame",
    "save_freiburg",
    "save_ply",
    "load_ply",
]
