"""Joint histograms + Normalised Information Distance (port of
`densemonoslam_tpu.ops.histogram`).

Both joint histograms are one `scatter_add_` of ones over flattened bin pairs
(the reference package used a one-hot matmul for the 64-bin image histogram
and a scatter-add for the 500-bin depth one).  The counts are integers below
2^24, so the f32 sums are exact in any order.  (`torch.bincount` would read
its input's maximum back to the host.)

NID(A,B) = (H(A,B) - I(A;B)) / H(A,B), in [0, 1]; 0 = identical signals.
"""

from __future__ import annotations

import torch


def _entropy(p: torch.Tensor) -> torch.Tensor:
    p = p / torch.clamp(torch.sum(p), min=1e-12)
    return -torch.sum(torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-12)), 0.0))


def nid_from_joint(joint: torch.Tensor) -> torch.Tensor:
    """Joint histogram [B, B] -> NID scalar."""
    total = torch.sum(joint)
    h_ab = _entropy(joint)
    mi = _entropy(joint.sum(dim=1)) + _entropy(joint.sum(dim=0)) - h_ab
    nid = torch.where(h_ab > 1e-9, (h_ab - mi) / torch.clamp(h_ab, min=1e-9), 0.0)
    # no overlap at all -> maximally distant
    return torch.where(total > 0, torch.clamp(nid, 0.0, 1.0), 1.0)


def joint_histogram(
    a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, bins: int, vmax: float
) -> torch.Tensor:
    """[P] signals -> [bins, bins] f32 joint histogram of the `valid` pairs."""
    scale = bins / vmax
    ia = torch.clamp((a * scale).to(torch.int64), 0, bins - 1)
    ib = torch.clamp((b * scale).to(torch.int64), 0, bins - 1)
    flat = torch.where(valid, ia * bins + ib, bins * bins)  # dump slot
    hist = torch.zeros(bins * bins + 1, dtype=torch.float32, device=a.device)
    hist.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    return hist[: bins * bins].reshape(bins, bins)


def nid_image(img_a: torch.Tensor, img_b: torch.Tensor, valid: torch.Tensor, bins: int = 64):
    """NID between two intensity images (0..255), counting `valid` pixels."""
    return nid_from_joint(
        joint_histogram(img_a.reshape(-1), img_b.reshape(-1), valid.reshape(-1), bins, 256.0)
    )


def nid_depth(d_a, d_b, valid, depth_max: float, bins: int = 500):
    """NID between two metric depth maps, `bins` bins over [0, depth_max]."""
    return nid_from_joint(
        joint_histogram(d_a.reshape(-1), d_b.reshape(-1), valid.reshape(-1), bins, depth_max)
    )
