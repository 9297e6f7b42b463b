"""Mean k-nearest-neighbour squared distance (scale initialisation for 3DGS).

Port of gsmpm_tpu/models/knn.py, the counterpart of the reference's
simple-knn ``distCUDA2``: blocked brute force, so memory stays O(block * N)
instead of O(N^2); each block's squared distances are one matmul
(|a - b|^2 = |a|^2 + |b|^2 - 2 a.b) and its k + 1 smallest are one
``torch.topk`` (the first is the point itself).
"""

from __future__ import annotations

import torch


def mean_knn_dist(points: torch.Tensor, k: int = 3,
                  block: int = 1024) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the k nearest other
    points (what simple-knn's distCUDA2 returns)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    sq = torch.sum(pts * pts, dim=-1)
    out = []
    for s in range(0, pts.shape[0], block):
        rows = pts[s:s + block]
        d2 = sq[s:s + block, None] + sq[None, :] - 2.0 * (rows @ pts.T)
        d2 = torch.clamp_min(d2, 0.0)
        near = torch.topk(d2, k + 1, dim=1, largest=False).values
        out.append(torch.mean(near[:, 1:], dim=-1))
    return torch.cat(out)
