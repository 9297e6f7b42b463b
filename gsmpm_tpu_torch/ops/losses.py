"""Image losses: L1 and SSIM.

Port of gsmpm_tpu/ops/losses.py: the system-identification loss
0.8 * L1 + 0.2 * (1 - SSIM), SSIM with the standard 11-tap gaussian window
(sigma 1.5), C1 = 0.01^2, C2 = 0.03^2, as a separable depthwise
convolution with zero "same" padding.  Images are (H, W, C).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target).mean()


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur of (H, W, C) with zero same padding: along
    H, then along W, each a depthwise convolution written as k shifted
    multiply-adds.  Written out rather than ``conv2d``, whose forward and
    backward cuDNN would run in TF32 on the GPU: this keeps float32, as
    the JAX package's loss."""
    k = win.shape[0]
    h, w = img.shape[0], img.shape[1]
    x = nnf.pad(img, (0, 0, 0, 0, k // 2, k // 2))
    x = sum(win[i] * x[i:i + h] for i in range(k))
    x = nnf.pad(x, (0, 0, k // 2, k // 2))
    return sum(win[i] * x[:, i:i + w] for i in range(k))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair in [0, 1]."""
    win = torch.from_numpy(_gaussian_window(window_size)).to(img1.device)
    mu1 = _filter2d(img1, win)
    mu2 = _filter2d(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # variance estimates clamped at 0 (filter round-off can make them
    # negative, which lets ssim exceed 1 on near-constant regions)
    sigma1_sq = torch.clamp_min(_filter2d(img1 * img1, win) - mu1_sq, 0.0)
    sigma2_sq = torch.clamp_min(_filter2d(img2 * img2, win) - mu2_sq, 0.0)
    sigma12 = _filter2d(img1 * img2, win) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()


def photometric_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.8 L1 + 0.2 (1 - SSIM)."""
    return 0.8 * l1_loss(pred, target) + 0.2 * (1.0 - ssim(pred, target))


def photometric_loss_as_committed(pred: torch.Tensor,
                                  target: torch.Tensor) -> torch.Tensor:
    """0.8 L1 + 0.2 SSIM, the sign the reference trainer committed."""
    return 0.8 * l1_loss(pred, target) + 0.2 * ssim(pred, target)
