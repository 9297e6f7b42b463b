"""The system-identification loss, 0.8 L1 + 0.2 (1 - SSIM), in plain torch.

SSIM with the standard 11-tap gaussian window (sigma 1.5), C1 = 0.01^2,
C2 = 0.03^2, zero "same" padding, the variances clamped at 0; the blur is
written as shifted multiply-adds so that it stays in the input's dtype
(a cuDNN convolution would run float32 in TF32).  Images are (H, W, C).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    k = win.shape[0]
    h, w = img.shape[0], img.shape[1]
    x = nnf.pad(img, (0, 0, 0, 0, k // 2, k // 2))
    x = sum(win[i] * x[i:i + h] for i in range(k))
    x = nnf.pad(x, (0, 0, k // 2, k // 2))
    return sum(win[i] * x[:, i:i + w] for i in range(k))


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    win = torch.from_numpy(_window()).to(device=a.device, dtype=a.dtype)
    m1, m2 = _blur(a, win), _blur(b, win)
    m11, m22, m12 = m1 * m1, m2 * m2, m1 * m2
    s1 = torch.clamp_min(_blur(a * a, win) - m11, 0.0)
    s2 = torch.clamp_min(_blur(b * b, win) - m22, 0.0)
    s12 = _blur(a * b, win) - m12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * m12 + c1) * (2 * s12 + c2))
            / ((m11 + m22 + c1) * (s1 + s2 + c2))).mean()


def photometric(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (0.8 * torch.abs(pred - target).mean()
            + 0.2 * (1.0 - ssim(pred, target)))
