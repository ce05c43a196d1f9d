"""SSIM — the golden-frame comparison metric (BASELINE.md fidelity
target: SSIM >= 0.98 vs golden frames). Pure NumPy, gaussian-windowed
per the standard formulation."""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size=11, sigma=1.5):
    """The 1-D factor of the normalised 2-D gaussian window: the window is
    its outer product with itself."""
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax**2) / (2 * sigma**2))
    return k / k.sum()


def _filter2(img, kernel):
    """Valid-mode 2D convolution with the separable window: the rows,
    then the columns."""
    n = kernel.shape[0]
    h, w = img.shape
    rows = np.zeros((h, w - n + 1), np.float64)
    for dx in range(n):
        rows += kernel[dx] * img[:, dx : dx + w - n + 1]
    out = np.zeros((h - n + 1, w - n + 1), np.float64)
    for dy in range(n):
        out += kernel[dy] * rows[dy : dy + h - n + 1]
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM over channels. a, b: (H, W) or (H, W, C) arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(
            np.mean([ssim(a[..., c], b[..., c], data_range) for c in range(a.shape[-1])])
        )
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sig_aa = _filter2(a * a, k) - mu_aa
    sig_bb = _filter2(b * b, k) - mu_bb
    sig_ab = _filter2(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sig_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sig_aa + sig_bb + c2)
    return float(np.mean(num / den))
