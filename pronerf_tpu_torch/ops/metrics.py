"""Image losses & quality metrics: MSE/PSNR (tensors), SSIM (numpy, mip-NeRF
style separable Gaussian), LPIPS (optional, gated on the ``lpips`` package
being installed)."""

from __future__ import annotations

import numpy as np
import torch


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def mse2psnr(mse):
    return -10.0 * torch.log10(mse)


def to8b(x):
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _gaussian_filter(filter_size: int, filter_sigma: float) -> np.ndarray:
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    return filt / np.sum(filt)


def img2ssim(
    img0,
    img1,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    """SSIM between two [H, W, 3] float images (separable Gaussian window,
    'valid' boundary handling, clipped variances: mip-NeRF semantics)."""
    img0 = np.asarray(img0)
    img1 = np.asarray(img1)
    assert img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape
    filt = _gaussian_filter(filter_size, filter_sigma)

    def blur(z):
        # Separable valid-mode convolution along H then W, per channel.
        out = np.apply_along_axis(
            lambda r: np.convolve(r, filt, mode="valid"), 0, z
        )
        out = np.apply_along_axis(
            lambda r: np.convolve(r, filt, mode="valid"), 1, out
        )
        return out

    def filt_fn(z):
        return np.stack([blur(z[..., i]) for i in range(z.shape[-1])], -1)

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = np.maximum(0.0, filt_fn(img0**2) - mu00)
    sigma11 = np.maximum(0.0, filt_fn(img1**2) - mu11)
    sigma01 = filt_fn(img0 * img1) - mu01
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01)
    )
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


_LPIPS_CACHE: dict = {}


def rgb_lpips(np_gt, np_im, net_name: str = "alex"):
    """LPIPS distance between two [H, W, 3] float images in [0, 1].

    Returns None when the optional ``lpips`` package is unavailable.
    """
    try:
        import lpips  # type: ignore
    except ImportError:
        return None
    if net_name not in _LPIPS_CACHE:
        _LPIPS_CACHE[net_name] = lpips.LPIPS(net=net_name, version="0.1").eval()
    net = _LPIPS_CACHE[net_name]
    gt = torch.from_numpy(np.asarray(np_gt, np.float32)).permute(2, 0, 1)
    im = torch.from_numpy(np.asarray(np_im, np.float32)).permute(2, 0, 1)
    with torch.no_grad():
        return float(net(gt, im, normalize=True).item())
