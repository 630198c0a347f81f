"""Evaluation meters: PSNR, SSIM and LPIPS (port of
sealdnerf_tpu/train/metrics.py), with the reference's
update/measure/report/clear protocol.

SSIM is the Gaussian-window formulation (11 taps, sigma 1.5, "valid"
filtering, f64), through torch's conv2d. LPIPS needs the `lpips` package and
pretrained weights: the meter is available only when the package and every
weight file it would load already lie on the local disk, which is checked
before the network is built, so that nothing is ever downloaded. Otherwise
it is disabled and reports "unavailable".
"""

import importlib.util
import os

import numpy as np
import torch


class _MeterBase:
    def __init__(self):
        self.v = 0.0
        self.n = 0

    def clear(self):
        self.v, self.n = 0.0, 0

    def measure(self):
        return self.v / max(self.n, 1)

    def report(self):
        return f"{self.name} = {self.measure():.6f}"


def psnr(preds, truths) -> float:
    preds = np.asarray(preds, dtype=np.float32)
    truths = np.asarray(truths, dtype=np.float32)
    mse = float(np.mean((preds - truths) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


class PSNRMeter(_MeterBase):
    name = "PSNR"

    def update(self, preds, truths):
        self.v += psnr(preds, truths)
        self.n += 1


def _gaussian_window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.from_numpy(np.outer(g, g))


def ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01,
         k2=0.03) -> float:
    """Gaussian-window SSIM of two [H, W, C] (or [H, W]) images, the mean
    over the "valid" window positions and the channels."""
    a = torch.as_tensor(np.asarray(img0), dtype=torch.float64)
    b = torch.as_tensor(np.asarray(img1), dtype=torch.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    win = _gaussian_window(filter_size, filter_sigma)[None, None]

    def filt(x):                         # [H, W, C] -> [C, H', W']
        return torch.nn.functional.conv2d(x.permute(2, 0, 1)[:, None],
                                          win)[:, 0]

    mu0, mu1 = filt(a), filt(b)
    s00 = filt(a * a) - mu0 ** 2
    s11 = filt(b * b) - mu1 ** 2
    s01 = filt(a * b) - mu0 * mu1
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    return float((num / den).mean())


class SSIMMeter(_MeterBase):
    name = "SSIM"

    def update(self, preds, truths):
        self.v += ssim(preds, truths)
        self.n += 1


# the backbone weights that lpips.LPIPS(net=...) has torchvision load
_LPIPS_BACKBONES = {"alex": "alexnet-owt-7be5be79.pth",
                    "vgg": "vgg16-397923af.pth",
                    "squeeze": "squeezenet1_1-b8a52dc0.pth"}


def lpips_weight_files(net: str = "alex"):
    """The weight files LPIPS(net) would load: its linear heads from the
    package and the backbone from torch hub's cache. None when the `lpips`
    package is not installed."""
    spec = importlib.util.find_spec("lpips")
    if spec is None or spec.origin is None:
        return None
    heads = os.path.join(os.path.dirname(spec.origin), "weights", "v0.1",
                         f"{net}.pth")
    backbone = os.path.join(torch.hub.get_dir(), "checkpoints",
                            _LPIPS_BACKBONES.get(net, ""))
    return [heads, backbone]


class LPIPSMeter(_MeterBase):
    """LPIPS(net) on the CPU. Disabled (available False, measure() 0,
    report() "unavailable") unless the lpips package and every weight file
    it would load are on the local disk."""

    def __init__(self, net="alex"):
        super().__init__()
        self.name = f"LPIPS ({net})"
        self.available = False
        self._fn = None
        files = lpips_weight_files(net)
        if files is None or not all(os.path.isfile(f) for f in files):
            return
        try:
            import lpips
            self._fn = lpips.LPIPS(net=net, verbose=False).eval()
            self.available = True
        except Exception:
            self._fn = None

    def update(self, preds, truths):
        if not self.available:
            return

        def nchw(x):
            return torch.from_numpy(np.asarray(x, dtype=np.float32)).permute(
                2, 0, 1)[None]
        with torch.no_grad():
            self.v += float(self._fn(nchw(preds) * 2 - 1,
                                     nchw(truths) * 2 - 1))
        self.n += 1

    def report(self):
        if not self.available:
            return f"{self.name} unavailable (no pretrained weights)"
        return super().report()
