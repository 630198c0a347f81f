"""Evaluation meters, PSNR only (port of sealdnerf_tpu/train/metrics.py).

Same update/measure/report/clear protocol as the reference meters.
"""

import numpy as np


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
