"""The procedural scene that the cells train on, rendered on the device.

A PyTorch copy of the program's hermetic stand-in for NeRF-synthetic
(`data/synthetic.py` with hard=True): three opaque lambertian spheres with
an angular checker texture and a ring of six thin beads (r = 0.04), lit
from one direction, the ground truth from exact ray-sphere intersection,
so it does not depend on the code under test. In a dynamic scene sphere 0
moves on x = 0.125 cos(2 pi t), y = 0.25 sin(2 pi t) over t in [0, 1].

Views orbit the origin as the program's training split does (elevation
pi/2 + 0.35 sin(2.4 i), azimuth 2 pi i / n): every seed trains on the
same views, so that the seed (the weights, the training's draws) does not
change how much work a trained field gives a frame.
"""

import math

import numpy as np
import torch

CENTERS = [[0.0, 0.1, 0.0], [0.35, -0.25, 0.2], [-0.3, -0.2, -0.25]]
RADII = [0.32, 0.18, 0.15]
ALBEDOS = [[0.9, 0.25, 0.2], [0.2, 0.5, 0.9], [0.95, 0.8, 0.2]]
LIGHT = (0.4, 0.8, 0.45)
MOTION = 0.25


def _spheres():
    c, r, a = [list(x) for x in CENTERS], list(RADII), \
        [list(x) for x in ALBEDOS]
    for k in range(6):
        ang = 2 * math.pi * k / 6
        c.append([0.55 * math.cos(ang), 0.45, 0.55 * math.sin(ang)])
        r.append(0.04)
        a.append([0.3 + 0.1 * k, 0.9 - 0.12 * k, 0.5])
    return np.array(c), np.array(r), np.array(a)


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """cam2world [4, 4] on a sphere of `radius`, looking at the origin."""
    center = np.array([radius * np.sin(theta) * np.sin(phi),
                       radius * np.cos(theta),
                       radius * np.sin(theta) * np.cos(phi)])
    forward = -center / np.linalg.norm(center)
    right = np.cross(forward, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, up, forward], axis=-1)
    pose[:3, 3] = center
    return pose


def intrinsics(res: int, fov: float) -> np.ndarray:
    fl = res / (2 * np.tan(fov / 2))
    return np.array([fl, fl, res / 2, res / 2], dtype=np.float32)


def render(pose, intr, h: int, w: int, t: float, dynamic: bool):
    """RGBA [h, w, 4] f32 of the scene at time t, on pose's device."""
    dev = pose.device
    c, r, a = (torch.as_tensor(x, dtype=torch.float32, device=dev)
               for x in _spheres())
    if dynamic:
        c = c.clone()
        c[0, 1] += MOTION * math.sin(2 * math.pi * t)
        c[0, 0] += MOTION * 0.5 * math.cos(2 * math.pi * t)
    jj, ii = torch.meshgrid(torch.arange(h, device=dev) + 0.5,
                            torch.arange(w, device=dev) + 0.5, indexing="ij")
    d = torch.stack([(ii - intr[2]) / intr[0], (jj - intr[3]) / intr[1],
                     torch.ones_like(ii)], -1).reshape(-1, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    rd = d @ pose[:3, :3].t()
    ro = pose[:3, 3]
    oc = ro[None, None] - c[None]                          # [1, S, 3]
    b = (oc * rd[:, None]).sum(-1)                         # [N, S]
    cc = (oc * oc).sum(-1) - r[None] ** 2
    disc = b * b - cc
    th = -b - torch.sqrt(disc.clamp(min=0))
    ok = (disc > 0) & (th > 1e-3)
    th = torch.where(ok, th, torch.full_like(th, float("inf")))
    best, s = th.min(dim=-1)
    hit = torch.isfinite(best)
    p = ro + best.nan_to_num(posinf=0.0)[:, None] * rd
    nrm = (p - c[s]) / r[s][:, None]
    light = (nrm @ torch.tensor(LIGHT, device=dev)).clamp(0.0, 1.0)
    theta = torch.arccos(nrm[:, 1].clamp(-1, 1))
    phi = torch.atan2(nrm[:, 2], nrm[:, 0])
    check = (torch.floor(theta / math.pi * 8)
             + torch.floor((phi / math.pi + 1) * 8)) % 2
    rgb = a[s] * (0.45 + 0.55 * check[:, None]) * (0.35 + 0.65 * light[:, None])
    rgb = torch.where(hit[:, None], rgb, torch.ones_like(rgb))
    return torch.cat([rgb, hit[:, None].float()], -1).reshape(h, w, 4)


def training_views(n: int, res: int, fov: float, radius: float,
                   dynamic: bool, device):
    """(poses [n, 4, 4] numpy, images [n, res, res, 4] on device,
    intrinsics [4] numpy, times [n] numpy or None). Times of a dynamic set
    are i / (n - 1), one view a time (monocular), in ascending order."""
    intr = intrinsics(res, fov)
    poses, times = [], []
    for i in range(n):
        theta = np.pi / 2 + 0.35 * np.sin(i * 2.4)
        poses.append(orbit_pose(theta, 2 * np.pi * i / n, radius))
        times.append(min(i / max(n - 1, 1), 1.0) if dynamic else 0.0)
    intr_t = torch.as_tensor(intr, device=device)
    images = torch.stack([
        render(torch.as_tensor(p, device=device), intr_t, res, res, t,
               dynamic) for p, t in zip(poses, times)])
    return (np.stack(poses), images, intr,
            np.array(times, np.float32) if dynamic else None)
