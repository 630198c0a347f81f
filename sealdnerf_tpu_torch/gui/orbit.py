"""Orbit camera of the GUI (port of sealdnerf_tpu/gui/orbit.py, the
reference viewer's nerf/gui.py:10-52; numpy and scipy only)."""

import numpy as np
from scipy.spatial.transform import Rotation


class OrbitCamera:
    def __init__(self, w: int, h: int, r: float = 2.0, fovy: float = 60.0):
        self.W = w
        self.H = h
        self.radius = r
        self.fovy = fovy
        self.center = np.array([0.0, 0.0, 0.0], dtype=np.float32)
        self.rot = Rotation.from_quat([1, 0, 0, 0])
        self.up = np.array([0.0, 1.0, 0.0], dtype=np.float32)

    @property
    def pose(self) -> np.ndarray:
        """cam2world [4, 4]."""
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(np.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2],
                        dtype=np.float32)

    def orbit(self, dx: float, dy: float):
        # rotate along camera up/side axes (nerf/gui.py:33-40)
        side = self.rot.as_matrix()[:3, 0]
        rotvec_x = self.up * np.radians(-0.1 * dx)
        rotvec_y = side * np.radians(-0.1 * dy)
        self.rot = Rotation.from_rotvec(rotvec_x) * \
            Rotation.from_rotvec(rotvec_y) * self.rot

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 0.0005 * self.rot.as_matrix()[:3, :3] @ \
            np.array([dx, dy, dz], dtype=np.float32)
