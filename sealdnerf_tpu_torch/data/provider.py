"""NeRF dataset provider, transforms.json format (numpy port of
sealdnerf_tpu/data/provider.py).

- blender (transforms_train/val/test.json) vs colmap (transforms.json)
  auto-detect, 'all'/'trainval' split merging, colmap first-frame val split
  and slerp-interpolated test poses.
- nerf_matrix_to_ngp pose-convention swap.
- alpha-channel images kept as RGBA; intrinsics from fl_x/fl_y or
  camera_angle_x/y; downscale support.

Host-side numpy; `NeRFDataset.device` puts the training data on a torch
device. cv2 is imported only when an image file is read.

Time values (D-NeRF datasets): per-frame `time` field if present, else the
frame index normalized to [0, 1].
"""

import glob
import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """Pose convention swap (reference nerf/provider.py:19-27)."""
    return np.array([
        [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
        [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
        [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
        [0, 0, 0, 1],
    ], dtype=np.float32)


def _load_image(path, downscale, h, w):
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    else:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    if h is None:
        h, w = img.shape[0] // downscale, img.shape[1] // downscale
    if img.shape[0] != h or img.shape[1] != w:
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    return img.astype(np.float32) / 255.0, h, w


@dataclass
class NeRFDataset:
    """Host-side dataset; fields are numpy."""

    poses: np.ndarray              # [B, 4, 4] float32, ngp convention
    images: Optional[np.ndarray]   # [B, H, W, 3/4] float32 or None
    intrinsics: np.ndarray         # [4] (fx, fy, cx, cy)
    h: int
    w: int
    times: Optional[np.ndarray] = None   # [B] float32 in [0, 1] (dynamic sets)
    error_map: Optional[np.ndarray] = None  # [B, 128*128]
    mode: str = "blender"

    @property
    def radius(self) -> float:
        return float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())

    def __len__(self):
        return self.poses.shape[0]

    def device(self, torch_device):
        """Put the training data on `torch_device` once: images as
        [n, h*w, c] f32, poses [n, 4, 4] and intrinsics [4]. This is the
        reference's preload mode; its host-resident batches (--no_preload)
        are not ported."""
        import torch
        if self.images is None:
            raise ValueError("the dataset has no images to train on")
        n = len(self)
        out = {
            "images": torch.as_tensor(
                np.ascontiguousarray(self.images, dtype=np.float32).reshape(
                    n, self.h * self.w, -1), device=torch_device),
            "poses": torch.as_tensor(self.poses, dtype=torch.float32,
                                     device=torch_device),
            "intrinsics": torch.as_tensor(self.intrinsics,
                                          dtype=torch.float32,
                                          device=torch_device),
        }
        return out

    @classmethod
    def load(cls, root_path: str, split: str = "train", downscale: int = 1,
             scale: float = 0.33, offset=(0, 0, 0), n_test: int = 10,
             error_map: bool = False, with_time: bool = False):
        """split: train | val | test | all | trainval."""
        if os.path.exists(os.path.join(root_path, "transforms.json")):
            mode = "colmap"
            with open(os.path.join(root_path, "transforms.json")) as f:
                transform = json.load(f)
        elif os.path.exists(os.path.join(root_path, "transforms_train.json")):
            mode = "blender"
            if split == "all":
                transform = None
                for p in sorted(glob.glob(os.path.join(root_path, "*.json"))):
                    with open(p) as f:
                        t = json.load(f)
                    if transform is None:
                        transform = t
                    else:
                        transform["frames"].extend(t["frames"])
            elif split == "trainval":
                with open(os.path.join(root_path, "transforms_train.json")) as f:
                    transform = json.load(f)
                with open(os.path.join(root_path, "transforms_val.json")) as f:
                    transform["frames"].extend(json.load(f)["frames"])
            else:
                with open(os.path.join(root_path, f"transforms_{split}.json")) as f:
                    transform = json.load(f)
        else:
            raise FileNotFoundError(
                f"Cannot find transforms*.json under {root_path}")

        h = int(transform["h"]) // downscale if "h" in transform else None
        w = int(transform["w"]) // downscale if "w" in transform else None
        frames = transform["frames"]

        poses, images, times = [], [], []
        if mode == "colmap" and split == "test":
            # slerp-interpolate a test trajectory between two random poses
            # (nerf/provider.py:166-183).
            from scipy.spatial.transform import Rotation, Slerp
            idx = np.random.choice(len(frames), 2, replace=False)
            p0 = nerf_matrix_to_ngp(
                np.array(frames[idx[0]]["transform_matrix"], dtype=np.float32),
                scale, offset)
            p1 = nerf_matrix_to_ngp(
                np.array(frames[idx[1]]["transform_matrix"], dtype=np.float32),
                scale, offset)
            rots = Rotation.from_matrix(np.stack([p0[:3, :3], p1[:3, :3]]))
            slerp = Slerp([0, 1], rots)
            for i in range(n_test + 1):
                ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = slerp(ratio).as_matrix()
                pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
                poses.append(pose)
                times.append(ratio if with_time else 0.0)
            images = None
            if h is None:
                img, h, w = _load_image(
                    os.path.join(root_path, frames[0]["file_path"]), downscale,
                    h, w)
        else:
            if mode == "colmap":
                if split == "train":
                    frames = frames[1:]
                elif split == "val":
                    frames = frames[:1]
            for fi, f in enumerate(frames):
                fp = os.path.join(root_path, f["file_path"])
                if mode == "blender" and "." not in os.path.basename(fp):
                    fp += ".png"
                if not os.path.exists(fp):
                    continue
                pose = nerf_matrix_to_ngp(
                    np.array(f["transform_matrix"], dtype=np.float32), scale,
                    offset)
                img, h, w = _load_image(fp, downscale, h, w)
                poses.append(pose)
                images.append(img)
                if "time" in f:
                    times.append(float(f["time"]))
                else:
                    times.append(fi / max(len(frames) - 1, 1))
            images = np.stack(images, axis=0) if images else None

        poses = np.stack(poses, axis=0)
        times_arr = np.array(times, dtype=np.float32) if with_time else None

        # intrinsics (nerf/provider.py:259-274)
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = (w / (2 * np.tan(transform["camera_angle_x"] / 2))
                    if "camera_angle_x" in transform else None)
            fl_y = (h / (2 * np.tan(transform["camera_angle_y"] / 2))
                    if "camera_angle_y" in transform else None)
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("Failed to load focal length from transforms")
        cx = transform.get("cx", w / 2) / (downscale if "cx" in transform else 1)
        cy = transform.get("cy", h / 2) / (downscale if "cy" in transform else 1)
        intrinsics = np.array([fl_x, fl_y, cx, cy], dtype=np.float32)

        emap = (np.ones([poses.shape[0], 128 * 128], dtype=np.float32)
                if (error_map and images is not None and split in
                    ("train", "all", "trainval")) else None)

        return cls(poses=poses, images=images, intrinsics=intrinsics, h=h,
                   w=w, times=times_arr, error_map=emap, mode=mode)
