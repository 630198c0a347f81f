"""Mesh extraction: density field -> triangle mesh -> PLY (port of
sealdnerf_tpu/utils/meshing.py, with its own build of the native mesher).

The density sweep runs on the trainer's device, in slabs of whole x planes
(up to 2^22 points a query). Marching tetrahedra comes from the repository's
native/mesher.cpp (a CPython extension), which this module compiles with g++
into the package's gitignored build directory,
sealdnerf_tpu_torch/_build/mesher-<hash>/, keyed by a hash of the source, the
flags and the interpreter, and loads from there; it never writes beside the
source. A failed build raises with the compiler's output.
"""

import functools
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

import numpy as np
import torch

MESHER_SRC = Path(__file__).resolve().parents[2] / "native" / "mesher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
MODULE = "_sealdnerf_native"          # the name mesher.cpp's PyInit carries
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SWEEP_POINTS = 1 << 22                # points of one density query


def _build_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(sys.version.encode())
    h.update(np.__version__.encode())
    h.update(MESHER_SRC.read_bytes())
    return h.hexdigest()[:16]


def build_mesher() -> Path:
    """Compile native/mesher.cpp into the build directory (once per hash)
    and return the extension's path."""
    out_dir = BUILD_DIR / f"mesher-{_build_hash()}"
    so = out_dir / f"{MODULE}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{MODULE}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
           f"-I{np.get_include()}", str(MESHER_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {MESHER_SRC.name}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (code {res.returncode}) on "
                           f"{MESHER_SRC}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_mesher():
    """The mesher extension, built if needed."""
    spec = importlib.util.spec_from_file_location(MODULE, build_mesher())
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def extract_fields(bound_min, bound_max, resolution: int, query_func,
                   device="cpu"):
    """The density on a resolution^3 grid of the box (the reference's
    np.linspace points, 'ij' order) -> f32 numpy [R, R, R]. query_func
    takes points [N, 3] on `device` and returns sigma [N]; it is called on
    slabs of whole x planes, up to SWEEP_POINTS points each."""
    axes = [torch.from_numpy(np.linspace(bound_min[i], bound_max[i],
                                         resolution, dtype=np.float32)
                             ).to(device) for i in range(3)]
    gy, gz = torch.meshgrid(axes[1], axes[2], indexing="ij")
    yz = torch.stack([gy.reshape(-1), gz.reshape(-1)], -1)     # [R^2, 2]
    slab = max(1, SWEEP_POINTS // (resolution * resolution))
    out = []
    with torch.no_grad():
        for x0 in range(0, resolution, slab):
            xs = axes[0][x0:x0 + slab]
            pts = torch.cat([xs.repeat_interleave(yz.shape[0])[:, None],
                             yz.repeat(xs.shape[0], 1)], -1)
            out.append(query_func(pts).float().reshape(-1))
    return torch.cat(out).reshape((resolution,) * 3).cpu().numpy()


def marching_tetrahedra(field, threshold: float, bound_min, bound_max):
    """The iso-surface of a [R, R, R] field at threshold, through the native
    mesher -> (verts [N, 3] f32 in world coordinates, tris [M, 3] i32)."""
    field = np.ascontiguousarray(field, dtype=np.float32)
    verts, tris = load_mesher().marching_tetrahedra(field, float(threshold))
    bmin = np.asarray(bound_min, dtype=np.float32)
    scale = ((np.asarray(bound_max) - np.asarray(bound_min))
             / (field.shape[0] - 1)).astype(np.float32)
    return verts * scale[None] + bmin[None], tris


def extract_geometry(bound_min, bound_max, resolution: int,
                     threshold: float, query_func, device="cpu"):
    """extract_fields, then marching_tetrahedra -> (verts, tris)."""
    field = extract_fields(bound_min, bound_max, resolution, query_func,
                           device)
    return marching_tetrahedra(field, threshold, bound_min, bound_max)


def save_ply(path, verts, tris):
    """Binary little-endian PLY writer."""
    verts = np.asarray(verts, dtype=np.float32)
    tris = np.asarray(tris, dtype=np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(tris)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(verts.astype("<f4").tobytes())
        face = np.empty((len(tris), 13), dtype=np.uint8)
        face[:, 0] = 3
        face[:, 1:] = tris.astype("<i4").view(np.uint8).reshape(len(tris), 12)
        f.write(face.tobytes())


def load_ply(path):
    """Minimal binary PLY reader -> (verts [N, 3] f32, tris [M, 3] i32)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        nv = int([l for l in header if l.startswith("element vertex")][0]
                 .split()[-1])
        nf = int([l for l in header if l.startswith("element face")][0]
                 .split()[-1])
        verts = np.frombuffer(f.read(nv * 12), dtype="<f4").reshape(nv, 3)
        raw = np.frombuffer(f.read(nf * 13), dtype=np.uint8).reshape(nf, 13)
        tris = raw[:, 1:].copy().view("<i4").reshape(nf, 3)
    return verts.copy(), tris
