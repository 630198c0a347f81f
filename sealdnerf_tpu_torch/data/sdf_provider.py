"""SDF dataset: training points drawn from a mesh (port of
sealdnerf_tpu/data/sdf_provider.py).

The mesh (PLY through utils/meshing.load_ply, or OBJ) is normalised into
[-1, 1]: centred on its box, scaled so that the box's diagonal is 2 x 0.95.
A batch of n points is 7/8 surface points, drawn by triangle area with
uniform barycentrics, the second half of them moved by N(0, 0.01^2), and
1/8 uniform points in the cube. The exact surface half has sdf 0; the rest
is queried against the mesh with native/mesher.cpp's BVH SignedDistance
(positive inside, as pysdf), and the stored sdf is minus the query. Every
draw comes from np.random.default_rng(seed) in the reference's order, so a
seed gives both packages the same points bit for bit.

The BVH comes from the port's own build of the mesher (utils/meshing.py);
a failed build raises. Its query releases the interpreter lock, so the
points are split over up to QUERY_THREADS host threads; each point's value
is the one a single thread gives. editing/geometry.points_mesh_distance and
points_in_mesh are the plain version the tests hold it against.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.meshing import load_mesher, load_ply


QUERY_THREADS = min(8, os.cpu_count() or 1)


def load_mesh(path):
    """(verts [V, 3] f32, faces [F, 3] i32) from a binary .ply or an ascii
    .obj (the first three indices of each face)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply(path)
    if ext == ".obj":
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(v) for v in line.split()[1:4]])
                elif line.startswith("f "):
                    faces.append([int(t.split("/")[0]) - 1
                                  for t in line.split()[1:4]])
        return (np.asarray(verts, dtype=np.float32),
                np.asarray(faces, dtype=np.int32))
    raise ValueError(f"unsupported mesh format: {ext}")


def _tri_areas(verts, faces):
    a, b, c = (verts[faces[:, i]] for i in range(3))
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


class SDFDataset:
    def __init__(self, path, size: int = 100, num_samples: int = 2 ** 18,
                 clip_sdf=None, seed: int = 0):
        if num_samples % 8 != 0:
            raise ValueError(f"num_samples must be a multiple of 8, got "
                             f"{num_samples}")
        verts, faces = load_mesh(path)
        vmin, vmax = verts.min(0), verts.max(0)
        center = (vmin + vmax) / 2
        scale = 2.0 / np.sqrt(np.sum((vmax - vmin) ** 2)) * 0.95
        self.verts = ((verts - center) * scale).astype(np.float32)
        self.faces = faces
        self.areas = _tri_areas(self.verts, self.faces)
        self.area_p = self.areas / self.areas.sum()
        self.num_samples = num_samples
        self.clip_sdf = clip_sdf
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.bvh = load_mesher().SignedDistance(
            np.ascontiguousarray(self.verts, dtype=np.float32),
            np.ascontiguousarray(self.faces, dtype=np.int32))

    def query(self, pts, threads: int = QUERY_THREADS):
        """Signed distance of points [P, 3] to the mesh, positive inside
        (the BVH, on `threads` host threads) -> f32 [P]."""
        parts = np.array_split(np.ascontiguousarray(pts, dtype=np.float32),
                               max(1, threads))
        with ThreadPoolExecutor(len(parts)) as pool:
            return np.concatenate(list(pool.map(self.bvh.query, parts)))

    def sample_surface(self, n: int):
        fi = self.rng.choice(len(self.faces), n, p=self.area_p)
        u = self.rng.random((n, 1))
        v = self.rng.random((n, 1))
        flip = (u + v) > 1
        u = np.where(flip, 1 - u, u)
        v = np.where(flip, 1 - v, v)
        a, b, c = (self.verts[self.faces[fi, i]] for i in range(3))
        return a + u * (b - a) + v * (c - a)

    def __len__(self):
        return self.size

    def sample_batch(self):
        """-> {"points": f32 [n, 3], "sdfs": f32 [n, 1]} (numpy)."""
        n = self.num_samples
        surf = self.sample_surface(n * 7 // 8).astype(np.float32)
        surf[n // 2:] += 0.01 * self.rng.standard_normal(
            (surf[n // 2:].shape[0], 3))
        uniform = (self.rng.random((n // 8, 3)) * 2 - 1).astype(np.float32)
        points = np.concatenate([surf, uniform], axis=0).astype(np.float32)
        sdfs = np.zeros((n, 1), dtype=np.float32)
        sdfs[n // 2:, 0] = -self.query(points[n // 2:])
        if self.clip_sdf is not None:
            sdfs = sdfs.clip(-self.clip_sdf, self.clip_sdf)
        return {"points": points, "sdfs": sdfs}

    def __getitem__(self, _):
        return self.sample_batch()
