"""Geometry of the seal mappers (port of sealdnerf_tpu/editing/geometry.py).

Host side, numpy and scipy, run once when a mapper is built from its config:
oriented_bounding_box (PCA box), plane_best_fit (least-squares plane),
uv_sphere_points, extruded_surface_mesh (Delaunay in the best-fit plane,
extruded along the normal), box_mesh, aabb_mesh and mesh_triangles.

Sample side, torch, run on the samples of a render or of a point query:
moller_trumbore (the batched any-hit ray-triangle test), points_in_mesh (hit
in both directions along one fixed direction, trimesh's contains_points
test, with the direction's triple products taken per face), project_points, points_mesh_distance (closed-form point-triangle
distance) and mesh_surface_points_mask. They broadcast [N, F] (and
moller_trumbore and points_mesh_distance [N, F, 3]) over points and faces:
callers bound N (see SealMapper.map_to_origin_compact).
"""

import numpy as np
import torch

_BOX_FACES = np.array([
    [0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
    [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
    [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0],
], dtype=np.int32)


def box_mesh(verts8):
    """8 corner verts (bottom loop, then top loop) -> (verts, faces)."""
    return np.asarray(verts8, dtype=np.float32), _BOX_FACES.copy()


def aabb_mesh(bmin, bmax):
    bmin, bmax = np.asarray(bmin), np.asarray(bmax)
    corners = np.array([
        [bmin[0], bmin[1], bmin[2]], [bmax[0], bmin[1], bmin[2]],
        [bmax[0], bmax[1], bmin[2]], [bmin[0], bmax[1], bmin[2]],
        [bmin[0], bmin[1], bmax[2]], [bmax[0], bmin[1], bmax[2]],
        [bmax[0], bmax[1], bmax[2]], [bmin[0], bmax[1], bmax[2]],
    ], dtype=np.float32)
    return box_mesh(corners)


def oriented_bounding_box(points):
    """PCA oriented bounding box -> (verts [8, 3], faces [12, 3], rotation
    [3, 3] (local -> world), center [3], extents [3])."""
    pts = np.asarray(points, dtype=np.float64)
    center0 = pts.mean(0)
    cov = np.cov((pts - center0).T) if len(pts) > 1 else np.eye(3)
    _, rot = np.linalg.eigh(cov + 1e-12 * np.eye(3))   # columns are axes
    local = (pts - center0) @ rot
    lmin, lmax = local.min(0), local.max(0)
    extents = lmax - lmin
    center = center0 + rot @ ((lmin + lmax) / 2)
    signs = np.array([
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
    ], dtype=np.float64)
    verts = center + (signs * extents / 2) @ rot.T
    return (verts.astype(np.float32), _BOX_FACES.copy(),
            rot.astype(np.float32), center.astype(np.float32),
            extents.astype(np.float32))


def plane_best_fit(points):
    """Least-squares plane -> (point [3], unit normal [3])."""
    pts = np.asarray(points, dtype=np.float64)
    c = pts.mean(0)
    _, _, vh = np.linalg.svd(pts - c, full_matrices=False)
    n = vh[-1]
    return c.astype(np.float32), (n / np.linalg.norm(n)).astype(np.float32)


def uv_sphere_points(radius: float, n_theta: int = 12, n_phi: int = 24):
    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pts = radius * np.stack([
        np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)
    ], axis=-1).reshape(-1, 3)
    return pts.astype(np.float32)


def extruded_surface_mesh(points, normal, growth=(-0.3, 2.0)):
    """The brush's 'curve' mesh: the painted points Delaunay-triangulated in
    their best-fit plane and extruded along `normal` from growth[0] to
    growth[1] times it."""
    from scipy.spatial import Delaunay
    pts = np.asarray(points, dtype=np.float64)
    n = np.asarray(normal, dtype=np.float64)
    n_unit = n / (np.linalg.norm(n) + 1e-12)
    a = np.array([1.0, 0, 0]) if abs(n_unit[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(n_unit, a)
    u /= np.linalg.norm(u)
    v = np.cross(n_unit, u)
    tri = Delaunay(np.stack([pts @ u, pts @ v], axis=-1))
    faces2d = tri.simplices
    nv = len(pts)
    verts = np.concatenate([pts + growth[0] * n, pts + growth[1] * n])
    faces = [faces2d, faces2d[:, ::-1] + nv]
    for e0, e1 in tri.convex_hull:              # side walls
        faces.append(np.array([[e0, e1, e1 + nv], [e0, e1 + nv, e0 + nv]]))
    faces = np.concatenate([np.asarray(f).reshape(-1, 3) for f in faces])
    return verts.astype(np.float32), faces.astype(np.int32)


def mesh_triangles(verts, faces):
    """-> [F, 3, 3] float32 triangles (the sample side's representation)."""
    return np.asarray(verts, dtype=np.float32)[np.asarray(faces)]


# ---------------------------------------------------------------- samples

# the fixed test direction of trimesh.Trimesh.contains_points
DEFAULT_TEST_DIR = (0.4395064455, 0.617598629942, 0.652231566745)


def _dot(a, b):
    """Sum over the last axis of a * b (b broadcast)."""
    return (a * b).sum(dim=-1)


def moller_trumbore(ray_o, ray_d, tris, eps: float = 1e-8):
    """Batched any-hit ray-triangle test. ray_o, ray_d: [N, 3]; tris:
    [F, 3, 3]. Returns bool [N]."""
    e1 = tris[:, 1] - tris[:, 0]                       # [F, 3]
    e2 = tris[:, 2] - tris[:, 0]
    n = torch.cross(e1, e2, dim=-1)
    invdet = 1.0 / -(ray_d @ n.t() + eps)              # [N, F]
    a0 = ray_o[:, None] - tris[None, :, 0]             # [N, F, 3]
    da0 = torch.cross(a0, ray_d[:, None].expand_as(a0), dim=-1)
    u = _dot(da0, e2[None]) * invdet
    v = -_dot(da0, e1[None]) * invdet
    t = _dot(a0, n[None]) * invdet
    hit = (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & ((u + v) <= 1.0)
    return hit.any(dim=1)


def _hits_along(points, d, tris, eps: float = 1e-8):
    """moller_trumbore for rays from every point along one direction d [3].
    With d shared, its triple products reassociate to per-face vectors,
    (a0 x d) . e = a0 . (d x e), so that u, v and t are three [P, 3] x
    [3, F] products with no [P, F, 3] temporary."""
    v0 = tris[:, 0]
    e1, e2 = tris[:, 1] - v0, tris[:, 2] - v0
    n = torch.cross(e1, e2, dim=-1)
    dd = d.expand_as(e1)
    invdet = 1.0 / -(n @ d + eps)                        # [F]

    def along(c):                                        # a0 . c [P, F]
        return points @ c.t() - (v0 * c).sum(dim=-1)

    u = along(torch.cross(dd, e2, dim=-1)) * invdet
    v = -along(torch.cross(dd, e1, dim=-1)) * invdet
    t = along(n) * invdet
    return ((t >= 0.0) & (u >= 0.0) & (v >= 0.0) & ((u + v) <= 1.0)).any(1)


def points_in_mesh(points, tris, test_dir=None):
    """Hit in both directions along test_dir (default DEFAULT_TEST_DIR).
    points [P, 3], tris [F, 3, 3] -> bool [P]."""
    d = DEFAULT_TEST_DIR if test_dir is None else test_dir
    d = torch.as_tensor(d, dtype=points.dtype,
                        device=points.device).reshape(3)
    return _hits_along(points, d, tris) & _hits_along(points, -d, tris)


def project_points(plane_norm, plane_point, target_points):
    """Project points [N, 3] onto the plane."""
    dev, dt = target_points.device, target_points.dtype
    n = torch.as_tensor(plane_norm, dtype=dt, device=dev).reshape(3)
    v = target_points - torch.as_tensor(plane_point, dtype=dt,
                                        device=dev).reshape(3)
    return target_points - (v @ n)[..., None] / (n @ n) * n


def points_mesh_distance(points, tris):
    """Least distance from each point [P, 3] to the triangles [F, 3, 3]."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]      # [F, 3]
    p = points[:, None, :]                             # [P, 1, 3]
    ab, ac = b - a, c - a
    ap, bp, cp = p - a[None], p - b[None], p - c[None]
    d1, d2 = _dot(ap, ab[None]), _dot(ap, ac[None])
    d3, d4 = _dot(bp, ab[None]), _dot(bp, ac[None])
    d5, d6 = _dot(cp, ab[None]), _dot(cp, ac[None])

    def safe(x):
        return torch.where(x == 0, torch.ones_like(x), x)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = vb / safe(denom)
    w = vc / safe(denom)
    closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
    t_ab = (d1 / safe(d1 - d3)).clamp(0, 1)
    t_ac = (d2 / safe(d2 - d6)).clamp(0, 1)
    d43 = d4 - d3
    t_bc = (d43 / safe(d43 + (d5 - d6))).clamp(0, 1)
    cand = [a[None] + t_ab[..., None] * ab[None],
            a[None] + t_ac[..., None] * ac[None],
            b[None] + t_bc[..., None] * (c - b)[None]]
    dists = [((p - cd) ** 2).sum(dim=-1) for cd in cand]
    inside = (v >= 0) & (w >= 0) & (v + w <= 1)
    dists.append(torch.where(inside, ((p - closest) ** 2).sum(dim=-1),
                             torch.full_like(v, float("inf"))))
    dmin = torch.stack(dists).amin(dim=0)              # [P, F]
    return torch.sqrt(dmin.amin(dim=1))


def mesh_surface_points_mask(tris, points, offset: float = 1e-4):
    """Points within `offset` of the mesh surface: one of six axis jitters
    leaves the mesh."""
    offs = torch.tensor([
        [0, 0, offset], [0, 0, -offset], [0, offset, 0],
        [0, -offset, 0], [offset, 0, 0], [-offset, 0, 0],
    ], dtype=points.dtype, device=points.device)
    escaped = torch.zeros(points.shape[0], dtype=torch.bool,
                          device=points.device)
    for o in offs:
        escaped |= ~points_in_mesh(points + o, tris)
    return escaped
