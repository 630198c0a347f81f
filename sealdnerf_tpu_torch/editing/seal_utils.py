"""Seal mappers: the edit semantics (port of
sealdnerf_tpu/editing/seal_utils.py).

A mapper is built on the host (numpy geometry) from a `seal.json` config and
then answers three questions about samples, on tensors of the device it was
moved to (`to`):

- map_mask(points) -> bool [N]: inside an AABB of `map_bound` and inside the
  edit mesh;
- map_to_origin(points, dirs) -> (points', dirs', mask): where an edited
  sample's content comes from in the original scene;
- map_color(points, dirs, colors) -> colors': the HSV or RGB recolouring and
  the projected texture.

These are the reference's full-batch functions, sample by sample. A render
asks them about tens of millions of samples, and map_mask and the brush's
border distance broadcast [N, faces] and [N, border points], so
`map_to_origin_compact` evaluates map_to_origin only on the samples inside
the boxes where the mapper can change anything (`support`), in bounded
chunks, and scatters back: the result equals the full-batch one.

Mapper types (key `type` of the config):
- bbox: move and scale the content of an oriented box; `mapSource` fills
  the emptied source box with the colour of one point;
- brush: raise or lower a painted surface along its best-fit normal,
  `line` (an oriented box) or `curve` (an extruded surface), attenuation
  `linear` (a falloff within attenuationDistance of the border) or `dry`
  (no warp); other modes raise, as in the reference;
- anchor: a cone-shaped pull of a surface region towards a dragged anchor.

The config is read with `load_config`: JSON with `//` and `/* */` comments
and trailing commas (the JSON5 the editing tools write), without the json5
package.
"""

import json
import os
from typing import Optional

import numpy as np
import torch

from . import color_utils
from .geometry import (aabb_mesh, extruded_surface_mesh,
                       mesh_surface_points_mask, mesh_triangles,
                       oriented_bounding_box, plane_best_fit, points_in_mesh,
                       project_points, uv_sphere_points)

# elements of the largest [chunk, faces or border points, 3] temporary of a
# mapper evaluation (2^25 f32: 128 MB)
_CHUNK_ELEMS = 1 << 25


def _strip_json5(text: str) -> str:
    """`text` without comments and trailing commas; strings are kept as
    they are."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            i = n if j < 0 else j + 2
        elif c == ",":
            j = i + 1
            while j < n and text[j].isspace():
                j += 1
            if j < n and text[j] in "]}":
                i += 1                               # trailing comma
            else:
                out.append(c)
                i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def load_config(path: str) -> dict:
    """A seal config file: JSON with comments and trailing commas."""
    with open(path) as f:
        return json.loads(_strip_json5(f.read()))


def _f32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _in_boxes(points, bounds):
    """Strictly inside any of the AABBs bounds [B, 2, 3] -> bool [N]."""
    out = torch.zeros(points.shape[0], dtype=torch.bool,
                      device=points.device)
    for b in bounds:
        out |= ((points > b[0]) & (points < b[1])).all(dim=1)
    return out


class SealMapper:
    """Base: holds map_data and the edit mesh's triangles; subclasses
    implement map_to_origin."""

    def __init__(self, seal_config: dict):
        self.config = seal_config
        self.map_data = {}
        self.map_triangles: Optional[torch.Tensor] = None   # [F, 3, 3]
        self.map_test_dir = None

    def to(self, device):
        """Move the tensors of the mapper to `device`; returns self."""
        self.map_data = {k: v.to(device) if torch.is_tensor(v) else v
                         for k, v in self.map_data.items()}
        if self.map_triangles is not None:
            self.map_triangles = self.map_triangles.to(device)
        if self.map_test_dir is not None:
            self.map_test_dir = self.map_test_dir.to(device)
        return self

    # ------------------------------------------------------------ samples
    def _bounds(self, key="map_bound"):
        b = self.map_data[key]
        return b[None] if b.dim() == 2 else b

    def map_mask(self, points):
        """Inside a map_bound AABB and inside the edit mesh."""
        return _in_boxes(points, self._bounds()) & points_in_mesh(
            points, self.map_triangles, self.map_test_dir)

    def map_to_origin(self, points, dirs=None):
        raise NotImplementedError()

    def support(self, points):
        """bool [N]: the samples whose map_to_origin may differ from the
        identity with mask False (None: any sample). The default holds for
        mappers whose every change is under map_mask."""
        return _in_boxes(points, self._bounds())

    def _chunk(self) -> int:
        width = max(len(self.map_triangles)
                    if self.map_triangles is not None else 1,
                    len(self.map_data.get("border_points", ())), 1)
        return max(1024, _CHUNK_ELEMS // (3 * width))

    def map_to_origin_compact(self, points, dirs=None):
        """map_to_origin(points, dirs), evaluated only on the samples of
        `support` and in chunks. points, dirs: [N, 3] (views of planar
        [3, N] tensors are fine: the outputs keep their layout)."""
        sup = self.support(points)
        idx = None if sup is None else sup.nonzero()[:, 0]
        out_p = points.clone()
        out_d = None if dirs is None else dirs.clone()
        mask = torch.zeros(points.shape[0], dtype=torch.bool,
                           device=points.device)
        n = points.shape[0] if idx is None else idx.shape[0]
        step = self._chunk()
        for i in range(0, n, step):
            sel = slice(i, min(i + step, n)) if idx is None \
                else idx[i:i + step]
            p, pd, m = self.map_to_origin(
                points[sel].contiguous(),
                None if dirs is None else dirs[sel].contiguous())
            out_p[sel] = p
            mask[sel] = m
            if dirs is not None:
                out_d[sel] = pd
        return out_p, out_d, mask

    def _recolor(self, points, colors, v_means, stop=None):
        """map_color's stages in order: HSV offset, RGB recolouring,
        texture. With stop ("rgb" or "image"): the colours entering that
        stage. v_means[stage] (absent: the mean of its input) is the mean
        value that the stage's modify_rgb reads."""
        md = self.map_data
        if "hsv" in md:
            colors = color_utils.modify_hsv(colors, md["hsv"])
        off = float(md.get("rgb_light_offset", 0.0))
        if "rgb" in md:
            if stop == "rgb":
                return colors
            colors = color_utils.modify_rgb(colors, md["rgb"], off,
                                            v_means.get("rgb"))
        if "image" in md:
            if stop == "image":
                return colors
            image, mask_img = md["image"], md["image_mask"]
            hh, ww = image.shape[:2]
            v_o, v_w, v_h = md["v_image_o"], md["v_image_w"], md["v_image_h"]
            v_op = project_points(md["v_image_norm"], v_o, points) - v_o
            v_ow, v_oh = v_w - v_o, v_h - v_o
            iw = torch.floor(v_op @ v_ow / (v_ow @ v_ow) * ww).clamp(
                0, ww - 1).long()
            ih = torch.floor(v_op @ v_oh / (v_oh @ v_oh) * hh).clamp(
                0, hh - 1).long()
            m = mask_img[ih, iw][:, None]
            modified = color_utils.modify_rgb(colors, image[ih, iw], off,
                                              v_means.get("image"))
            colors = m * modified + (1 - m) * colors
        return colors

    def map_color(self, points, dirs, colors, v_means=None):
        """The recoloured colours [N, 3]. v_means: the mean value of the
        colours entering each RGB recolouring over the whole batch
        (`color_means`); None takes `colors` as the whole batch."""
        return self._recolor(points, colors, v_means or {})

    def color_means(self, points, colors, chunk: int = 1 << 22):
        """v_means of map_color for the batch (points, colors), summed
        chunk by chunk in f64: {} when map_color reads no batch mean."""
        v_means, n = {}, colors.shape[0]
        for name in ("rgb", "image"):
            if name not in self.map_data:
                continue
            total = torch.zeros((), dtype=torch.float64,
                                device=colors.device)
            for i in range(0, n, chunk):
                c = self._recolor(points[i:i + chunk], colors[i:i + chunk],
                                  v_means, stop=name)
                total += c.amax(dim=-1).sum(dtype=torch.float64)
            v_means[name] = (total / max(n, 1)).float()
        return v_means

    # ------------------------------------------------------------- host
    def _store_color_config(self, seal_config, config_path=""):
        if "hsv" in seal_config:
            self.map_data["hsv"] = _f32(seal_config["hsv"])
        if "rgb" in seal_config:
            self.map_data["rgb"] = _f32(seal_config["rgb"])
            self.map_data["rgb_light_offset"] = float(
                seal_config.get("rgbLightOffset", 0.0))
        if "imageConfig" in seal_config:
            from ..utils.png import read_png
            ic = seal_config["imageConfig"]
            self.map_data["rgb_light_offset"] = float(
                seal_config.get("rgbLightOffset", 0.0))
            raw = read_png(ic["path"])
            if raw.shape[2] in (2, 4):
                alpha = raw[:, :, -1] / 255.0
                raw = raw[:, :, :-1]
            else:
                alpha = np.ones(raw.shape[:2])
            img = np.repeat(raw, 3, axis=2) if raw.shape[2] == 1 else raw
            v_o, v_w, v_h = (np.asarray(ic[k], dtype=np.float32)
                             for k in ("o", "w", "h"))
            _, norm = plane_best_fit(np.stack([v_o, v_w, v_h]))
            self.map_data["image"] = _f32(img.astype(np.float32) / 255.0)
            self.map_data["image_mask"] = _f32(alpha)
            self.map_data["v_image_norm"] = _f32(norm)
            self.map_data["v_image_o"] = _f32(v_o)
            self.map_data["v_image_w"] = _f32(v_w)
            self.map_data["v_image_h"] = _f32(v_h)


class SealBBoxMapper(SealMapper):
    """Move and scale the content of an oriented box.

    config: {type: bbox, raw: [N, 3], transform: [4, 4], scale: [3],
             boundType: from|to|both, mapSource?: [3], hsv?/rgb?}
    """

    def __init__(self, config_path: str, seal_config: dict):
        super().__init__(seal_config)
        transform = np.asarray(seal_config["transform"], dtype=np.float64)
        scale = np.asarray(seal_config["scale"], dtype=np.float64)
        fverts, ffaces, _, fcenter, _ = oriented_bounding_box(
            np.asarray(seal_config["raw"]))
        # the target box: scaled about the centre, then transformed
        tverts = (fverts - fcenter) * scale + fcenter
        tverts = (np.hstack([tverts, np.ones((8, 1))]) @ transform.T)[:, :3]
        tcenter = tverts.mean(0)
        self.from_verts, self.from_faces = fverts, ffaces
        self.to_verts, self.to_faces = tverts.astype(np.float32), ffaces
        if config_path:
            _export_obj(os.path.join(config_path, "from.obj"), fverts, ffaces)
            _export_obj(os.path.join(config_path, "to.obj"), tverts, ffaces)
        bound_type = seal_config.get("boundType", "to")
        both_bounds = np.stack([
            np.stack([fverts.min(0), fverts.max(0)]),
            np.stack([tverts.min(0), tverts.max(0)]),
        ])
        if bound_type == "to":
            bounds = both_bounds[1:2]
            tris = mesh_triangles(self.to_verts, ffaces)
        elif bound_type == "from":
            bounds = both_bounds[0:1]
            tris = mesh_triangles(fverts, ffaces)
        else:
            bounds = both_bounds
            tris = np.concatenate([mesh_triangles(fverts, ffaces),
                                   mesh_triangles(self.to_verts, ffaces)])
        self.map_triangles = _f32(tris)
        self.map_data = {
            "force_fill_bound": _f32(both_bounds),
            "map_bound": _f32(bounds),
            "pose_center": _f32((fcenter + tcenter) / 2),
            "pose_radius": float(np.linalg.norm(fcenter - tcenter) * 10),
            "transform": _f32(np.linalg.inv(transform)),
            "rotation": _f32(np.linalg.inv(transform[:3, :3])),
            "scale": _f32(1.0 / scale),
            "center": _f32(fcenter),
        }
        if seal_config.get("mapSource"):
            self.map_data["empty_bound"] = _f32(both_bounds[0])
            self.map_data["map_source"] = _f32(seal_config["mapSource"])
        self._store_color_config(seal_config)

    def support(self, points):
        sup = super().support(points)
        if "empty_bound" in self.map_data:
            sup |= _in_boxes(points, self._bounds("empty_bound"))
        return sup

    def map_to_origin(self, points, dirs=None):
        mask = self.map_mask(points)
        md = self.map_data
        homog = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
        tp = (homog @ md["transform"].t())[:, :3]
        origin_pts = (tp - md["center"]) * md["scale"] + md["center"]
        out_pts = torch.where(mask[:, None], origin_pts, points)
        if "map_source" in md:
            eb = md["empty_bound"]
            src_mask = ((points > eb[0]) & (points < eb[1])).all(dim=1)
            out_pts = torch.where((src_mask & ~mask)[:, None],
                                  md["map_source"][None], out_pts)
        out_dirs = dirs
        if dirs is not None:
            out_dirs = torch.where(mask[:, None], dirs @ md["rotation"].t(),
                                   dirs)
        return out_pts, out_dirs, mask


class SealBrushMapper(SealMapper):
    """Raise or lower a painted surface.

    config: {type: brush, raw: [N, 3] or [B][N, 3], normal?: [3],
             brushType: line|curve, brushDepth, brushPressure,
             attenuationDistance, attenuationMode: linear|dry,
             hsv?/rgb?/imageConfig?}
    """

    def __init__(self, config_path: str, seal_config: dict):
        super().__init__(seal_config)
        points = seal_config["raw"]
        if np.asarray(points[0]).ndim == 1:
            points = [points]
        brush_type = seal_config["brushType"]
        if isinstance(brush_type, str):
            brush_type = [brush_type] * len(points)
        all_tris, all_bounds, border_pts = [], [], []
        normal_expand = plane_point = None
        for i, raw in enumerate(points):
            pts = np.asarray(raw, dtype=np.float64)
            pp, normal = plane_best_fit(pts)
            if "normal" in seal_config and \
                    normal @ np.asarray(seal_config["normal"]) < 0:
                normal = -normal
            normal_expand = normal * float(seal_config["brushPressure"])
            plane_point = pp
            proj = project_points(_f32(normal), _f32(pp), _f32(pts)).numpy()
            depth = float(seal_config["brushDepth"])
            if brush_type[i] == "line":
                cloud = np.vstack([pts + 2 * normal_expand,
                                   pts - depth * normal_expand])
                verts, faces, _, _, _ = oriented_bounding_box(cloud)
            else:
                verts, faces = extruded_surface_mesh(
                    proj, normal_expand, growth=(-depth, 2.0))
            tris = mesh_triangles(verts, faces)
            all_tris.append(tris)
            all_bounds.append(np.stack([verts.min(0), verts.max(0)]))
            bmask = mesh_surface_points_mask(_f32(tris), _f32(proj)).numpy()
            border_pts.append(proj[bmask])
        self.map_triangles = _f32(np.concatenate(all_tris))
        self.map_test_dir = _f32(normal_expand[None])
        border = (np.concatenate(border_pts)
                  if any(len(b) for b in border_pts)
                  else np.asarray(points[0]))
        self.map_data = {
            "force_fill_bound": _f32(np.stack(all_bounds)),
            "map_bound": _f32(np.stack(all_bounds)),
            "normal_expand": _f32(normal_expand),
            "center": _f32(plane_point),
            "border_points": _f32(border),
            "attenuation_distance": float(seal_config["attenuationDistance"]),
            "attenuation_mode": seal_config["attenuationMode"],
        }
        self._store_color_config(seal_config)

    def map_to_origin(self, points, dirs=None):
        mask = self.map_mask(points)
        md = self.map_data
        mode = md["attenuation_mode"]
        if mode == "dry":
            return points, dirs, mask
        if mode not in ("linear",):
            raise NotImplementedError(f"attenuation mode {mode}")
        proj = project_points(md["normal_expand"], md["center"], points)
        border_d = torch.linalg.norm(
            proj[:, None, :] - md["border_points"][None], dim=-1).amin(dim=1)
        ne = md["normal_expand"]
        att = md["attenuation_distance"]
        comp_scale = ((att - border_d) / att).clamp(min=0.0)
        mapped = points - ne
        mapped = mapped + torch.where((border_d < att)[:, None],
                                      comp_scale[:, None] * ne[None],
                                      torch.zeros_like(mapped))
        return torch.where(mask[:, None], mapped, points), dirs, mask


class SealAnchorMapper(SealMapper):
    """Cone-shaped pull towards an anchor.

    config: {type: anchor, raw: [N, 3], translation: [3], radius,
             scale: [3]}
    """

    def __init__(self, config_path: str, seal_config: dict):
        super().__init__(seal_config)
        v_translation = np.asarray(seal_config["translation"],
                                   dtype=np.float64)
        len_translation = np.linalg.norm(v_translation)
        v_anchor = np.mean(np.asarray(seal_config["raw"], dtype=np.float64),
                           axis=0)
        radius = float(seal_config["radius"])
        pp, normal = plane_best_fit(seal_config["raw"])
        v_ta = v_anchor + v_translation
        # the translated anchor projected back onto the plane
        v_pta = project_points(_f32(normal), _f32(pp),
                               _f32(v_ta[None])).numpy()[0]
        v_offset = v_pta - v_anchor
        v_h = v_pta - v_ta
        len_h = np.linalg.norm(v_h)
        sphere = uv_sphere_points(radius * 1.1) + v_anchor
        cloud = np.vstack([sphere, v_anchor + 1.1 * v_translation,
                           sphere - 0.1 * v_translation])
        verts, faces = aabb_mesh(cloud.min(0), cloud.max(0))
        self.to_verts, self.to_faces = verts, faces
        if config_path:
            _export_obj(os.path.join(config_path, "to.obj"), verts, faces)
        self.map_triangles = _f32(mesh_triangles(verts, faces))
        bounds = np.stack([verts.min(0), verts.max(0)])
        self.map_data = {
            "force_fill_bound": _f32(bounds),
            "map_bound": _f32(bounds),
            "pose_center": _f32(verts.mean(0)),
            "pose_radius": float(len_translation * 10),
            "v_anchor": _f32(v_anchor),
            "v_offset": _f32(v_offset),
            "v_h": _f32(v_h),
            "len_h": float(len_h),
            "radius": radius,
            "scale": _f32(seal_config["scale"]),
            "map_source": True,   # no local-point filtering in pretraining
        }
        self._store_color_config(seal_config)

    def support(self, points):
        # the cone test does not go through map_bound
        return None

    def map_to_origin(self, points, dirs=None):
        md = self.map_data
        v_h, v_anchor = md["v_h"], md["v_anchor"]
        len_h, radius = md["len_h"], md["radius"]
        proj = project_points(v_h, v_anchor, points)
        v_p2p = proj - points
        plane_dist = torch.linalg.norm(v_p2p, dim=1)
        pop = proj - (plane_dist[:, None] / len_h) * md["v_offset"]
        pop_anchor_dist = torch.linalg.norm(pop - v_anchor, dim=1)
        in_cone = (pop_anchor_dist <= radius) & (
            plane_dist / torch.clamp(radius - pop_anchor_dist, min=1e-8)
            < len_h / radius * 1.1)
        mask = in_cone & ((v_p2p @ v_h) > 0)
        v_map = -((len_h - plane_dist) / 10.0)[:, None] * v_h[None] / len_h
        mapped = ((pop - v_map) - v_anchor) * md["scale"] + v_anchor
        return torch.where(mask[:, None], mapped, points), dirs, mask


def get_seal_mapper(config_path: str, config_dict: Optional[dict] = None,
                    config_file: str = "seal.json") -> SealMapper:
    """The mapper of `config_dict`, or of the config file `config_file`
    under `config_path`. Mesh exports (from.obj, to.obj) go to
    `config_path`."""
    if config_dict is None:
        config_dict = load_config(os.path.join(config_path, config_file))
    kind = config_dict["type"]
    if kind == "bbox":
        return SealBBoxMapper(config_path, config_dict)
    if kind == "brush":
        return SealBrushMapper(config_path, config_dict)
    if kind == "anchor":
        return SealAnchorMapper(config_path, config_dict)
    raise NotImplementedError(f"unknown seal mapper type {kind}")


def _export_obj(path, verts, faces):
    try:
        with open(path, "w") as f:
            for v in np.asarray(verts):
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for t in np.asarray(faces):
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    except OSError:
        pass
