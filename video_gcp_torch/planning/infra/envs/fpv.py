"""First-person (egocentric) rendering of the multiroom maze.

The reference's 3-D observation mode comes from gym-miniworld — an external
OpenGL dependency whose submodule ships empty
(gcp/planning/infra/envs/miniworld_env/multiroom3d/multiroom3d_env.py:40-62
builds `MiniWorldEnv` with obs_height/obs_width; README "3D Navigation").
Here the same capability is a self-contained, dependency-free column
raycaster over the maze's exact wall-segment table
(layout.wall_segments): vectorized ray/segment intersection per image
column, perspective wall slices, per-room wall colors, floor/ceiling
shading, and a distance-scaled goal billboard — everything a
goal-conditioned egocentric predictor needs, with no GPU/GL stack.

Geometry lives in the same centered table coordinates the env uses
(origin at the maze center, table spans [-table/2, table/2]^2).

A numpy copy of planning/infra/envs/fpv.py of the JAX package: the texture
pack's PNGs are read and resized with `raster.read_png` and
`raster.resize_linear` in place of `cv2.imread` and `cv2.resize` (equal to
OpenCV's uint8 pixels); renders are equal to the JAX package's bit for bit.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from video_gcp_torch.planning.infra import raster
from video_gcp_torch.planning.infra.envs.layout import (
    ROOM_SIZE,
    TEXTURE_FILE_ORDER,
    _flat_room_colors,
    default_texture_dir,
    wall_segments,
)


def procedural_texture(name: str, size: int = 64) -> np.ndarray:
    """Deterministic, dependency-free texel tile for a texture-pack filename.

    Pattern family (brick / checker tiles / planks / stripes / speckle) and
    palette derive from the filename hash, so renders are reproducible and
    visually distinct per room. Stands in for the nav-dataset PNG pack
    (miniworld's textures/ assets) in zero-asset environments; real PNGs are
    used instead whenever the pack is on disk.
    """
    seed = zlib.crc32(name.encode("utf-8"))
    rng = np.random.RandomState(seed % (2 ** 32))
    base = 0.35 + 0.5 * rng.rand(3)
    alt = np.clip(base * (0.45 + 0.25 * rng.rand()), 0.0, 1.0)
    yy, xx = np.mgrid[0:size, 0:size]
    kind = seed % 5
    if kind == 0:  # running-bond brick
        course_h = max(size // 8, 2)
        offset = (yy // course_h % 2) * (size // 8)
        mask = (((xx + offset) % max(size // 4, 4)) < 2) | (
            (yy % course_h) < 1)
    elif kind == 1:  # checker tiles
        t = max(size // 8, 2)
        mask = ((xx // t + yy // t) % 2).astype(bool)
    elif kind == 2:  # vertical planks
        mask = (xx % max(size // 6, 2)) < 1
    elif kind == 3:  # horizontal stripes
        mask = (yy // max(size // 8, 2) % 2).astype(bool)
    else:  # speckle
        mask = rng.rand(size, size) < 0.2
    tex = np.where(mask[..., None], alt[None, None], base[None, None])
    tex = np.clip(tex + 0.03 * rng.randn(size, size, 3), 0.0, 1.0)
    return tex.astype(np.float32)


class FirstPersonRenderer:
    """Raycast renderer for one maze layout.

    :param rooms_per_side: maze side length in rooms (3 for nav_9rooms).
    :param img_size: square output resolution.
    :param fov: horizontal field of view in radians.
    """

    # world units; camera sits at half height. Rooms are only ROOM_SIZE
    # across, so a low wall keeps floor/ceiling visible from mid-room
    WALL_HEIGHT = 0.25 * ROOM_SIZE
    FLOOR_COLOR = np.array([0.22, 0.20, 0.18], np.float32)
    CEIL_COLOR = np.array([0.55, 0.60, 0.68], np.float32)
    GOAL_COLOR = np.array([0.95, 0.15, 0.10], np.float32)

    # texture repeats per room width of wall / floor
    TEX_REPEAT = 2
    TEX_SIZE = 64

    def __init__(self, rooms_per_side: int, img_size: int = 64,
                 fov: float = np.pi / 3, textures: str = "off",
                 texture_dir: str | None = None):
        """:param textures: 'off' = flat per-room colors (default, matches
            the published flat-color datasets); 'pack' = nav-dataset PNG
            textures (raises if absent); 'procedural' = deterministic
            synthesized tiles; 'auto' = pack if on disk, else procedural.
        """
        self.rooms_per_side = rooms_per_side
        self.img_size = img_size
        self.fov = fov
        table = ROOM_SIZE * rooms_per_side
        segs, _ = wall_segments(rooms_per_side)
        segs = np.asarray(segs, np.float64) - table / 2  # centered coords
        self._a = segs[:, 0:2]  # [S, 2] segment starts
        self._e = segs[:, 2:4] - segs[:, 0:2]  # [S, 2] segment extents
        self._half_table = table / 2
        self._colors = _flat_room_colors(rooms_per_side * rooms_per_side)
        # horizontal walls get a 20% darker shade than vertical ones — the
        # classic raycaster depth cue that disambiguates wall orientation
        self._orient_shade = np.where(
            np.abs(self._e[:, 1]) < 1e-12, 0.8, 1.0)
        # camera-plane offsets: linear in the projection plane (not in
        # angle), so vertical lines stay straight
        w = img_size
        self._plane = np.linspace(-1.0, 1.0, w) * np.tan(fov / 2)
        self._proj_dist = 1.0  # distances are normalized to the plane below
        self._textures = self._build_textures(textures, texture_dir)
        self._ceil_tex = (procedural_texture("ceiling_tile_noborder_1.png",
                                             self.TEX_SIZE)
                          if self._textures is not None else None)

    def _build_textures(self, mode: str, texture_dir):
        """[n_rooms, T, T, 3] per-room wall/floor texel tiles, or None.

        Room → texture-name assignment reuses the dataset-synchronized
        TEXTURE_FILE_ORDER with the same tile index the top-down renderer
        uses (layout.draw_layout_overview), so the two observation modes
        agree on each room's identity.
        """
        if mode == "off":
            return None
        if mode not in ("auto", "pack", "procedural"):
            raise ValueError(f"unknown texture mode {mode!r}")
        if texture_dir is None:
            texture_dir = default_texture_dir()
        n_rooms = self.rooms_per_side ** 2
        texs = []
        for tile_idx in range(n_rooms):
            name = TEXTURE_FILE_ORDER[tile_idx % len(TEXTURE_FILE_ORDER)]
            tex = None
            path = None if texture_dir is None else os.path.join(texture_dir, name)
            if mode in ("auto", "pack") and path is not None and os.path.isfile(path):
                tex = raster.resize_linear(raster.read_png(path), self.TEX_SIZE,
                                           self.TEX_SIZE).astype(np.float32) / 255.0
            if tex is None:
                if mode == "pack":
                    raise FileNotFoundError(
                        f"texture pack missing {name} in {texture_dir}")
                tex = procedural_texture(name, self.TEX_SIZE)
            texs.append(tex)
        return np.stack(texs)

    def _room_index(self, pts: np.ndarray) -> np.ndarray:
        """Room (tile) index of each point [..., 2] — same tile numbering as
        the top-down renderer (layout.draw_layout_overview)."""
        cell = np.floor(
            (pts + self._half_table) / ROOM_SIZE).astype(int)
        cell = np.clip(cell, 0, self.rooms_per_side - 1)
        return cell[..., 0] * self.rooms_per_side + (
            self.rooms_per_side - 1 - cell[..., 1])

    def _room_color(self, pts: np.ndarray) -> np.ndarray:
        """Flat wall color of the room each point [N, 2] lies in."""
        return self._colors[self._room_index(pts)]

    def cast(self, pos, heading):
        """Perpendicular wall distance + hit info for every image column.

        :return: (perp [W], hit_pts [W, 2], seg_idx [W]) — perp is the
            fisheye-corrected distance used for projection.
        """
        pos = np.asarray(pos, np.float64)
        fwd = np.array([np.cos(heading), np.sin(heading)])
        right = np.array([fwd[1], -fwd[0]])
        # one ray per column through the camera plane
        dirs = fwd[None, :] + self._plane[:, None] * right[None, :]  # [W, 2]

        ap = self._a[None, :, :] - pos[None, None, :]  # [1, S, 2]
        e = self._e[None, :, :]
        denom = dirs[:, None, 0] * e[..., 1] - dirs[:, None, 1] * e[..., 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (ap[..., 0] * e[..., 1] - ap[..., 1] * e[..., 0]) / denom
            s = (ap[..., 0] * dirs[:, None, 1]
                 - ap[..., 1] * dirs[:, None, 0]) / denom
        valid = (np.abs(denom) > 1e-12) & (t > 1e-6) & (s >= 0.0) & (s <= 1.0)
        t = np.where(valid, t, np.inf)
        seg_idx = np.argmin(t, axis=1)  # [W]
        t_hit = t[np.arange(t.shape[0]), seg_idx]
        t_hit = np.where(np.isfinite(t_hit), t_hit, 10.0 * self._half_table)
        hit_pts = pos[None, :] + dirs * t_hit[:, None]
        # dirs are camera-plane rays (|dir| != 1): t is already the
        # perpendicular (projection-plane) depth — no cos correction needed
        return t_hit, hit_pts, seg_idx

    def render(self, pos, heading, goal=None) -> np.ndarray:
        """Egocentric RGB frame, uint8 [img_size, img_size, 3]."""
        h = w = self.img_size
        perp, hit_pts, seg_idx = self.cast(pos, heading)

        # inward nudge so the hit point's room lookup lands on the camera
        # side of the wall
        pos_np = np.asarray(pos, np.float64)
        inward = pos_np[None, :] - hit_pts
        inward /= np.linalg.norm(inward, axis=1, keepdims=True) + 1e-12
        base = self._room_color(hit_pts + 1e-4 * inward)  # [W, 3]
        shade = self._orient_shade[seg_idx, None] / (1.0 + 2.5 * perp[:, None])
        wall_col = np.clip(base * (0.35 + 0.65 * shade), 0.0, 1.0)

        # perspective wall slice per column
        half_h = (self.WALL_HEIGHT / 2) / np.maximum(perp, 1e-4) * (
            (h / 2) / np.tan(self.fov / 2))
        top = np.clip(np.round(h / 2 - half_h).astype(int), 0, h)
        bot = np.clip(np.round(h / 2 + half_h).astype(int), 0, h)

        img = np.empty((h, w, 3), np.float32)
        rows = np.arange(h)[:, None]
        ceil_mask = rows < top[None, :]
        floor_mask = rows >= bot[None, :]
        wall_mask = ~ceil_mask & ~floor_mask
        if self._textures is None:
            # mild vertical gradient on floor/ceiling for a horizon cue
            grad = np.abs(rows - h / 2) / (h / 2)
            img[:] = self.CEIL_COLOR * (0.7 + 0.3 * grad)
            img = np.where(floor_mask[..., None],
                           self.FLOOR_COLOR * (0.5 + 0.5 * grad), img)
            img = np.where(wall_mask[..., None],
                           np.broadcast_to(wall_col[None], (h, w, 3)), img)
        else:
            dirs = (np.array([np.cos(heading), np.sin(heading)])[None, :]
                    + self._plane[:, None]
                    * np.array([np.sin(heading), -np.cos(heading)])[None, :])
            img = self._textured_frame(
                img, pos_np, dirs, perp, hit_pts, seg_idx, half_h,
                ceil_mask, floor_mask, wall_mask)

        if goal is not None:
            img = self._draw_goal(img, pos_np, heading, np.asarray(goal),
                                  perp)
        return (img * 255).astype(np.uint8)

    def _textured_frame(self, img, pos, dirs, perp, hit_pts, seg_idx,
                        half_h, ceil_mask, floor_mask, wall_mask):
        """Miniworld-style textured walls + cast floor/ceiling.

        Wall columns sample the hit room's texture at (u = distance along
        the wall segment, v = wall height); floor/ceiling pixels are
        perspective-cast back to world coordinates per row (classic
        raycaster floor casting) and sample the standing room's tile /
        a shared ceiling tile.
        """
        h = w = self.img_size
        t_sz = self.TEX_SIZE
        rows = np.arange(h)[:, None]
        proj = (h / 2) / np.tan(self.fov / 2)

        # ---- walls ----
        a = self._a[seg_idx]
        e = self._e[seg_idx]
        s = ((hit_pts - a) * e).sum(1) / np.maximum(
            (e * e).sum(1), 1e-12)
        u = s * np.linalg.norm(e, axis=1)  # world units along the wall
        u_t = np.floor((u / ROOM_SIZE * self.TEX_REPEAT) % 1.0
                       * t_sz).astype(int)  # [W]
        inward = pos[None, :] - hit_pts
        inward /= np.linalg.norm(inward, axis=1, keepdims=True) + 1e-12
        ridx_w = self._room_index(hit_pts + 1e-4 * inward)  # [W]
        denom = np.maximum(2.0 * half_h[None, :], 1e-6)
        v = (rows - (h / 2 - half_h[None, :])) / denom  # [H, W]
        v_t = np.floor(np.clip(v, 0.0, 1.0 - 1e-6) * t_sz).astype(int)
        wall_rgb = self._textures[
            np.broadcast_to(ridx_w[None, :], (h, w)),
            v_t,
            np.broadcast_to(u_t[None, :], (h, w)),
        ]  # [H, W, 3]
        shade = self._orient_shade[seg_idx][None, :, None] / (
            1.0 + 2.5 * perp[None, :, None])
        wall_rgb = np.clip(wall_rgb * (0.35 + 0.65 * shade), 0.0, 1.0)

        # ---- floor / ceiling casting ----
        cam_h = self.WALL_HEIGHT / 2
        row_off = np.abs(rows - h / 2).astype(np.float64)  # [H, 1]
        with np.errstate(divide="ignore"):
            dist = cam_h * proj / np.maximum(row_off, 1e-6)  # [H, 1]
        dist = np.minimum(dist, 20.0 * self._half_table)
        world = pos[None, None, :] + dirs[None, :, :] * dist[:, :, None]
        tex_f = ((world + self._half_table) / ROOM_SIZE
                 * self.TEX_REPEAT) % 1.0
        fx = np.floor(tex_f[..., 0] * t_sz).astype(int)
        fy = np.floor(tex_f[..., 1] * t_sz).astype(int)
        ridx_f = self._room_index(world)  # [H, W]
        fc_shade = (0.35 + 0.65 / (1.0 + 2.5 * dist))[..., None]
        floor_rgb = self._textures[ridx_f, fy, fx] * 0.75 * fc_shade
        ceil_rgb = self._ceil_tex[fy, fx] * fc_shade

        img[:] = np.clip(ceil_rgb, 0.0, 1.0)
        img = np.where(floor_mask[..., None],
                       np.clip(floor_rgb, 0.0, 1.0), img)
        img = np.where(wall_mask[..., None], wall_rgb, img)
        return img

    def _draw_goal(self, img, pos, heading, goal, perp):
        """Distance-scaled goal billboard (miniworld's goal box analogue),
        occluded by walls."""
        h = w = self.img_size
        rel = goal - pos
        dist = np.linalg.norm(rel)
        if dist < 1e-6:
            return img
        fwd = np.array([np.cos(heading), np.sin(heading)])
        right = np.array([fwd[1], -fwd[0]])
        depth = rel @ fwd
        if depth < 1e-3:
            return img  # behind the camera
        lateral = (rel @ right) / depth  # camera-plane coordinate
        col_f = (lateral / np.tan(self.fov / 2) + 1.0) / 2.0 * (w - 1)
        proj = (h / 2) / np.tan(self.fov / 2)
        size = int(np.clip(0.35 * self.WALL_HEIGHT / depth * proj, 1, h // 2))
        c0 = int(round(col_f)) - size // 2
        cols = np.arange(max(c0, 0), min(c0 + size, w))
        if cols.size == 0:
            return img
        visible = cols[perp[cols] > depth]  # wall occlusion per column
        if visible.size == 0:
            return img
        r0 = h // 2  # goal sits on the floor: from mid-screen downward
        r1 = min(r0 + size, h)
        img[r0:r1, visible] = self.GOAL_COLOR
        return img
