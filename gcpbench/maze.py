"""The 9-room maze of the control benchmark, drawn as the port's env draws
it: the layout's walls and flat room colours, the top-down crop around the
agent with the agent's and the goal's dots, and the agent's INTER_AREA
resize to the planner's image size.

A frozen copy of the port's code (video_gcp_torch/planning/infra/raster.py:
`line` and the INTER_AREA downscale; envs/layout.py: the multimodal doors,
`wall_segments`, `draw_layout_overview` without the texture pack;
envs/multiroom2d.py: `render_pos_top_down` with a crop window; the
benchmark agent's resize), so that the benchmark's traffic does not move
when the program does. gcpbench/tests hold it against the program's env.
"""
from __future__ import annotations

import numpy as np

ROBOT_SIZE = 0.02
ROOM_SIZE = 1 / 3
DOOR_SIZE = 1.5 * 0.0667
_REMOVED_WALLS = {3: [((1, 1), (1, 2)), ((1, 1), (1, 0))]}  # the 9-room layout

# --- raster.py ------------------------------------------------------------

_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img: np.ndarray, color) -> np.ndarray:
    c = np.asarray(color, np.float64)[: img.shape[2]]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        c = np.clip(np.rint(c), info.min, info.max)
    return c.astype(img.dtype)


def _hline(img, y, x1, x2, c):
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = c


def _circle(img, cx, cy, radius, c):
    """Filled midpoint circle (OpenCV's Circle with fill)."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            _hline(img, y, cx - dx, cx + dx, c)
        for y in (cy - dx, cy + dx):
            _hline(img, y, cx - dy, cx + dy, c)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(w, h, x1, y1, x2, y2):
    """OpenCV's clipLine on a fixed-point canvas; None when outside."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_fixed(img, p1, p2, c):
    """OpenCV's Line2: a one-pixel line between fixed-point points."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << _SHIFT, h << _SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = c

    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _ONE, _cdiv(dy << _SHIFT, ax | 1)
        ecount = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << _SHIFT, ay | 1), _ONE
        ecount = (y2 - y1) >> _SHIFT
    x1 += _HALF
    y1 += _HALF
    put((x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT)
    if ax > ay:
        x1 >>= _SHIFT
        for _ in range(ecount + 1):
            put(x1, y1 >> _SHIFT)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= _SHIFT
        for _ in range(ecount + 1):
            put(x1 >> _SHIFT, y1)
            x1 += x_step
            y1 += 1


def _fill_convex_poly(img, v, c):
    """OpenCV's FillConvexPoly for fixed-point vertices (8-connected)."""
    h, w = img.shape[:2]
    n = len(v)
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p, c)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + _HALF) >> _SHIFT, (max(xs) + _HALF) >> _SHIFT
    ymin, ymax = (min(ys) + _HALF) >> _SHIFT, (max(ys) + _HALF) >> _SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-_ONE, dx=0, ye=ymin)]
    edges, y = n, ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while edges > 0:
                edges -= 1
                ty = (v[idx][1] + _HALF) >> _SHIFT
                if ty > y:
                    xs0, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, x=xs0, idx=idx,
                             dx=_cdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
            else:
                edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted((edge[0]["x"], edge[1]["x"]))
            x1, x2 = (left + _HALF) >> _SHIFT, (right + _HALF) >> _SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, x1, x2, c)
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def line(img: np.ndarray, pt1, pt2, color, thickness: int) -> np.ndarray:
    """`cv2.line(img, pt1, pt2, color, thickness)` for integer points and
    thickness > 1, drawn into `img` [H, W, C] in place."""
    if thickness <= 1:
        raise ValueError("raster.line draws thick lines only (thickness > 1)")
    c = _color(img, color)
    p0 = (int(pt1[0]) << _SHIFT, int(pt1[1]) << _SHIFT)
    p1 = (int(pt2[0]) << _SHIFT, int(pt2[1]) << _SHIFT)
    dx = (p0[0] - p1[0]) / _ONE
    dy = (p1[1] - p0[1]) / _ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (_SHIFT - 1)
    if r > np.finfo(np.float64).eps:
        r = (half + odd * _ONE * 0.5) / np.sqrt(r)
        ox, oy = int(round(dy * r)), int(round(dx * r))
        _fill_convex_poly(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                                (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], c)
    radius = (half + _HALF) >> _SHIFT
    for p in (p0, p1):
        _circle(img, (p[0] + _HALF) >> _SHIFT, (p[1] + _HALF) >> _SHIFT, radius, c)
    return img


def _area_table(ssize: int, dsize: int):
    """OpenCV's computeResizeAreaTab: (destination, source, weight) per
    contributing source pixel, in OpenCV's order."""
    scale = ssize / dsize
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(int(np.floor(fsx2)), ssize - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, (sx1 - fsx1) / cell))
        tab += [(dx, sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    return tab


def _weights_by_rank(tab, dsize):
    """The table as [rank][dsize] source indices and float32 weights: rank k
    holds each destination's k-th term (weight 0 where it has fewer)."""
    ranks = {}
    for d, s, a in tab:
        ranks.setdefault(d, []).append((s, a))
    depth = max(len(v) for v in ranks.values())
    src = np.zeros((depth, dsize), np.int64)
    wts = np.zeros((depth, dsize), np.float32)
    for d, terms in ranks.items():
        for k, (s, a) in enumerate(terms):
            src[k, d], wts[k, d] = s, a
    return src, wts


def _saturate(x: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(x), info.min, info.max).astype(dtype)
    return x.astype(dtype)


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)` for
    a downscale of an [H, W, C] uint8 or float32 image."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    if height > h or width > w:
        raise ValueError("resize_area: downscales only")
    if h % height == 0 and w % width == 0:  # integer factors: block means
        fy, fx = h // height, w // width
        if (fy, fx) == (2, 2) and img.dtype == np.uint8:  # OpenCV's integer path
            total = img.reshape(height, 2, width, 2, -1).astype(np.int32).sum((1, 3))
            return ((total + 2) >> 2).astype(np.uint8).reshape((height, width) + img.shape[2:])
        blocks = img.reshape(height, fy, width, fx, -1).astype(np.float32)
        total = np.zeros((height, width, blocks.shape[-1]), np.float32)
        for i in range(fy):
            for j in range(fx):
                total = total + blocks[:, i, :, j]  # OpenCV's row-major order
        return _saturate(total * np.float32(1.0 / (fx * fy)), img.dtype).reshape(
            (height, width) + img.shape[2:])
    xsrc, xw = _weights_by_rank(_area_table(w, width), width)
    ysrc, yw = _weights_by_rank(_area_table(h, height), height)
    src = img.reshape(h, w, -1).astype(np.float32)
    rows = np.zeros((h, width, src.shape[-1]), np.float32)  # horizontal sums
    for k in range(xsrc.shape[0]):
        rows = rows + src[:, xsrc[k]] * xw[k][None, :, None]
    out = np.zeros((height, width, src.shape[-1]), np.float32)
    for k in range(ysrc.shape[0]):
        out = out + yw[k][:, None, None] * rows[ysrc[k]]
    return _saturate(out, img.dtype).reshape((height, width) + img.shape[2:])



# --- envs/layout.py -------------------------------------------------------

def _grid_edges(rooms_per_side):
    """Every neighboring room pair of the grid, in a fixed scan order."""
    edges = []
    for x in range(rooms_per_side):
        for y in range(rooms_per_side):
            if x + 1 < rooms_per_side:
                edges.append(((x, y), (x + 1, y)))
            if y + 1 < rooms_per_side:
                edges.append(((x, y), (x, y + 1)))
    return edges


def gen_doors_multimodal(rooms_per_side):
    """Open multi-path layout: all grid edges minus the removed-wall table."""
    if rooms_per_side not in _REMOVED_WALLS:
        raise NotImplementedError(
            f"no multimodal layout defined for {rooms_per_side} rooms/side")
    removed = {frozenset(e) for e in _REMOVED_WALLS[rooms_per_side]}
    return [e for e in _grid_edges(rooms_per_side)
            if frozenset(e) not in removed]


def wall_segments(rooms_per_side):
    """Explicit wall geometry of the maze.

    Returns (segments, doors): `segments` is a float array [S, 4] of
    (x0, y0, x1, y1) in table coordinates (origin at the lower-left corner),
    `doors` the list of door edges as room-grid cell pairs. Matches the
    reference construction's pixel/point union: solid border, interior grid
    lines solid except a DOOR_SIZE gap at each doorway.
    """
    R, D = ROOM_SIZE, DOOR_SIZE
    table = R * rooms_per_side
    doors = gen_doors_multimodal(rooms_per_side)
    door_set = {frozenset(e) for e in doors}

    segs = [
        (0.0, 0.0, table, 0.0), (0.0, table, table, table),
        (0.0, 0.0, 0.0, table), (table, 0.0, table, table),
    ]

    # every potential doorway on a grid line sits at a room-center crossing;
    # cut the line there, then close the cut back up where no door exists
    gap_centers = (np.arange(rooms_per_side) + 0.5) * R

    def line_pieces():
        """(lo, hi) wall pieces of one grid line between doorway cuts."""
        cuts = np.concatenate(
            [[0.0], np.repeat(gap_centers, 2)
             + np.tile([-D / 2, D / 2], rooms_per_side), [table]])
        return list(zip(cuts[0::2], cuts[1::2]))

    for horizontal in (True, False):
        for i in range(1, rooms_per_side + 1):
            line = i * R
            for lo, hi in line_pieces():
                segs.append((lo, line, hi, line) if horizontal
                            else (line, lo, line, hi))
            if i == rooms_per_side:
                continue  # outer boundary: fully closed by the border
            for k, c in enumerate(gap_centers):
                # rooms on either side of this doorway cut
                pair = (((k, i - 1), (k, i)) if horizontal
                        else ((i - 1, k), (i, k)))
                if frozenset(pair) not in door_set:
                    segs.append((c - D / 2, line, c + D / 2, line)
                                if horizontal
                                else (line, c - D / 2, line, c + D / 2))

    return np.asarray(segs, dtype=np.float64), doors


def _flat_room_colors(n):
    """Deterministic distinct flat room colors (texture-less fallback; keeps
    frames visually distinguishable for the predictor)."""
    return (0.35 + 0.55 * np.random.RandomState(7).rand(n, 3)).astype(
        np.float32)



# --- envs/multiroom2d.py and the agent --------------------------------------

def draw_layout_overview(rooms_per_side: int, render_scale: int) -> np.ndarray:
    """Static top-down maze image: flat-colour room tiles, walls drawn from
    the segment table (envs/layout.py without the texture pack)."""
    res = int(ROOM_SIZE * rooms_per_side * render_scale)
    room_px = int(res / rooms_per_side)
    img = np.ones((res, res, 3), dtype=np.float32)
    for x in range(rooms_per_side):
        for y in range(rooms_per_side):
            tile_idx = x * rooms_per_side + y
            img[y * room_px:(y + 1) * room_px,
                x * room_px:(x + 1) * room_px] = _flat_room_colors(rooms_per_side ** 2)[tile_idx]
    segments, _ = wall_segments(rooms_per_side)
    for x0, y0, x1, y1 in segments:
        line(img,
             (int(x0 * render_scale), res - int(y0 * render_scale - 1)),
             (int(x1 * render_scale), res - int(y1 * render_scale - 1)),
             (0, 0, 0), 3)
    return img


class TopDown:
    """The env's top-down observation around the agent (TopdownMultiroom2dEnv
    with a crop window), resized as the benchmark agent stores it."""

    def __init__(self, n_rooms: int, crop_window: int, render_scale: int, image_size: int):
        self.rooms_per_side = int(round(np.sqrt(n_rooms)))
        self.table_size = ROOM_SIZE * self.rooms_per_side
        self.scale, self.window, self.size = render_scale, crop_window, image_size
        bg = draw_layout_overview(self.rooms_per_side, render_scale)
        pad = crop_window
        self.background = np.zeros((bg.shape[0] + 2 * pad, bg.shape[1] + 2 * pad, 3),
                                   dtype=bg.dtype)
        self.background[pad:-pad, pad:-pad] = bg

    def room_center(self, room: int) -> np.ndarray:
        """Centred (x, y) of room `room` (RoomSampler2d's indexing)."""
        rps = self.rooms_per_side
        cell = (room // rps, rps - 1 - room % rps)
        ax = (np.arange(rps) + 0.5) * ROOM_SIZE - rps * ROOM_SIZE / 2
        return np.array([ax[cell[0]], ax[cell[1]]])

    def render_crop(self, current_pos, goal_pos) -> np.ndarray:
        """`render_pos_top_down` with the crop window: [2w, 2w, 3] float."""
        full, w = self.background, self.window

        def convert(pos, img_shape):
            pos = np.asarray(pos[:2]).copy()
            pos = pos + 0.5 * self.table_size
            return (int(pos[0] * self.scale), img_shape[0] - int(pos[1] * self.scale))

        curr = convert(current_pos, full.shape)
        goal = convert(goal_pos, full.shape)
        curr = (curr[0] + w, curr[1] - w)
        goal = (goal[0] + w, goal[1] - w)
        curr = (max(w, curr[0]), max(w, curr[1]))
        lower = np.asarray(curr) - w
        upper = np.asarray(curr) + w
        img = np.ascontiguousarray(full[lower[1]:upper[1], lower[0]:upper[0]])
        off = np.array([lower[0], lower[1]])
        curr_l = (curr[0] - off[0], curr[1] - off[1])
        goal_l = (goal[0] - off[0], goal[1] - off[1])
        line(img, curr_l, curr_l, (0.0, 0, 1.0), 10)
        line(img, goal_l, goal_l, (0.0, 1.0, 0), 10)
        return img

    def observe(self, current_pos, goal_pos) -> np.ndarray:
        """The agent's stored frame: the crop as uint8, INTER_AREA-resized
        to [size, size, 3] uint8."""
        img = np.asarray(255 * self.render_crop(current_pos, goal_pos), dtype=np.uint8)
        return resize_area(img, self.size, self.size)


def pairs(mix: dict, img_sz: int) -> list:
    """`mix.pairs` (start, goal) uint8 image pairs from `mix.pool_seed`:
    start and goal in two different rooms, each drawn uniformly inside its
    room as RoomSampler2d draws (the room's centre plus a jitter of
    +-(ROOM_SIZE - 3 ROBOT_SIZE) / 2); the start frame shows the agent at
    the start and the goal's dot, the goal frame the agent at the goal."""
    view = TopDown(mix["n_rooms"], mix["crop_window"], mix["render_scale"], img_sz)
    rng = np.random.default_rng(mix["pool_seed"])
    half = ROOM_SIZE - 3 * ROBOT_SIZE
    out = []
    for _ in range(mix["pairs"]):
        rooms = rng.choice(mix["n_rooms"], size=2, replace=False)
        start, goal = (view.room_center(r) + (rng.random(2) - 0.5) * half for r in rooms)
        out.append((view.observe(start, goal), view.observe(goal, goal)))
    return out
