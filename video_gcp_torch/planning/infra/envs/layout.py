"""2-D multiroom maze layout: wall geometry, doors, samplers, top-down render.

Behavior parity with gcp/planning/infra/envs/miniworld_env/utils/
multiroom2d_layout.py + sampling_fcns.py (deterministic MAZE_SEED=42,
MULTIMODAL=True topology; same coords2ridx convention; same wall-pixel
rendering), built differently: the maze is modelled as a room grid + door-edge
set, walls are an explicit segment table (`wall_segments`) that is rasterized
into the obstacle point cloud and drawn directly — no per-line drawing
callbacks. Rooms are textured from the nav-dataset texture pack when it is
available (multiroom2d_layout.py:195-295) and fall back to deterministic flat
colors otherwise.

A numpy copy of planning/infra/envs/layout.py of the JAX package; the walls
are drawn with `raster.line` in place of `cv2.line`, and the texture pack's
tiles are read and resized with `raster.read_png` and `raster.resize_linear`
in place of `cv2.imread` and `cv2.resize`.
"""
from __future__ import annotations

import os
from random import Random

import numpy as np

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.planning.infra import raster

ROBOT_SIZE = 0.02
ROOM_SIZE = 1 / 3
DOOR_SIZE = 1.5 * 0.0667

MAZE_SEED = 42
MULTIMODAL = True
NON_SYMMETRIC = False

# obstacle point-cloud resolution: spacing << ROBOT_SIZE so PRM edges cannot
# thread between obstacle points
_POINT_SPACING = 0.004


# ---------------------------------------------------------------------------
# door topology
# ---------------------------------------------------------------------------

# Walls removed from the fully-connected room grid to form the published
# multimodal layouts (spec constants, multiroom2d_layout.py:108-155; entries
# outside the grid are ignored there via `maybe_remove` and here via the
# intersection with the valid edge set).
_REMOVED_WALLS = {
    3: [((1, 1), (1, 2)), ((1, 1), (1, 0))],
    4: [((0, 3), (1, 3)), ((1, 0), (2, 0)), ((2, 1), (3, 1)),
        ((2, 2), (3, 2)), ((2, 3), (3, 3)), ((1, 3), (1, 4))],
    5: [((0, 3), (1, 3)), ((1, 0), (2, 0)), ((2, 1), (3, 1)),
        ((2, 2), (3, 2)), ((2, 3), (3, 3)), ((1, 3), (1, 4)),
        ((1, 1), (1, 2)), ((2, 1), (2, 2)), ((3, 1), (3, 2)),
        ((4, 2), (4, 3))],
}


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


def generate_maze(rooms_per_side):
    """Single-path DFS maze (multiroom2d_layout.py:84-105), iterative.

    Reproduces the reference's RNG discipline: one shared neighbor-order list
    reshuffled on every room visit, with each room iterating over the order
    snapshot taken at its own visit time.
    """
    rng = Random(MAZE_SEED)
    order = [(0, 1), (1, 0), (-1, 0), (0, -1)]
    doors, seen = [], {(0, 0)}

    def visit_order():
        rng.shuffle(order)
        return iter(list(order))

    stack = [((0, 0), visit_order())]
    while stack:
        (x, y), it = stack[-1]
        for dx, dy in it:
            nxt = (x + dx, y + dy)
            if not (0 <= nxt[0] < rooms_per_side
                    and 0 <= nxt[1] < rooms_per_side) or nxt in seen:
                continue
            seen.add(nxt)
            doors.append(((x, y), nxt))
            stack.append((nxt, visit_order()))
            break
        else:
            stack.pop()
    return doors


def _cell2ridx(rooms_per_side, x, y):
    """Room-grid cell -> serialized room index (column-major, y flipped)."""
    return x * rooms_per_side + (rooms_per_side - 1) - y


# ---------------------------------------------------------------------------
# wall geometry
# ---------------------------------------------------------------------------


def wall_segments(rooms_per_side):
    """Explicit wall geometry of the maze.

    Returns (segments, doors): `segments` is a float array [S, 4] of
    (x0, y0, x1, y1) in table coordinates (origin at the lower-left corner),
    `doors` the list of door edges as room-grid cell pairs. Matches the
    reference construction's pixel/point union: solid border, interior grid
    lines solid except a DOOR_SIZE gap at each doorway (and, when
    NON_SYMMETRIC, randomly dropped interior pieces).
    """
    R, D = ROOM_SIZE, DOOR_SIZE
    table = R * rooms_per_side
    doors = (gen_doors_multimodal(rooms_per_side) if MULTIMODAL
             else generate_maze(rooms_per_side))
    door_set = {frozenset(e) for e in doors}
    rng = Random(MAZE_SEED)  # consumed only when NON_SYMMETRIC

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
        pieces = list(zip(cuts[0::2], cuts[1::2]))
        if NON_SYMMETRIC:
            pieces = [p for j, p in enumerate(pieces)
                      if not (0 < j < len(pieces) - 1 and rng.random() < 0.1)]
        return pieces

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


def _rasterize(segments, spacing=_POINT_SPACING):
    """Segment table [S, 4] -> point cloud [2, N] at <=`spacing` resolution."""
    chunks = []
    for x0, y0, x1, y1 in segments:
        n = int(np.ceil(np.hypot(x1 - x0, y1 - y0) / spacing)) + 1
        t = np.linspace(0.0, 1.0, n)
        chunks.append(np.stack([x0 + (x1 - x0) * t, y0 + (y1 - y0) * t]))
    return np.concatenate(chunks, axis=1)


def define_layout_raw(rooms_per_side):
    """Obstacle point cloud (centered coords) + door list as room-index pairs
    (multiroom2d_layout.py:20-78)."""
    segments, doors = wall_segments(rooms_per_side)
    table_size = ROOM_SIZE * rooms_per_side
    o = _rasterize(segments) - table_size / 2
    door_idx = [sorted((_cell2ridx(rooms_per_side, *a),
                        _cell2ridx(rooms_per_side, *b))) for a, b in doors]
    return o, ROBOT_SIZE, table_size, door_idx


# ---------------------------------------------------------------------------
# textures (multiroom2d_layout.py:182-262)
# ---------------------------------------------------------------------------

# Room-texture assignment order baked into the published nav datasets: the
# reference shipped this exact list to stay synchronized with the originally
# collected data (multiroom2d_layout.py:195-255, "hack to synchronize"), so it
# is a data constant here too. Room (x, y) uses entry (x*rps + y) % len.
TEXTURE_FILE_ORDER = [
    'floor_tiles_white.png', 'lg_style_01_4tile_d_result.png',
    'lg_style_01_wall_blue_1.png', 'wood_1.png',
    'lg_style_04_wall_cerise_d_result.png',
    'lg_style_05_floor_blue_bright_d_result.png', 'cardboard_4.png',
    'lg_style_03_wall_light_m_result.png', 'lg_style_02_wall_dblue_d_result.png',
    'lg_style_02_wall_purple_d_result.png', 'cinder_blocks_1.png', 'wood_2.png',
    'ceiling_tiles_1.png', 'lg_style_03_wall_purple_d_result.png',
    'airduct_grate_1.png', 'lg_style_03_wall_orange_1.png', 'grass_2.png',
    'lg_style_01_wall_light_m_result.png',
    'lg_style_04_wall_purple_d_result.png',
    'lg_style_03_floor_light1_m_result.png',
    'lg_style_05_wall_red_d_result.png', 'slime_1.png',
    'lg_style_05_wall_yellow_d_result.png', 'floor_tiles_bw_1.png',
    'lg_style_02_floor_orange_d_result.png',
    'lg_style_05_wall_yellow_bright_d_result.png', 'concrete_1.png',
    'lg_style_03_wall_gray_d_result.png', 'lg_style_04_wall_red_d_result.png',
    'lg_style_04_floor_orange_bright_d_result.png',
    'lg_style_01_floor_orange_bright_d_result.png', 'stucco_1.png',
    'lg_style_04_wall_green_bright_d_result.png', 'door_steel_brown.png',
    'lg_style_03_floor_blue_bright_d_result.png', 'lava_1.png',
    'lg_style_05_floor_light1_m_result.png',
    'lg_style_01_wall_red_bright_1.png', 'lg_style_01_wall_green_1.png',
    'lg_style_01_wall_yellow_1.png', 'lg_style_01_wall_red_1.png',
    'lg_style_02_wall_yellow_d_result.png', 'door_doom_1.png',
    'wood_planks_1.png', 'lg_style_03_floor_blue_d_result.png',
    'lg_style_04_floor_blue_d_result.png',
    'lg_style_03_floor_orange_d_result.png',
    'lg_style_04_wall_red_bright_d_result.png',
    'lg_style_02_floor_blue_bright_d_result.png', 'door_garage_white.png',
    'lg_style_04_floor_blue_bright_d_result.png',
    'lg_style_01_floor_blue_d_result.png',
    'lg_style_02_floor_light_m_result.png', 'marble_2.png',
    'lg_style_04_floor_cyan_d_result.png',
    'lg_style_05_floor_blue_d_result.png', 'lg_style_01_wall_cerise_1.png',
    'lg_style_02_wall_yellow_bright_d_result.png',
    'lg_style_01_floor_blue_bright_d_result.png',
    'lg_style_04_wall_green_d_result.png', 'drywall_1.png',
    'lg_style_01_floor_blue_team_d_result.png', 'door_steel_red.png',
    'lg_style_01_floor_light_m_result.png', 'lg_style_03_wall_cyan_1.png',
    'marble_1.png', 'picket_fence_1.png', 'door_steel_grey.png', 'water_1.png',
    'lg_style_02_floor_green_d_result.png',
    'lg_style_01_floor_orange_d_result.png',
    'lg_style_01_wall_green_bright_1.png',
    'lg_style_03_floor_green_bright_d_result.png',
    'lg_style_04_floor_orange_d_result.png', 'door_garage_red.png',
    'brick_wall_1.png', 'lg_style_03_wall_gray_bright_d_result.png',
    'lg_style_03_wall_blue_d_result.png', 'rock_1.png',
    'lg_style_05_wall_red_bright_d_result.png', 'grass_1.png',
    'lg_style_03_floor_green_d_result.png',
    'lg_style_02_floor_green_bright_d_result.png',
    'lg_style_05_floor_orange_d_result.png', 'door_doom_2.png',
    'lg_style_02_wall_blue_d_result.png',
    'lg_style_04_floor_dorange_d_result.png',
    'lg_style_03_floor_purple_d_result.png',
    'lg_style_05_floor_orange_bright_d_result.png',
    'lg_style_01_floor_red_team_d_result.png', 'metal_grill_1.png',
    'lg_style_02_floor_blue_d_result.png', 'cardboard_3.png',
    'lg_style_01_ceiling_d_result.png', 'lg_style_01_wall_purple_1.png',
    'lg_style_03_wall_orange_bright_d_result.png',
    'lg_style_02_wall_blue_bright_d_result.png', 'cardboard_1.png',
    'ceiling_tile_noborder_1.png', 'lg_style_02_wall_lgreen_d_result.png',
    'lg_style_03_floor_red_d_result.png',
]


def default_texture_dir():
    """Texture pack shipped with the nav datasets, if downloaded; else None
    (multiroom2d_layout.py:183-190, made non-fatal for texture-less runs)."""
    data_dir = os.environ.get("GCP_DATA_DIR")
    if data_dir is None:
        return None
    for name in ("nav_9rooms", "nav_25rooms"):
        path = os.path.join(data_dir, name, "textures")
        if os.path.isdir(path):
            return path
    return None


def load_textures(texture_dir):
    """Per-room texture file order (multiroom2d_layout.py:193-255: the
    shipped hardcoded order, to stay in sync with the published datasets)."""
    del texture_dir  # the order is dataset-synchronized, not directory-read
    return list(TEXTURE_FILE_ORDER)


def define_layout(rooms_per_side, texture_dir=None) -> AttrDict:
    if texture_dir is None:
        texture_dir = default_texture_dir()
    o, robot_size, table_size, doors = define_layout_raw(rooms_per_side)

    def coords2ridx(x, y):
        cell = [np.floor((c + table_size / 2) / ROOM_SIZE) for c in (x, y)]
        ridx = cell[0] * rooms_per_side + (rooms_per_side - 1) - cell[1]
        return int(ridx) if np.size(ridx) == 1 else np.asarray(ridx, dtype=int)

    return AttrDict(
        ox=list(o[0]), oy=list(o[1]), robot_size=robot_size,
        table_size=table_size, room_size=ROOM_SIZE, door_size=DOOR_SIZE,
        doors=doors, coords2ridx=coords2ridx,
        textures=load_textures(texture_dir) if texture_dir else None,
        texture_dir=texture_dir,
        multimodal=MULTIMODAL, non_symmetric=NON_SYMMETRIC,
    )


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _flat_room_colors(n):
    """Deterministic distinct flat room colors (texture-less fallback; keeps
    frames visually distinguishable for the predictor)."""
    return (0.35 + 0.55 * np.random.RandomState(7).rand(n, 3)).astype(
        np.float32)


def draw_layout_overview(rooms_per_side, render_scale, texture_dir=None,
                         add_textures=True):
    """Static top-down maze image (multiroom2d_layout.py:265-296): textured
    room tiles (nav-dataset pack) or flat-color fallback, walls drawn from the
    explicit segment table with the reference's pixel mapping."""
    if texture_dir is None:
        texture_dir = default_texture_dir()
    res = int(ROOM_SIZE * rooms_per_side * render_scale)
    room_px = int(res / rooms_per_side)
    img = np.ones((res, res, 3), dtype=np.float32)

    textures = load_textures(texture_dir) if texture_dir else None
    if add_textures:
        for x in range(rooms_per_side):
            for y in range(rooms_per_side):
                tile_idx = x * rooms_per_side + y
                if textures is not None:  # the pack's PNG, cv2.resize's bilinear
                    tex = raster.read_png(os.path.join(
                        texture_dir, textures[tile_idx % len(textures)]))
                    tile = raster.resize_linear(tex, room_px, room_px) / 255.0
                else:
                    tile = _flat_room_colors(rooms_per_side ** 2)[tile_idx]
                img[y * room_px:(y + 1) * room_px,
                    x * room_px:(x + 1) * room_px] = tile

    segments, _ = wall_segments(rooms_per_side)
    for x0, y0, x1, y1 in segments:
        raster.line(img,
                    (int(x0 * render_scale), res - int(y0 * render_scale - 1)),
                    (int(x1 * render_scale), res - int(y1 * render_scale - 1)),
                    (0, 0, 0), 3)
    return img


# ---------------------------------------------------------------------------
# state sampling (sampling_fcns.py:13-93)
# ---------------------------------------------------------------------------


class RoomSampler2d:
    """Uniform state sampling inside rooms and doorways.

    Precomputes the centered room-center table once; all sampling is then a
    lookup + uniform jitter with the appropriate half-width.
    """

    def __init__(self, rooms_per_side, sample_wide=False):
        self._rps = rooms_per_side
        agent = ROBOT_SIZE
        self._room_halfwidth = (ROOM_SIZE if sample_wide
                                else ROOM_SIZE - 3 * agent)
        door_width = DOOR_SIZE - 3 * agent
        # doorway jitter: wide along the door opening, narrow across it
        self._door_halfwidth = {
            "horizontal": np.array([2 * agent, door_width]),
            "vertical": np.array([door_width, 2 * agent]),
        }
        # centered (x, y) center of each room cell
        ax = (np.arange(rooms_per_side) + 0.5) * ROOM_SIZE \
            - rooms_per_side * ROOM_SIZE / 2
        self._centers = np.stack(
            np.meshgrid(ax, ax, indexing="ij"), axis=-1)  # [x, y, 2]

    def _cell(self, room_idx):
        return (room_idx // self._rps,
                self._rps - 1 - room_idx % self._rps)

    def _center(self, room_idx):
        return self._centers[self._cell(room_idx)]

    @staticmethod
    def _jitter(halfwidth):
        return (np.random.rand(2) - 0.5) * halfwidth

    def sample(self, room=None):
        if room is None:
            room = np.random.randint(self._rps ** 2)
        return self._center(room) + self._jitter(self._room_halfwidth)

    def _door_axis(self, room1, room2):
        """'horizontal' if the doorway connects rooms side by side."""
        c1, c2 = self._cell(room1), self._cell(room2)
        if abs(c1[0] - c2[0]) + abs(c1[1] - c2[1]) != 1:
            raise ValueError("Rooms don't have connection for door.")
        return "horizontal" if c1[0] != c2[0] else "vertical"

    def get_door_pos(self, room1, room2):
        assert room1 < room2
        self._door_axis(room1, room2)  # validates adjacency
        return 0.5 * (self._center(room1) + self._center(room2))

    def sample_door(self, room1, room2, sample_center=False):
        center = self.get_door_pos(room1, room2)
        if sample_center:
            return center
        return center + self._jitter(
            self._door_halfwidth[self._door_axis(room1, room2)])

    def get_door_path(self, room1, room2):
        """Approach point / door center / exit point through a doorway."""
        lo, hi = min(room1, room2), max(room1, room2)
        center = self.get_door_pos(lo, hi)
        span = 3 * (DOOR_SIZE - 3 * ROBOT_SIZE)
        offset = (np.array([span, 0.0])
                  if self._door_axis(lo, hi) == "horizontal"
                  else np.array([0.0, -span]))
        if room1 > room2:
            offset = -offset
        return [center - offset, center, center + offset]

    def _ridx2coords(self, room_idx):
        return self._cell(room_idx)


# ---------------------------------------------------------------------------
# room-sequence planning (prm_policy.py:228-289)
# ---------------------------------------------------------------------------


def _adjacency(doors):
    adj = {}
    for a, b in doors:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    return adj


def plan_room_seq(start, goal, doors):
    """Shortest room sequence via breadth-first search over the door graph."""
    adj = _adjacency(doors)
    parent = {start: None}
    frontier = [start]
    while frontier:
        nxt = []
        for room in frontier:
            if room == goal:
                path = []
                while room is not None:
                    path.append(room)
                    room = parent[room]
                return path[::-1]
            for nb in adj.get(room, ()):
                if nb not in parent:
                    parent[nb] = room
                    nxt.append(nb)
        frontier = nxt
    raise ValueError(f"no room path from {start} to {goal}")


def plan_room_seq_multimodal(start, goal, doors):
    """Uniform choice over ALL simple room paths start -> goal, giving the
    expert data its multimodal route distribution (prm_policy.py:257-289)."""
    adj = _adjacency(doors)
    paths, stack = [], [[start]]
    while stack:
        path = stack.pop()
        if path[-1] == goal:
            paths.append(path)
            continue
        stack.extend(path + [nb] for nb in adj.get(path[-1], ())
                     if nb not in path)
    return paths[np.random.randint(len(paths))]


def render_state_trajectories(n_rooms, inputs, predictions, end_inds,
                              n_logged_samples=3):
    """Top-down GT (green) + predicted (red) trajectory overlays for logging
    (datasets/configs/nav_9rooms.py:12-53)."""
    from video_gcp_torch.planning.infra.envs.multiroom2d import Multiroom2dEnv

    env = Multiroom2dEnv(dict(n_rooms=n_rooms), no_env=True)
    imgs = []
    for i in range(min(n_logged_samples, len(end_inds))):
        e = int(end_inds[i])
        gt = np.asarray(inputs.traj_seq_states[i][: e + 1])
        pred = np.asarray(predictions[i][: e + 1])
        bg = env.render_top_down(gt, color=(0, 1.0, 0))
        imgs.append(env.render_top_down(pred, background=bg, color=(1.0, 0, 0)))
    return np.stack(imgs)
