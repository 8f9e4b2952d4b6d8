"""numpy versions of the OpenCV calls that the planning paths make.

The env draws its maze and its agent and goal dots with `cv2.line`, the
agent resizes observations with `cv2.resize(..., INTER_AREA)`, and the
savers and the benchmark agent write and read PNGs. The port runs where
OpenCV is not installed, so these functions reproduce exactly those calls,
and nothing more:

- `line`: OpenCV's 8-connected thick line (thickness > 1, no sub-pixel
  shift): the line's rectangle filled as a convex polygon in 16.16 fixed
  point, its outline, and a filled midpoint circle at each end. A line
  from a point to itself is a filled disc of radius (thickness + 1) // 2.
  Equal to OpenCV's pixels for discs, for axis-aligned lines (the maze's
  walls, which cross the border) and for oblique lines whose rectangle and
  caps lie inside the image (trajectories in the maze). An oblique line that
  leaves the image is not held to OpenCV's pixels near the border: OpenCV
  clips it by a route this copy does not follow, and nothing on the
  planning paths draws one.
- `resize_area`: INTER_AREA downscaling, with OpenCV's float32 operation
  order: a block mean for integer factors (in integers for 2x2 blocks of
  uint8, as OpenCV does), otherwise fractional pixel areas from the
  per-axis weight tables. Equal to OpenCV in uint8 (the only dtype the
  paths resize); float32 block means may differ by 2 ulp.
- `write_png` / `read_png`: 8-bit RGB PNG through zlib; reading takes
  every filter type.

tests/test_torch_planning_infra.py holds each against OpenCV.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

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
        raise ValueError("raster.resize_area only downscales")
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_RGB = 2  # PNG colour type of 8-bit RGB, which OpenCV writes for BGR images


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """An [H, W, 3] uint8 RGB image as an 8-bit PNG, every row with filter
    type 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png: uint8 [H, W, 3] expected, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + w * 3), np.uint8)
    raw[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, _RGB, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line_ = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line_
        elif kind == 2:
            cur = (line_ + prev) & 0xFF
        elif kind in (1, 3, 4):
            cur = line_.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b, c = prev[x], prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG (what OpenCV writes for a BGR image)
    as [H, W, 3] uint8 RGB; every filter type is decoded."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_PNG_SIGNATURE), [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if (depth, ctype, interlace) != (8, _RGB, 0):
        raise ValueError(f"{path}: only 8-bit RGB, non-interlaced PNGs are read "
                         f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w * 3, 3).reshape(h, w, 3)
