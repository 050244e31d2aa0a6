"""cv2's LINE_8 drawing rules in numpy, for the synthetic landmark faces
(data/synthetic.py::make_landmark_faces): `line` and `polylines` at any
thickness, `fill_poly` and the filled `circle`, on an (H, W, C) uint8 image
in place. The card's machine has no cv2.

The arithmetic is OpenCV's (imgproc/src/drawing.cpp): a thickness-1 line is
its 8-connected Bresenham iterator, drawn left to right; a thicker one is a
convex quadrilateral in 16-bit fixed point (FillConvexPoly, its edges drawn
by the fixed-point Line2) with round caps (the integer Circle); fillPoly
draws the outline with the 8-connected line and fills the interior by its
edge-list scan conversion (each span from the ceiling of its left edge to
the floor of its right, as cv2 5.0 fills). Integer divisions truncate
toward zero, as C's.

Against cv2 5.0 on random shapes (tests/test_torch_port_landmark_trainer.py
holds the faces): thickness-1 lines and polylines, thickness-2 polylines and
filled circles bit-equal; odd thicknesses and thick lines with two caps off
by a few pixels at the caps, and a polygon clipped by the image border by a
few pixels along the border.
"""

from __future__ import annotations

import numpy as np

__all__ = ["line", "polylines", "fill_poly", "circle"]

_SHIFT = 16
_ONE = 1 << _SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img, p0, p1, color, left_to_right: bool = True) -> None:
    """OpenCV's Line (LineIterator, 8-connected, left to right unless
    left_to_right is False)."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p0, p1
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    sx, sy = 1, 1
    if dx < 0 and left_to_right:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    elif dx < 0:
        dx, sx = -dx, -1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    n = dx + 1
    # the minor axis steps after pixel i when err, before its update, is < 0
    steps = np.zeros(n, np.int64)
    e = err
    minor = 0
    for i in range(n):
        steps[i] = minor
        if e < 0:
            e += 2 * dx - 2 * dy
            minor += 1
        else:
            e -= 2 * dy
    major = np.arange(n, dtype=np.int64)
    if vert:
        xs, ys = x1 + sx * steps, y1 + sy * major
    else:
        xs, ys = x1 + sx * major, y1 + sy * steps
    img[ys, xs] = color


def _line2(img, p0, p1, color) -> None:
    """OpenCV's Line2: the 8-connected line between 16-bit fixed-point
    points."""
    h, w = img.shape[:2]
    ok, x1, y1, x2, y2 = _clip_line(w << _SHIFT, h << _SHIFT, *p0, *p1)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy << _SHIFT, ax | 1)
        ecount = (x2 >> _SHIFT) - (x1 >> _SHIFT)
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx << _SHIFT, ay | 1)
        ecount = (y2 >> _SHIFT) - (y1 >> _SHIFT)
    x1 += _ONE >> 1
    y1 += _ONE >> 1
    end = ((x2 + (_ONE >> 1)) >> _SHIFT, (y2 + (_ONE >> 1)) >> _SHIFT)  # drawn first
    k = np.arange(ecount + 1, dtype=np.int64) if ecount >= 0 else np.zeros(0, np.int64)
    if ax > ay:
        xs = (x1 >> _SHIFT) + k
        ys = (y1 + k * y_step) >> _SHIFT
    else:
        ys = (y1 >> _SHIFT) + k
        xs = (x1 + k * x_step) >> _SHIFT
    xs = np.concatenate([[end[0]], xs])
    ys = np.concatenate([[end[1]], ys])
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def circle(img, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1): OpenCV's integer Circle,
    filled."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = cx >= radius and cx < w - radius and cy >= radius and cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            _hline(img, y11, x11, x12, color)
            _hline(img, y12, x11, x12, color)
            _hline(img, y21, x21, x22, color)
            _hline(img, y22, x21, x22, color)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for y in (y11, y12):
                if 0 <= y < h:
                    _hline(img, y, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for y in (y21, y22):
                    if 0 <= y < h:
                        _hline(img, y, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _fill_convex(img, v, color) -> None:
    """OpenCV's FillConvexPoly at shift 16, LINE_8: the edges by Line2, then
    the scan between the two chains."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = _ONE >> 1
    p0 = v[-1]
    imin = 0
    ymin = ymax = v[0][1]
    xmin = xmax = v[0][0]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> _SHIFT, (xmax + delta) >> _SHIFT
    ymin, ymax = (ymin + delta) >> _SHIFT, (ymax + delta) >> _SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_x, e_dx, e_ye = [-_ONE, -_ONE], [0, 0], [ymin, ymin]
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0, di = e_idx[i], e_di[i]
                idx = (idx0 + di) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> _SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e_ye[i] = ty
                        e_dx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0, idx = idx, (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + delta) >> _SHIFT
            xx2 = (e_x[right] + delta) >> _SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p0, p1, color, thickness: int, flags: int) -> None:
    """OpenCV's ThickLine at shift 0, LINE_8; flags bit 1 caps the start,
    bit 2 the end."""
    if thickness <= 1:
        _line8(img, p0, p1, color)
        return
    f0 = (p0[0] << _SHIFT, p0[1] << _SHIFT)
    f1 = (p1[0] << _SHIFT, p1[1] << _SHIFT)
    dx = (f0[0] - f1[0]) / _ONE
    dy = (f1[1] - f0[1]) / _ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * _ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(f0[0] + dpx, f0[1] + dpy), (f0[0] - dpx, f0[1] - dpy),
                           (f1[0] - dpx, f1[1] - dpy), (f1[0] + dpx, f1[1] + dpy)], color)
    for i, p in enumerate((f0, f1)):
        if flags & (i + 1):
            c = ((p[0] + (_ONE >> 1)) >> _SHIFT, (p[1] + (_ONE >> 1)) >> _SHIFT)
            circle(img, c, (t + (_ONE >> 1)) >> _SHIFT, color)


def _points(pts) -> list:
    return [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]


def line(img, p0, p1, color, thickness: int = 1) -> None:
    """cv2.line(img, p0, p1, color, thickness), LINE_8."""
    _thick_line(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), color,
                thickness, 3)


def polylines(img, pts, closed: bool, color, thickness: int = 1) -> None:
    """cv2.polylines(img, [pts], closed, color, thickness), LINE_8."""
    v = _points(pts)
    if not v:
        return
    i = len(v) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = v[i]
    for i in range(int(not closed), len(v)):
        _thick_line(img, p0, v[i], color, thickness, flags)
        p0 = v[i]
        flags = 2


def fill_poly(img, pts, color) -> None:
    """cv2.fillPoly(img, [pts], color), LINE_8: OpenCV's CollectPolyEdges
    (each edge drawn by the 8-connected line) and FillEdgeCollection."""
    h, w = img.shape[:2]
    v = _points(pts)
    edges = []  # [y0, y1, x, dx]
    pt0 = v[-1]
    pt0 = (pt0[0] << _SHIFT, pt0[1])
    for p in v:
        pt1 = (p[0] << _SHIFT, p[1])
        t0 = ((pt0[0] + (_ONE >> 1)) >> _SHIFT, pt0[1])
        t1 = ((pt1[0] + (_ONE >> 1)) >> _SHIFT, pt1[1])
        _line8(img, t0, t1, color)
        c0, c1 = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            _, a0, b0, a1, b1 = _clip_line(w, h, *t0, *t1)
            if b0 != b1:
                c0, c1 = [a0 << _SHIFT, b0], [a1 << _SHIFT, b1]
        if pt0[1] != pt1[1]:
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx])
        pt0 = pt1
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    x_min = min(min(e[2] for e in edges), min(ends))
    x_max = max(max(e[2] for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _SHIFT):
        return
    # CmpEdges: by y0, then x, then dx
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, h)
    active: list = []
    i = 0
    for y in range(edges[0][0], y_max):
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            # inserted before the first active edge whose x is not smaller
            e = edges[i]
            k = 0
            while k < len(active) and active[k][2] < e[2]:
                k += 1
            active.insert(k, e)
            i += 1
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                lo, hi = (b, a) if a[2] > b[2] else (a, b)
                # the span's pixels between the two edges: ceil and floor
                x1, x2 = (lo[2] + _ONE - 1) >> _SHIFT, hi[2] >> _SHIFT
                if x1 < w and x2 >= 0:
                    _hline(img, y, max(x1, 0), min(x2, w - 1), color)
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])
