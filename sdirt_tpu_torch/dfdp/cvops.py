"""The OpenCV calls of the synthetic scene generator and of the
Learn2Reduce baseline kernels, in numpy.

The JAX package's ``SyntheticRGBD`` draws its textures with ``cv2.blur``,
``cv2.resize`` (INTER_LINEAR and INTER_CUBIC, float32, upscaling) and
``cv2.line`` (8-connected, thickness 1 or 2). The port may not import cv2,
so this module reproduces OpenCV's own arithmetic for exactly those uses:

  * ``blur``: normalised box filter, sums in float64, BORDER_REFLECT_101;
  * ``resize``: OpenCV's separable resampler: horizontal pass first, float32
    coefficients from ``(float)((dx + 0.5) * scale - 0.5)``, the linear
    horizontal weight clamped at the borders, rows replicated; the cubic
    kernel has A = -0.75 and its vertical pass sums the four rows in the
    order of OpenCV's 4-lane vector loop, the tail columns in scalar order;
  * ``line``: the 8-connected Bresenham line, and for thickness 2 the
    fixed-point polygon fill of the line's rectangle plus radius-1 round
    caps;
  * ``circle_filled`` and ``gaussian_blur`` (float64, an explicit sigma)
    for psfnet/related_psf.py's Butterworth kernels.

They are bit-equal to OpenCV's portable code (tests/test_torch_synthetic.py).
OpenCV builds with Intel IPP route ``resize`` through IPP, whose results
move in the last bits and depend on the CPU; the tests hold the port to
that path within a stated tolerance.
"""

from __future__ import annotations

import numpy as np

_F = np.float32
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# ---------------------------------------------------------------------------
# blur
# ---------------------------------------------------------------------------
def _reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    if n == 1:
        return np.zeros(n + lo + hi, np.int64)
    idx = np.abs(np.arange(-lo, n + hi))
    return np.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def blur(img: np.ndarray, ksize) -> np.ndarray:
    """cv2.blur(img, (k, k)) of a 2-D float32 array."""
    k = ksize[0] if isinstance(ksize, (tuple, list)) else ksize
    if k == 1:
        return img.copy()
    a = k // 2
    h, w = img.shape
    p = img.astype(np.float64)[_reflect101(h, a, k - 1 - a)][:, _reflect101(w, a, k - 1 - a)]
    rows = sum(p[:, j:j + w] for j in range(k))
    cols = sum(rows[i:i + h] for i in range(k))
    return (cols * (1.0 / (k * k))).astype(_F)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), sigma) of a 2-D float64 array with
    sigma > 0: OpenCV's kernel exp(-x^2 / (2 sigma^2)) times the reciprocal
    of its sum, applied along the rows, then the columns, BORDER_REFLECT_101."""
    x = np.arange(ksize) - (ksize - 1) * 0.5
    kern = np.exp((-0.5 / (sigma * sigma)) * x * x)
    total = 0.0
    for t in kern:
        total += t
    kern = kern * (1.0 / total)
    a = ksize // 2
    h, w = img.shape
    p = img.astype(np.float64)[_reflect101(h, a, a)][:, _reflect101(w, a, a)]
    rows = sum(kern[j] * p[:, j:j + w] for j in range(ksize))
    return sum(kern[i] * rows[i:i + h] for i in range(ksize))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------
def _cubic_coeffs(x):
    a = _F(-0.75)
    x1 = (x + _F(1)).astype(_F)
    omx = (_F(1) - x).astype(_F)
    c0 = ((a * x1 - _F(5) * a) * x1 + _F(8) * a) * x1 - _F(4) * a
    c1 = ((a + _F(2)) * x - (a + _F(3))) * x * x + _F(1)
    c2 = ((a + _F(2)) * omx - (a + _F(3))) * omx * omx + _F(1)
    c3 = _F(1) - c0 - c1 - c2
    return [c.astype(_F) for c in (c0, c1, c2, c3)]


def _taps(n_in: int, n_out: int, cubic: bool, clamp: bool):
    """Source index of the first tap and the float32 tap weights."""
    scale = 1.0 / (n_out / n_in)
    fx = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(_F)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(_F)).astype(_F)
    if cubic:
        return sx - 1, _cubic_coeffs(fx)
    if clamp:
        lo = sx < 0
        fx[lo], sx[lo] = 0, 0
        hi = sx >= n_in - 1
        fx[hi], sx[hi] = 0, n_in - 1
    return sx, [(_F(1) - fx).astype(_F), fx]


def resize(img: np.ndarray, dsize, interpolation: str = "linear") -> np.ndarray:
    """cv2.resize(img, (w, h), INTER_LINEAR or INTER_CUBIC) of a 2-D float32
    array."""
    if interpolation not in ("linear", "cubic"):
        raise ValueError(f"interpolation {interpolation!r}")
    cubic = interpolation == "cubic"
    w, h = dsize
    sh, sw = img.shape
    x0, ax = _taps(sw, w, cubic, clamp=True)
    y0, by = _taps(sh, h, cubic, clamp=False)
    k = len(ax)
    hs = [img[:, np.clip(x0 + j, 0, sw - 1)] * ax[j] for j in range(k)]
    row = hs[0]
    for t in hs[1:]:
        row = row + t
    vs = [row[np.clip(y0 + j, 0, sh - 1)] * by[j][:, None] for j in range(k)]
    if not cubic:
        return (vs[0] + vs[1]).astype(_F)
    out = ((vs[0] + vs[1]) + vs[2]) + vs[3]
    nv = (w // 4) * 4
    out[:, :nv] = (vs[0] + (vs[1] + (vs[2] + vs[3])))[:, :nv]
    return out.astype(_F)


# ---------------------------------------------------------------------------
# line
# ---------------------------------------------------------------------------
def _bresenham(img, p1, p2, value):
    """OpenCV's 8-connected LineIterator, left to right (both points inside
    the image)."""
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def _hline(img, y, x1, x2, value):
    img[y, x1:x2 + 1] = value


def _put(img, x, y, value):
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = value


def _line_fixed(img, p1, p2, value):
    """OpenCV's Line2: a line between XY_SHIFT fixed-point end points."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step = XY_ONE
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        y_step = XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT,
         value)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1, y1 >> XY_SHIFT, value)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1 >> XY_SHIFT, y1, value)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(right, bottom, x1, y1, x2, y2):
    """OpenCV's clipLine against [0, right) x [0, bottom); None when the
    line misses the box."""
    right -= 1
    bottom -= 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2) + ((y < 0) * 4 + (y > bottom) * 8)

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
    if (c1 | c2) != 0:
        return None
    return x1, y1, x2, y2


def _fill_convex_poly(img, pts, value):
    """OpenCV's FillConvexPoly for 8-connected edges, points in XY_SHIFT
    fixed point."""
    h, w = img.shape[:2]
    npts = len(pts)
    delta = XY_ONE >> 1
    p0 = pts[-1]
    imin = 0
    ymin = ymax = pts[0][1]
    xmin = xmax = pts[0][0]
    for i, p in enumerate(pts):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line_fixed(img, p0, p, value)
        p0 = p
    xmin = (xmin + delta) >> XY_SHIFT
    xmax = (xmax + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    edges = npts
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), value)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def circle_filled(img, cx, cy, radius, value):
    """cv2.circle(img, (cx, cy), radius, value, -1): OpenCV's filled
    integer circle (Circle with fill=1), in place."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, value)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, value)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, pt1, pt2, color: float, thickness: int = 1):
    """cv2.line(img, pt1, pt2, color, thickness) with LINE_8, in place, for
    end points inside the image."""
    if thickness <= 1:
        _bresenham(img, pt1, pt2, color)
        return img
    p0 = (pt1[0] << XY_SHIFT, pt1[1] << XY_SHIFT)
    p1 = (pt2[0] << XY_SHIFT, pt2[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy),
                                (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy),
                                (p1[0] + dpx, p1[1] + dpy)], color)
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for p in (p0, p1):
        circle_filled(img, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                       (p[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)
    return img
