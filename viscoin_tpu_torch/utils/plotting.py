"""Figures: the counterparts of ``viscoin_tpu/utils/plotting.py``, each
written as a PNG instead of shown (the card's machines have no display).

The port draws its figures itself, with numpy and PIL only: the card's
machines have no matplotlib. :func:`new_figure` gives a :class:`Figure` and
its :class:`Axes`, the part of matplotlib's object interface that the
analysis figures use; :func:`save_figure` rasterises it. The geometry is
matplotlib's default: 100 pixels per inch (a figure of ``figsize`` inches is
``figsize * 100`` pixels), its subplot margins, font sizes in points, tick
lengths and pads, the tab10 line colours, and viridis for a 2-D ``imshow``
(min-max normalized, ``utils/colormaps.py``). Each Axes keeps what it was
given (arrays, series, bin counts and edges, texts), so a test can hold a
figure against matplotlib's.

Rules of the raster:
- An image panel keeps its aspect and is centred in its cell, drawn with
  PIL's NEAREST at the largest integer scale that fits, or, where the image
  does not fit at scale 1, with PIL's BOX filter at the largest size that
  fits (:func:`panel_size`, :func:`panel_pixels`). Nothing else is drawn on
  it: its frame and ticks lie outside.
- Floats of an RGB image are clipped to [0, 1] and scaled by 255, truncated
  to u8 (matplotlib's rule).
- Lines are 2 pixels wide through the pixels :meth:`Axes.to_pixels` gives
  (each vertex's pixel, rounded, drawn).
- Text is Pillow's ``ImageFont.load_default()`` (the scalable font at each
  size where Pillow has FreeType, else its one bitmap font), laid out from
  the boxes ``textbbox`` measures; ``\\n`` starts a new line.
- The same figure gives the same bytes.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

DPI = 100
PT = DPI / 72  # pixels per point
DEFAULT_FIGSIZE = (6.4, 4.8)
# matplotlib's default subplot parameters: left, right, bottom, top, wspace, hspace.
SUBPLOTS = (0.125, 0.9, 0.11, 0.88, 0.2, 0.2)
TITLE_PT, LABEL_PT, TICK_PT, LEGEND_PT = 12.0, 10.0, 10.0, 10.0
TITLE_PAD = round(6 * PT)
TICK_LEN, TICK_PAD = round(3.5 * PT), round(3.5 * PT)
LINE_WIDTH = 2
BLACK, WHITE = (0, 0, 0), (255, 255, 255)
GRID_COLOR, LEGEND_EDGE = (176, 176, 176), (204, 204, 204)
COLORS = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
          (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207)]


# --------------------------------- text ------------------------------------ #


@functools.lru_cache(maxsize=None)
def _font(px: int):
    from PIL import ImageFont, features

    if features.check_module("freetype2"):
        try:
            return ImageFont.load_default(size=px)
        except TypeError:  # Pillow before 10.1: its bitmap font only, of one size
            pass
    return ImageFont.load_default()


def font_kind() -> str:
    """Which font the figures' text takes on this host."""
    import PIL
    from PIL import ImageFont

    font = _font(round(LABEL_PT * PT))
    if isinstance(font, ImageFont.FreeTypeFont):
        return f"Pillow {PIL.__version__}: FreeType, {' '.join(font.getname())}, by size"
    return f"Pillow {PIL.__version__}: the bitmap font, one size"


class _Text:
    """A text item: its top-left corner and its measured size, in pixels."""

    def __init__(self, draw, text: str, pt: float, x: float, y: float, ha: str, va: str,
                 vertical: bool = False):
        self.text, self.font, self.vertical = text, _font(round(pt * PT)), vertical
        l, t, r, b = draw.multiline_textbbox((0, 0), text, font=self.font, align="center")
        self.offset, w, h = (l, t), r - l, b - t
        if vertical:  # turned 90° anticlockwise: reads upwards
            w, h = h, w
        self.w, self.h = w, h
        self.x0 = round(x - {"left": 0, "center": w / 2, "right": w}[ha])
        self.y0 = round(y - {"top": 0, "center": h / 2, "bottom": h}[va])

    def bbox(self) -> tuple[int, int, int, int]:
        return self.x0, self.y0, self.x0 + self.w, self.y0 + self.h

    def draw(self, canvas, draw) -> None:
        from PIL import Image, ImageDraw

        if not self.vertical:
            draw.multiline_text((self.x0 - self.offset[0], self.y0 - self.offset[1]), self.text,
                                font=self.font, fill=BLACK, align="center")
            return
        mask = Image.new("L", (self.h, self.w), 0)
        ImageDraw.Draw(mask).multiline_text((-self.offset[0], -self.offset[1]), self.text,
                                            font=self.font, fill=255, align="center")
        canvas.paste(BLACK, (self.x0, self.y0), mask.transpose(Image.Transpose.ROTATE_90))


def _measurer():
    from PIL import Image, ImageDraw

    return ImageDraw.Draw(Image.new("RGB", (1, 1)))


# -------------------------------- images ----------------------------------- #


def image_rgb(array) -> np.ndarray:
    """The (H, W, 3) u8 pixels of what ``imshow`` was given: RGB as it is
    (floats clipped to [0, 1], times 255, truncated), a 2-D array through
    viridis after min-max normalization in its float type."""
    from viscoin_tpu_torch.utils.colormaps import VIRIDIS, lookup

    a = np.asarray(array)
    if a.ndim == 2:
        a = a.astype(np.promote_types(a.dtype, np.float32))
        lo, hi = np.nanmin(a), np.nanmax(a)
        norm = np.zeros_like(a) if hi == lo else (a - lo) / (hi - lo)
        return (lookup(VIRIDIS, norm) * 255).astype(np.uint8)[..., :3]
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"imshow takes (H, W) or (H, W, 3) arrays, got {a.shape}")
    if a.dtype == np.uint8:
        return a
    if np.issubdtype(a.dtype, np.floating):
        return (np.clip(a, 0, 1) * 255).astype(np.uint8)
    return np.clip(a, 0, 255).astype(np.uint8)


def panel_size(shape: tuple[int, int], cell: tuple[int, int]) -> tuple[int, int]:
    """(width, height) of an (H, W) image's panel in a cell of (width,
    height) pixels: the largest integer multiple that fits, or, if the image
    does not fit, the largest size of its aspect that does."""
    (h, w), (cw, ch) = shape, cell
    if w <= cw and h <= ch:
        k = min(cw // w, ch // h)
        return w * k, h * k
    s = min(cw / w, ch / h)
    return max(1, int(w * s)), max(1, int(h * s))


def panel_pixels(array, size: tuple[int, int]) -> np.ndarray:
    """The (height, width, 3) u8 pixels of ``array``'s panel at ``size``
    (width, height): NEAREST to enlarge, BOX to shrink."""
    from PIL import Image

    rgb = image_rgb(array)
    grow = size[0] >= rgb.shape[1] and size[1] >= rgb.shape[0]
    method = Image.Resampling.NEAREST if grow else Image.Resampling.BOX
    return np.asarray(Image.fromarray(rgb).resize(size, method))


# --------------------------------- ticks ----------------------------------- #


def _nonsingular(lo: float, hi: float) -> tuple[float, float]:
    if hi - lo <= 1e-12 * max(abs(lo), abs(hi), 1e-300):
        if lo == 0 and hi == 0:
            return -0.05, 0.05
        return lo - 0.05 * abs(lo), hi + 0.05 * abs(hi)
    return lo, hi


def _autoscale(values: np.ndarray, from_zero: bool = False) -> tuple[float, float]:
    """Data limits with matplotlib's 5 % margins; ``from_zero`` keeps 0 as
    the lower limit of data that are not negative (a histogram's counts)."""
    values = values[np.isfinite(values)]
    if values.size == 0:
        return 0.0, 1.0
    lo, hi = _nonsingular(float(values.min()), float(values.max()))
    span = hi - lo
    return (0.0 if from_zero and lo >= 0 else lo - 0.05 * span), hi + 0.05 * span


def _nice_ticks(lo: float, hi: float, length_px: float,
                horizontal: bool) -> tuple[np.ndarray, list]:
    """Tick values in [lo, hi] at a step of 1, 2, 2.5 or 5 times a power of
    ten, as many as the axis has room for (matplotlib's rule: one per three
    label heights along x, two along y, at most 9 intervals), and their
    labels."""
    lo, hi = min(lo, hi), max(lo, hi)
    room = length_px / PT / (TICK_PT * (3 if horizontal else 2))
    nbins = int(np.clip(np.floor(room), 1, 9))
    raw = (hi - lo) / nbins
    mag = 10.0 ** np.floor(np.log10(raw))
    step = next(s * mag for s in (1, 2, 2.5, 5, 10) if s * mag >= raw * (1 - 1e-9))
    first = np.ceil(lo / step - 1e-9) * step
    values = first + step * np.arange(int(np.floor((hi - first) / step + 1e-9)) + 1)
    values[np.abs(values) < step * 1e-9] = 0.0
    decimals = max(0, -int(np.floor(np.log10(step) + 1e-9)))
    if abs(round(step * 10 ** decimals) - step * 10 ** decimals) > 1e-6:
        decimals += 1
    if decimals > 5:
        return values, [f"{v:.2e}" for v in values]
    return values, [f"{v:.{decimals}f}" for v in values]


# --------------------------------- axes ------------------------------------ #


@dataclass
class Line:
    x: np.ndarray
    y: np.ndarray
    label: str | None
    color: tuple[int, int, int]


@dataclass
class Hist:
    counts: np.ndarray
    edges: np.ndarray
    color: tuple[int, int, int]
    edgecolor: str | None


class Axes:
    """One panel: what it was given, kept as given, and its drawing."""

    def __init__(self):
        self.images: list[np.ndarray] = []
        self.lines: list[Line] = []
        self.hists: list[Hist] = []
        self.title, self.title_pt = "", TITLE_PT
        self.xlabel, self.xlabel_pt = "", LABEL_PT
        self.ylabel, self.ylabel_pt = "", LABEL_PT
        self.ylabel_rotation, self.ylabel_pad = 90, 4.0
        self.legend_labels: list[str] | None = None
        self.grid_on = False
        self.axis_on = True  # off: no frame, ticks nor axis labels (the title stays)
        self.frame_on = True  # off: no frame nor ticks (the axis labels stay)
        self.box: tuple[int, int, int, int] | None = None  # [x0, x1) x [y0, y1), by layout
        self.legend_box: tuple[int, int, int, int] | None = None  # by drawing

    # matplotlib's calls
    def imshow(self, array) -> None:
        image_rgb(array)  # refuses what it cannot draw
        self.images.append(np.array(array, copy=True))

    def plot(self, *args, label: str | None = None) -> None:
        if len(args) == 1:
            y = np.asarray(args[0], float)
            x = np.arange(len(y), dtype=float)
        else:
            x, y = np.asarray(args[0], float), np.asarray(args[1], float)
        if x.shape != y.shape or x.ndim != 1:
            raise ValueError(f"plot takes two 1-D series of one length, got {x.shape}, {y.shape}")
        self.lines.append(Line(x, y, label, COLORS[len(self.lines) % len(COLORS)]))

    def hist(self, x, bins=10, edgecolor=None) -> None:
        """Bars of ``np.histogram``'s counts over its edges, as matplotlib's."""
        counts, edges = np.histogram(np.asarray(x), bins=bins)
        self.hists.append(Hist(counts, edges, COLORS[0], edgecolor))

    def set_title(self, text: str, fontsize: float | None = None) -> None:
        self.title, self.title_pt = str(text), fontsize or TITLE_PT

    def set_xlabel(self, text: str, fontsize: float | None = None) -> None:
        self.xlabel, self.xlabel_pt = str(text), fontsize or LABEL_PT

    def set_ylabel(self, text: str, rotation: float = 90, labelpad: float = 4.0,
                   fontsize: float | None = None) -> None:
        if rotation not in (0, 90):
            raise ValueError(f"y labels turn by 0 or 90 degrees, not {rotation}")
        self.ylabel, self.ylabel_pt = str(text), fontsize or LABEL_PT
        self.ylabel_rotation, self.ylabel_pad = rotation, labelpad

    def legend(self) -> None:
        self.legend_labels = [line.label for line in self.lines if line.label]

    def grid(self, visible: bool = True) -> None:
        self.grid_on = visible

    def axis(self, state: str) -> None:
        if state not in ("on", "off"):
            raise ValueError(f"axis takes 'on' or 'off', not {state!r}")
        self.axis_on = state == "on"

    def hide_frame(self) -> None:
        """No frame, no ticks and no tick labels; the axis labels stay."""
        self.frame_on = False

    # geometry
    def limits(self) -> tuple[tuple[float, float], tuple[float, float]]:
        """((x at the left, x at the right), (y at the bottom, y at the top))."""
        if self.images:
            h, w = self.images[0].shape[:2]
            return (-0.5, w - 0.5), (h - 0.5, -0.5)
        xs = [np.zeros(0)] + [ln.x for ln in self.lines] + [h.edges for h in self.hists]
        ys = [np.zeros(0)] + [ln.y for ln in self.lines] + [h.counts for h in self.hists]
        return (_autoscale(np.concatenate(xs)),
                _autoscale(np.concatenate(ys).astype(float), from_zero=bool(self.hists)))

    def to_pixels(self, x, y) -> tuple[np.ndarray, np.ndarray]:
        """The canvas pixel (column, row) of data points, as floats: the
        limits map to the box's first and last pixels."""
        x0, y0, x1, y1 = self.box
        (xa, xb), (ya, yb) = self.limits()
        px = x0 + (np.asarray(x, float) - xa) / (xb - xa) * (x1 - 1 - x0)
        py = (y1 - 1) - (np.asarray(y, float) - ya) / (yb - ya) * (y1 - 1 - y0)
        return px, py

    def fit(self, cell: tuple[int, int, int, int]) -> tuple[int, int, int, int]:
        """The box in a cell: an image's panel centred, else the cell."""
        if not self.images:
            return cell
        cx0, cy0, cx1, cy1 = cell
        w, h = panel_size(self.images[0].shape[:2], (cx1 - cx0, cy1 - cy0))
        x0, y0 = cx0 + (cx1 - cx0 - w) // 2, cy0 + (cy1 - cy0 - h) // 2
        return x0, y0, x0 + w, y0 + h

    def _ticks(self):
        """([(pixel column, label)] along x, [(pixel row, label)] along y)."""
        if not (self.axis_on and self.frame_on):
            return [], []
        x0, y0, x1, y1 = self.box
        (xa, xb), (ya, yb) = self.limits()
        xv, xl = _nice_ticks(xa, xb, x1 - x0, True)
        yv, yl = _nice_ticks(ya, yb, y1 - y0, False)
        px, _ = self.to_pixels(xv, np.full_like(xv, ya))
        _, py = self.to_pixels(np.full_like(yv, xa), yv)
        return list(zip(np.round(px).astype(int), xl)), list(zip(np.round(py).astype(int), yl))

    def _texts(self, draw, xt, yt) -> list[_Text]:
        """The title, tick labels and axis labels, placed around the box."""
        x0, y0, x1, y1 = self.box
        out = [_Text(draw, s, TICK_PT, p, y1 + TICK_LEN + TICK_PAD, "center", "top")
               for p, s in xt]
        out += [_Text(draw, s, TICK_PT, x0 - 1 - TICK_LEN - TICK_PAD, p, "right", "center")
                for p, s in yt]
        below = max([t.y0 + t.h for t in out[:len(xt)]], default=y1)
        left = min([t.x0 for t in out[len(xt):]], default=x0 - 1)
        if self.title:
            out.append(_Text(draw, self.title, self.title_pt, (x0 + x1) / 2,
                             y0 - 1 - TITLE_PAD, "center", "bottom"))
        if self.axis_on and self.xlabel:
            out.append(_Text(draw, self.xlabel, self.xlabel_pt, (x0 + x1) / 2,
                             below + round(4 * PT), "center", "top"))
        if self.axis_on and self.ylabel:
            at = left - self.ylabel_pad * PT
            if self.ylabel_rotation == 90:
                out.append(_Text(draw, self.ylabel, self.ylabel_pt, at, (y0 + y1) / 2, "right",
                                 "center", vertical=True))
            else:
                out.append(_Text(draw, self.ylabel, self.ylabel_pt, at, (y0 + y1) / 2, "center",
                                 "bottom"))
        return out

    def extents(self, draw) -> tuple[int, int, int, int]:
        """How far the decorations reach beyond the box: (left, right, top,
        bottom) pixels."""
        x0, y0, x1, y1 = self.box
        xt, yt = self._ticks()
        boxes = [t.bbox() for t in self._texts(draw, xt, yt)]
        boxes.append((x0 - 1 - (TICK_LEN if yt else 0), y0 - 1, x1 + 1,
                      y1 + 1 + (TICK_LEN if xt else 0)))
        b = np.asarray(boxes)
        return (max(0, x0 - b[:, 0].min()), max(0, b[:, 2].max() - x1),
                max(0, y0 - b[:, 1].min()), max(0, b[:, 3].max() - y1))

    def draw(self, canvas, draw) -> None:
        from PIL import Image

        x0, y0, x1, y1 = self.box
        for image in self.images:
            canvas.paste(Image.fromarray(panel_pixels(image, (x1 - x0, y1 - y0))), (x0, y0))
        xt, yt = self._ticks()
        if self.grid_on:
            for p, _ in xt:
                draw.line([(p, y0), (p, y1 - 1)], fill=GRID_COLOR, width=1)
            for p, _ in yt:
                draw.line([(x0, p), (x1 - 1, p)], fill=GRID_COLOR, width=1)
        for h in self.hists:
            px, top = self.to_pixels(h.edges[:-1], h.counts)
            px_end, base = self.to_pixels(h.edges[1:], np.zeros(len(h.counts)))
            for a, b, t, z in zip(np.round(px), np.round(px_end), np.round(top), np.round(base)):
                draw.rectangle([int(a), int(t), int(b), int(z)], fill=h.color,
                               outline=h.edgecolor, width=1)
        for line in self.lines:
            px, py = self.to_pixels(line.x, line.y)
            ok = np.isfinite(px) & np.isfinite(py)
            for run in np.split(np.arange(len(px)), np.flatnonzero(np.diff(ok)) + 1):
                if len(run) > 1 and ok[run[0]]:
                    pts = [(int(a), int(b)) for a, b in zip(np.round(px[run]), np.round(py[run]))]
                    draw.line(pts, fill=line.color, width=LINE_WIDTH)
                    draw.line(pts, fill=line.color, width=1)  # a wide line can miss a vertex
        if self.axis_on and self.frame_on:
            draw.rectangle([x0 - 1, y0 - 1, x1, y1], outline=BLACK, width=1)
            for p, _ in xt:
                draw.line([(p, y1 + 1), (p, y1 + TICK_LEN)], fill=BLACK, width=1)
            for p, _ in yt:
                draw.line([(x0 - 1 - TICK_LEN, p), (x0 - 2, p)], fill=BLACK, width=1)
        for text in self._texts(draw, xt, yt):
            text.draw(canvas, draw)
        if self.legend_labels:
            self._draw_legend(canvas, draw)

    def _draw_legend(self, canvas, draw) -> None:
        """Entries (a line sample and its label) in a box at the first of
        matplotlib's 'best' places that covers the fewest line vertices."""
        em = round(LEGEND_PT * PT)
        pad, handle, gap, sep = round(0.4 * em), 2 * em, round(0.8 * em), round(0.5 * em)
        items = [(line, _Text(draw, line.label, LEGEND_PT, 0, 0, "left", "top"))
                 for line in self.lines if line.label]
        row = max(t.h for _, t in items)
        w = 2 * pad + handle + gap + max(t.w for _, t in items)
        h = 2 * pad + len(items) * row + (len(items) - 1) * sep
        x0, y0, x1, y1 = self.box
        m = round(0.5 * em)
        xs = {"l": x0 + m, "c": (x0 + x1 - w) // 2, "r": x1 - m - w}
        ys = {"t": y0 + m, "c": (y0 + y1 - h) // 2, "b": y1 - m - h}
        places = ["rt", "lt", "lb", "rb", "rc", "lc", "cb", "ct", "cc"]
        pts = [self.to_pixels(ln.x, ln.y) for ln in self.lines]
        px = np.concatenate([p[0] for p in pts])
        py = np.concatenate([p[1] for p in pts])

        def covered(place: str) -> int:
            bx, by = xs[place[0]], ys[place[1]]
            return int(((px >= bx) & (px < bx + w) & (py >= by) & (py < by + h)).sum())

        place = min(places, key=covered)  # the first of the least covered
        bx, by = xs[place[0]], ys[place[1]]
        self.legend_box = (bx, by, bx + w, by + h)
        draw.rectangle([bx, by, bx + w - 1, by + h - 1], fill=WHITE, outline=LEGEND_EDGE, width=1)
        for i, (line, text) in enumerate(items):
            cy = by + pad + i * (row + sep) + row // 2
            draw.line([(bx + pad, cy), (bx + pad + handle, cy)], fill=line.color,
                      width=LINE_WIDTH)
            text.x0, text.y0 = bx + pad + handle + gap, cy - text.h // 2
            text.draw(canvas, draw)


# -------------------------------- figures ---------------------------------- #


class Figure:
    """A grid of :class:`Axes` on a canvas of ``figsize * 100`` pixels."""

    def __init__(self, nrows: int = 1, ncols: int = 1, figsize=DEFAULT_FIGSIZE):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.size = (round(self.figsize[0] * DPI), round(self.figsize[1] * DPI))
        self.grid = np.empty((nrows, ncols), dtype=object)
        for i in range(nrows):
            for j in range(ncols):
                self.grid[i, j] = Axes()
        self.axes: list[Axes] = list(self.grid.flat)
        self.suptitle_text: str | None = None
        self.tight = False

    def suptitle(self, text: str) -> None:
        self.suptitle_text = str(text)

    def tight_layout(self) -> None:
        """Margins and gaps fitted to the decorations, with matplotlib's pad
        of 1.08 font sizes."""
        self.tight = True

    def _place(self, left, right, bottom, top, wspace, hspace) -> None:
        (W, H), (rows, cols) = self.size, self.grid.shape
        cell_w = (right - left) / (cols + wspace * (cols - 1))
        cell_h = (top - bottom) / (rows + hspace * (rows - 1))
        for (i, j), ax in np.ndenumerate(self.grid):
            fx = left + j * cell_w * (1 + wspace)
            fy = top - i * cell_h * (1 + hspace)
            ax.box = ax.fit((round(fx * W), round((1 - fy) * H), round((fx + cell_w) * W),
                             round((1 - fy + cell_h) * H)))

    def _suptitle(self, draw) -> _Text | None:
        if self.suptitle_text is None:
            return None
        return _Text(draw, self.suptitle_text, TITLE_PT, self.size[0] / 2, 0.02 * self.size[1],
                     "center", "top")

    def layout(self) -> None:
        """Set every Axes' box (matplotlib's default margins, or fitted)."""
        self._place(*SUBPLOTS)
        if not self.tight:
            return
        (W, H), (rows, cols) = self.size, self.grid.shape
        draw = _measurer()
        ext = np.array([[ax.extents(draw) for ax in row] for row in self.grid], float)
        pad = 1.08 * LABEL_PT * PT
        sup = self._suptitle(draw)
        top_taken = sup.y0 + sup.h if sup else 0
        left = (ext[:, 0, 0].max() + pad) / W
        right = 1 - (ext[:, -1, 1].max() + pad) / W
        top = 1 - (max(top_taken, 0) + ext[0, :, 2].max() + pad) / H
        bottom = (ext[-1, :, 3].max() + pad) / H
        gap_w = max([(ext[:, j, 1] + ext[:, j + 1, 0]).max() for j in range(cols - 1)],
                    default=0) + pad
        gap_h = max([(ext[i, :, 3] + ext[i + 1, :, 2]).max() for i in range(rows - 1)],
                    default=0) + pad
        cell_w = ((right - left) * W - (cols - 1) * gap_w) / cols
        cell_h = ((top - bottom) * H - (rows - 1) * gap_h) / rows
        if cell_w > 0 and cell_h > 0:  # else the decorations do not fit: keep the defaults
            self._place(left, right, bottom, top, gap_w / cell_w, gap_h / cell_h)

    def render(self):
        """The figure as a PIL RGB image."""
        from PIL import Image, ImageDraw

        self.layout()
        canvas = Image.new("RGB", self.size, WHITE)
        draw = ImageDraw.Draw(canvas)
        for ax in self.axes:
            ax.draw(canvas, draw)
        sup = self._suptitle(draw)
        if sup:
            sup.draw(canvas, draw)
        return canvas

    def savefig(self, path: str) -> None:
        self.render().save(path, format="PNG")


def new_figure(nrows: int = 1, ncols: int = 1, squeeze: bool = True,
               figsize=DEFAULT_FIGSIZE):
    """(figure, axes) as ``plt.subplots`` gives them: one Axes, a 1-D array
    of them for one row or column, else a 2-D array (always 2-D without
    ``squeeze``)."""
    fig = Figure(nrows, ncols, figsize)
    if not squeeze:
        return fig, fig.grid
    return fig, (fig.grid.item() if fig.grid.size == 1 else fig.grid.squeeze())


def save_figure(fig: Figure, outdir: str, name: str) -> str:
    """Write ``fig`` to ``{outdir}/{name}.png`` (the directory made if
    missing) and return the path."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{name}.png")
    fig.savefig(path)
    return path


def plot_grid(images: np.ndarray, title: str, column_titles: list[str], row_titles: list[str],
              outdir: str = ".", name: str = "grid") -> str:
    """A grid of images with row and column titles; ``images`` (rows, cols,
    H, W, 3). Returns the PNG's path."""
    rows, cols = len(row_titles), len(column_titles)
    fig, axes = new_figure(rows, cols, figsize=(15, 5 * rows))
    fig.suptitle(title)
    axes = np.atleast_2d(axes)
    for i in range(rows):
        for j in range(cols):
            ax = axes[i, j]
            ax.imshow(images[i, j])
            if i == 0:
                ax.set_title(column_titles[j])
            if j == 0:
                ax.set_ylabel(row_titles[i], rotation=0, labelpad=40)
            ax.hide_frame()
    return save_figure(fig, outdir, name)


def plot_amplified_images_batch(originals, images, multipliers, labels=None, outdir: str = ".",
                                name: str = "amplify") -> str:
    """Rows of [original | amplified x m ...]. Returns the PNG's path."""
    from viscoin_tpu_torch.utils.images import from_torch

    np_rows = [[from_torch(img) for img in row] for row in images]
    np_orig = [from_torch(o) for o in originals]
    num_rows, num_cols = len(images), len(multipliers) + 1
    fig, axs = new_figure(num_rows, num_cols, figsize=(15, 5 * num_rows))
    fig.suptitle("Amplification of best concepts for an image")
    axs = np.atleast_2d(np.asarray(axs))
    for i, (orig, row) in enumerate(zip(np_orig, np_rows)):
        axs[i, 0].imshow(orig)
        axs[i, 0].axis("off")
        if labels is not None:
            axs[i, 0].set_title(f"Predicted Label : {labels[i]}\nOriginal")
        elif i == 0:
            axs[i, 0].set_title("Original")
        for j, (img, mult) in enumerate(zip(row, multipliers)):
            axs[i, j + 1].imshow(img)
            axs[i, j + 1].axis("off")
            if i == 0:
                axs[i, j + 1].set_title(f"Multiplier: {mult:.2f}")
    return save_figure(fig, outdir, name)
