"""The port's figures (``viscoin_tpu_torch/utils/plotting.py``: numpy and PIL,
no matplotlib) against the JAX package's matplotlib figures, on the CPU.

Each figure of the analysis commands is built from the same seeded inputs by
both packages: the JAX function under matplotlib's Agg backend with
``pyplot.show`` patched to keep the figure (its histograms read through a
wrapper of ``Axes.hist``), the port's with ``save_figure`` patched to keep
its Figure. Their texts, image arrays, line data, histogram counts and
edges, and grids must be equal. ``concept-heatmaps`` draws inside the JAX
command, so its panels are held against the JAX package's ``overlay`` of
``from_jax`` and ``heatmap_to_img`` on the same arrays. Then the raster:
each PNG is ``figsize * 100`` pixels, each image panel is exactly the stated
resampling of its array, sampled line vertices lie where ``to_pixels`` puts
them, two renders are the same bytes; and the colour maps equal
matplotlib's."""

import os
import sys

import matplotlib
import matplotlib.axes
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from matplotlib import cm, colors
from PIL import Image
from viscoin_tpu_torch.cli import concept_heatmaps as TH
from viscoin_tpu_torch.cli import logs as TL
from viscoin_tpu_torch.eval import concepts as TC
from viscoin_tpu_torch.utils import colormaps as CM
from viscoin_tpu_torch.utils import images as TI
from viscoin_tpu_torch.utils import plotting as TP
from viscoin_tpu_torch.utils import types as TT

from viscoin_tpu.cli import logs as JL
from viscoin_tpu.eval import concepts as JC
from viscoin_tpu.utils import images as JI
from viscoin_tpu.utils import plotting as JP
from viscoin_tpu.utils import types as JT


matplotlib.use("Agg")

K, C = 12, 5  # concepts, classes
MULTIPLIERS = [0.0, 1.0, 2.0, 4.0]
CONCEPT_PLOTS = ["concept_activation_per_concept", "concept_activation_per_image",
                 "class_concept_correlations", "concept_class_correlations", "concept_entropies"]
FIGURES = ["plot_grid", "amplified", "amplified_labels", *CONCEPT_PLOTS, "training_losses",
           "testing_losses", "preds_overlap", "gan_logs", "training_curves"]
# The JAX command's columns (viscoin_tpu/cli/concept_heatmaps.py).
HEATMAP_COLUMNS = ["original", "conv1 from hidden_state[-3]", "conv2 from hidden_state[-2]",
                   "conv3 from hidden_state[-1]", "conv4 after concat", "conv5 after conv4"]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    concept = dict(
        classifier_accuracy=0.5, explainer_accuracy=0.25,
        concept_activation_per_image=rng.uniform(0, 1, K),
        concept_activation_per_concept=np.sort(rng.uniform(0, 1, K)),
        raw_concept_mean_activation=rng.uniform(0, 1, K),
        concept_correlations=rng.uniform(0, 1, (K, K)),
        class_concept_correlations=rng.uniform(0, 1, (C, K)),
        concept_class_correlations=rng.uniform(0, 1, (K, C)),
        concept_entropy=rng.uniform(0, 1, K), class_counts=rng.integers(1, 9, C).astype(float))
    train_keys = list(TT.TrainingResults.__dataclass_fields__)
    test_keys = [k for k in TT.TestingResults.__dataclass_fields__ if k != "fid_score"]
    gan = [{"iteration": 100 * i, "g_loss": float(rng.uniform(0, 2)),
            "d_loss": float(rng.uniform(0, 2)), "r1": 0.1 * i,
            **({"pl_mean": 0.5 + 0.01 * i} if i % 2 else {})} for i in range(8)]
    gan.append({"iteration": 800, "fid": 41.5})
    scalars = [{"epoch": i, "train_accuracy": 0.1 * i, "test_accuracy": 0.08 * i,
                "train_loss": 2.0 - 0.2 * i, "note": "x", **({"lr": 1e-3} if i < 3 else {})}
               for i in range(6)]
    return {
        "grid": rng.uniform(0, 1, (2, 5, 24, 24, 3)).astype(np.float32),  # NEAREST panels
        "originals": rng.uniform(-1, 1, (2, 300, 300, 3)).astype(np.float32),  # BOX panels
        "amplified": [[rng.uniform(-1, 1, (300, 300, 3)).astype(np.float32)
                       for _ in MULTIPLIERS] for _ in range(2)],
        "concept": concept,
        "training": [{k: float(rng.uniform(0, 1)) for k in train_keys} for _ in range(6)],
        "testing": [{k: float(rng.uniform(0, 1)) for k in test_keys} for _ in range(6)],
        "gan": gan, "scalars": scalars,
    }


def port_drawer(name: str, x: dict):
    """``outdir -> path`` drawing the port's figure ``name``."""
    grid_args = (x["grid"], "W+ amplification along PCA component",
                 ["x0", "x1", "x5", "x10", "x15"], ["Component 1", "Component 2"])
    if name == "plot_grid":
        return lambda out: TP.plot_grid(*grid_args, outdir=out)
    if name in ("amplified", "amplified_labels"):
        labels = [3, 17] if name == "amplified_labels" else None
        return lambda out: TP.plot_amplified_images_batch(x["originals"], x["amplified"],
                                                          MULTIPLIERS, labels, outdir=out)
    if name in CONCEPT_PLOTS:
        return lambda out: getattr(TC.ConceptTestResults(**x["concept"]), f"plot_{name}")(out)
    if name == "training_losses":
        return lambda out: TT.TrainingResults.plot_losses(
            [TT.TrainingResults(**r) for r in x["training"]], out)
    if name in ("testing_losses", "preds_overlap"):
        method = "plot_losses" if name == "testing_losses" else "plot_preds_overlap"
        return lambda out: getattr(TT.TestingResults, method)(
            [TT.TestingResults(**r) for r in x["testing"]], out)
    if name == "gan_logs":
        return lambda out: TL.plot_gan_logs(x["gan"], out)
    assert name == "training_curves"
    return lambda out: TL.plot_scalar_logs(x["scalars"], "training curves", out)


def jax_drawer(name: str, x: dict):
    """The JAX package's call that shows the same figure."""
    grid_args = (x["grid"], "W+ amplification along PCA component",
                 ["x0", "x1", "x5", "x10", "x15"], ["Component 1", "Component 2"])
    if name == "plot_grid":
        return lambda: JP.plot_grid(*grid_args)
    if name in ("amplified", "amplified_labels"):
        labels = [3, 17] if name == "amplified_labels" else None
        return lambda: JP.plot_amplified_images_batch(x["originals"], x["amplified"],
                                                      MULTIPLIERS, labels)
    if name in CONCEPT_PLOTS:
        return lambda: getattr(JC.ConceptTestResults(**x["concept"]), f"plot_{name}")()
    if name == "training_losses":
        return lambda: JT.TrainingResults.plot_losses(
            [JT.TrainingResults(**r) for r in x["training"]])
    if name in ("testing_losses", "preds_overlap"):
        method = "plot_losses" if name == "testing_losses" else "plot_preds_overlap"
        return lambda: getattr(JT.TestingResults, method)(
            [JT.TestingResults(**r) for r in x["testing"]])
    if name == "gan_logs":
        return lambda: JL._plot_gan_logs(x["gan"])
    assert name == "training_curves"
    return lambda: JL._plot_scalar_logs(x["scalars"], "training curves")


def port_figure(monkeypatch, outdir: str, draw) -> tuple[TP.Figure, str]:
    kept = []
    save = TP.save_figure

    def keep(fig, out, name):
        kept.append((fig, save(fig, out, name)))
        return kept[-1][1]

    monkeypatch.setattr(TP, "save_figure", keep)
    draw(outdir)
    assert len(kept) == 1
    return kept[0]


def jax_figure(monkeypatch, draw):
    """(the matplotlib figure the JAX call showed, {axes: (counts, edges)})."""
    shown, hists = [], {}
    hist = matplotlib.axes.Axes.hist

    def record(self, x, *args, **kwargs):
        out = hist(self, x, *args, **kwargs)
        hists[self] = (out[0], out[1])
        return out

    monkeypatch.setattr(matplotlib.axes.Axes, "hist", record)
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(plt.gcf()))
    plt.close("all")
    draw()
    assert len(shown) == 1
    return shown[0], hists


def assert_same_figure(port: TP.Figure, fig, hists: dict) -> None:
    assert port.figsize == tuple(fig.get_size_inches())
    assert port.size == tuple(int(round(v)) for v in fig.get_size_inches() * fig.dpi)
    assert (port.suptitle_text or "") == fig.get_suptitle()
    assert len(port.axes) == len(fig.axes)
    for i, (p, m) in enumerate(zip(port.axes, fig.axes)):
        where = f"axes {i}"
        assert (p.title, p.title_pt) == (m.get_title(), m.title.get_fontsize()), where
        assert p.xlabel == m.get_xlabel() and p.ylabel == m.get_ylabel(), where
        if p.ylabel:
            assert p.ylabel_pt == m.yaxis.label.get_fontsize(), where
            assert p.ylabel_rotation == m.yaxis.label.get_rotation(), where
            assert p.ylabel_pad == m.yaxis.labelpad, where
        legend = m.get_legend()
        assert p.legend_labels == ([t.get_text() for t in legend.get_texts()]
                                   if legend else None), where
        assert p.axis_on == m.axison, where
        assert p.frame_on == any(s.get_visible() for s in m.spines.values()), where
        assert p.grid_on == any(g.get_visible() for g in m.get_xgridlines()), where
        want_images = [im.get_array() for im in m.get_images()]
        assert len(p.images) == len(want_images), where
        for got, want in zip(p.images, want_images):
            assert got.dtype == want.dtype, where
            np.testing.assert_array_equal(got, np.ma.getdata(want), err_msg=where)
        lines = m.get_lines()
        assert len(p.lines) == len(lines), where
        for got, want in zip(p.lines, lines):
            np.testing.assert_array_equal(got.x, np.asarray(want.get_xdata(), float))
            np.testing.assert_array_equal(got.y, np.asarray(want.get_ydata(), float))
            label = want.get_label()
            assert got.label == (None if label.startswith("_") else label), where
        assert len(p.hists) == (1 if m in hists else 0), where
        for h in p.hists:
            counts, edges = hists[m]
            np.testing.assert_array_equal(h.counts, counts, err_msg=where)
            np.testing.assert_array_equal(h.edges, edges, err_msg=where)
            assert h.edgecolor == "black"


@pytest.mark.parametrize("name", FIGURES)
def test_figure_matches_jax(inputs, monkeypatch, tmp_path, name):
    port, _ = port_figure(monkeypatch, str(tmp_path), port_drawer(name, inputs))
    fig, hists = jax_figure(monkeypatch, jax_drawer(name, inputs))
    try:
        assert_same_figure(port, fig, hists)
    finally:
        plt.close("all")


def heatmap_inputs():
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (5, 3, 32, 32)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4])
    heatmaps = {f"conv{i}": rng.uniform(0, 1, (5, 4, 4)).astype(np.float32)
                for i in range(1, 6)}
    logits = rng.standard_normal((5, C)).astype(np.float32)
    logits[0, 0] = 5.0  # one explainer prediction right
    return images, labels, heatmaps, logits


def test_concept_heatmaps_figure_matches_jax(monkeypatch, tmp_path):
    """The JAX command's figure (viscoin_tpu/cli/concept_heatmaps.py:47-66),
    its panels from the JAX package's from_jax, heatmap_to_img and overlay."""
    images, labels, heatmaps, logits = heatmap_inputs()
    port, _ = port_figure(monkeypatch, str(tmp_path), lambda out: TH.draw_heatmaps(
        torch.from_numpy(images), labels, heatmaps, logits, out))
    assert port.figsize == (20.0, 10.0) and port.grid.shape == (5, 6)
    assert port.suptitle_text == "GradCAM heatmaps of the concept extractor convolutional layers"
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    nhwc = images.transpose(0, 2, 3, 1)
    for row in range(5):
        want = f"{labels[row] == logits[row].argmax()} with {100 * probs[row].max():.0f}%"
        assert (port.grid[row, 0].ylabel, port.grid[row, 0].ylabel_pt) == (want, 8)
        base = JI.from_jax(nhwc[row])
        np.testing.assert_array_equal(port.grid[row, 0].images[0], base)
        for col in range(6):
            ax = port.grid[row, col]
            assert (ax.title, ax.title_pt) == ((HEATMAP_COLUMNS[col], 8) if row == 0
                                               else ("", TP.TITLE_PT))
            assert ax.axis_on == (col == 0) and len(ax.images) == 1
            if col:
                over = JI.overlay((base * 255).astype(np.uint8), JI.heatmap_to_img(
                    heatmaps[f"conv{col}"][row], size=base.shape[0]))
                np.testing.assert_array_equal(ax.images[0], over)
    assert port.grid[1, 0].ylabel.startswith("False")
    assert port.grid[0, 0].ylabel.startswith("True")


def _all_drawers(x: dict) -> dict:
    drawers = {name: port_drawer(name, x) for name in FIGURES}
    drawers["concept_heatmaps"] = lambda out: TH.draw_heatmaps(*heatmap_inputs(), out)
    return drawers


@pytest.mark.parametrize("name", FIGURES + ["concept_heatmaps"])
def test_png_is_the_stated_raster(inputs, monkeypatch, tmp_path, name):
    draw = _all_drawers(inputs)[name]
    fig, path = port_figure(monkeypatch, str(tmp_path / "a"), draw)
    png = np.asarray(Image.open(path))
    assert png.shape == (round(fig.figsize[1] * 100), round(fig.figsize[0] * 100), 3)
    panels = lines = bars = 0
    for ax in fig.axes:
        x0, y0, x1, y1 = ax.box
        assert 0 <= x0 < x1 <= fig.size[0] and 0 <= y0 < y1 <= fig.size[1]
        if ax.images:
            panels += 1
            rgb = TP.image_rgb(ax.images[-1])
            h, w = rgb.shape[:2]
            if (x1 - x0) >= w:  # enlarged: whole pixels, NEAREST
                k = (x1 - x0) // w
                assert (x1 - x0, y1 - y0) == (w * k, h * k)
                want = rgb.repeat(k, axis=0).repeat(k, axis=1)
            else:  # shrunk: aspect kept, BOX
                assert abs((x1 - x0) / (y1 - y0) - w / h) <= 1.5 / min(y1 - y0, x1 - x0)
                want = np.asarray(Image.fromarray(rgb).resize((x1 - x0, y1 - y0),
                                                              Image.Resampling.BOX))
            np.testing.assert_array_equal(TP.panel_pixels(ax.images[-1], (x1 - x0, y1 - y0)),
                                          want)
            np.testing.assert_array_equal(png[y0:y1, x0:x1], want)
        drawn = [ln for ln in ax.lines if len(ln.x) > 1]  # a single point draws nothing
        if drawn:  # the last line's vertices, where the legend does not cover them
            line = drawn[-1]
            px, py = (np.round(v).astype(int) for v in ax.to_pixels(line.x, line.y))
            if ax.legend_box:
                lx0, ly0, lx1, ly1 = ax.legend_box
                keep = ~((px >= lx0) & (px < lx1) & (py >= ly0) & (py < ly1))
                px, py = px[keep], py[keep]
            assert len(px) >= 2
            lines += len(px)
            assert (png[py, px] == np.asarray(line.color, np.uint8)).all(), line.label
        for h in ax.hists:  # each bar's middle pixel, inside its black edge
            px, py = ax.to_pixels((h.edges[:-1] + h.edges[1:]) / 2, h.counts / 2)
            _, top = ax.to_pixels(h.edges[1:], h.counts)
            tall = (np.round(py) - np.round(top)) >= 2
            bars += int(tall.sum())
            got = png[np.round(py[tall]).astype(int), np.round(px[tall]).astype(int)]
            assert (got == np.asarray(h.color, np.uint8)).all()
    assert panels + lines + bars > 0
    _, again = port_figure(monkeypatch, str(tmp_path / "b"), draw)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_panel_placement_and_line_map():
    """The panel rules on explicit numbers, and to_pixels at the limits."""
    assert TP.panel_size((10, 8), (496, 369)) == (8 * 36, 10 * 36)  # NEAREST x36
    assert TP.panel_size((256, 256), (200, 350)) == (200, 200)  # BOX
    assert TP.panel_size((200, 256), (496, 369)) == (256, 200)  # fits once: x1
    assert TP.panel_size((300, 600), (200, 200)) == (200, 100)
    fig, ax = TP.new_figure()
    ax.plot([0.0, 1.0, 2.0], [10.0, -10.0, 30.0], label="a")
    fig.layout()
    x0, y0, x1, y1 = ax.box
    assert ax.box == (80, 58, 576, 427)  # matplotlib's default margins on 640 x 480
    (xa, xb), (ya, yb) = ax.limits()
    assert (xa, xb) == pytest.approx((-0.1, 2.1)) and (ya, yb) == pytest.approx((-12, 32))
    px, py = ax.to_pixels([xa, xb], [ya, yb])
    np.testing.assert_allclose(px, [x0, x1 - 1])
    np.testing.assert_allclose(py, [y1 - 1, y0])
    _, axes = TP.new_figure(2, 3)
    assert axes.shape == (2, 3)
    _, axes = TP.new_figure(1, 2)
    assert axes.shape == (2,)
    with pytest.raises(ValueError, match="imshow takes"):
        ax.imshow(np.zeros((4, 4, 2)))


def test_colormaps_equal_matplotlibs():
    """jet's and viridis's tables, their lookups of random values (both
    float types, the ends, outside [0, 1], NaN) and the 2-D imshow colours
    (min-max normalized, viridis, u8) equal matplotlib's."""
    for table, cmap in ((CM.JET, matplotlib.colormaps["jet"]),
                        (CM.VIRIDIS, matplotlib.colormaps["viridis"])):
        np.testing.assert_array_equal(table, cmap(np.arange(256))[:, :3])
        rng = np.random.default_rng(2)
        for dtype in (np.float32, np.float64):
            x = rng.uniform(-0.2, 1.2, (64, 9)).astype(dtype)
            x[0, :5] = [0.0, 1.0, np.nan, -np.inf, np.inf]
            x[1] = rng.uniform(0, 1, 9)
            np.testing.assert_array_equal(CM.lookup(table, x), cmap(x))
    np.testing.assert_array_equal(CM.JET, cm.jet(np.arange(256))[:, :3])
    rng = np.random.default_rng(3)
    for a in (rng.uniform(-3, 5, (7, 11)), rng.uniform(0, 1, (5, 4)).astype(np.float32)):
        want = cm.ScalarMappable(norm=colors.Normalize(), cmap="viridis").to_rgba(a, bytes=True)
        np.testing.assert_array_equal(TP.image_rgb(a), want[..., :3])


def test_heatmap_to_img_without_cv2_matches_jax(monkeypatch):
    """Where cv2 is missing (the card's machine), both packages take jet and
    a PIL bicubic resize: bit-equal."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(4)
    for heat, size in ((rng.uniform(0, 1, (4, 4)).astype(np.float32), 16),
                       (rng.standard_normal((1, 7, 5)), 32), (np.ones((3, 3)), 8)):
        np.testing.assert_array_equal(TI.heatmap_to_img(heat, size=size),
                                      JI.heatmap_to_img(heat, size))


def test_text_takes_newlines_and_the_font_is_pillows(tmp_path):
    """A two-line title is two lines high; labels with '%' draw; the font is
    Pillow's own (no file from the disk)."""
    fig, ax = TP.new_figure()
    ax.set_title("Predicted Label : 3\nOriginal")
    ax.set_ylabel("True with 87%", fontsize=8)
    ax.plot([1.0, 2.0])
    fig.layout()
    draw = TP._measurer()
    one = TP._Text(draw, "Original", TP.TITLE_PT, 0, 0, "left", "top")
    two = TP._Text(draw, ax.title, TP.TITLE_PT, 0, 0, "left", "top")
    assert two.h > 1.8 * one.h
    path = TP.save_figure(fig, str(tmp_path), "t")
    assert os.path.getsize(path) > 0
    assert TP.font_kind().startswith("Pillow ")
