"""The run's PNG figures: the confusion matrix and the t-SNE scatter.

The port's counterparts of ``otfusion_tpu.utils.plotting``, which draws
with matplotlib and embeds with scikit-learn's ``TSNE``; the machine the
port runs on has neither, so the figures are drawn on ``utils.raster``'s
canvas and the embedding is ``utils.tsne`` on the run's device. They show
what the JAX figures show, at matplotlib's pixel sizes (100 dpi):

  * ``confusion_matrix.png``, 1000 x 800: the count heatmap in ``Blues``
    (normalised from the smallest count to the largest, as ``imshow``
    does), each count written in white above half the largest and in black
    elsewhere, the short class names (``split("_")[0]``) as ticks,
    "Predicted", "True", the title "Confusion Matrix" and a colorbar;
  * ``tsne_best_val.png``, 800 x 600: the embedding scattered in
    ``coolwarm`` by label at alpha 0.7, "Dim 1", "Dim 2", the title, and a
    colorbar ticked at the labels.

Pixel equality with matplotlib is not the goal; the layout follows its
default figure (axes, ticks outward, colorbar at the right).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from otfusion_tpu_torch.metrics.classification import confusion_matrix
from otfusion_tpu_torch.utils.raster import Canvas, colormap, normalize
from otfusion_tpu_torch.utils.tsne import tsne

BLACK = (0.0, 0.0, 0.0)
WHITE = (1.0, 1.0, 1.0)
TITLE_PX = 16.7   # 12 pt
TICK_LEN = 5      # 3.5 pt
SPINE_PX = 1.1    # 0.8 pt
SCATTER_RADIUS = 4.5   # s = 36 pt^2 with its 1 pt edge
SCATTER_ALPHA = 0.7


def nice_ticks(lo: float, hi: float, max_ticks: int = 9):
    """Ticks on [lo, hi] at the smallest step of 1, 2, 2.5 or 5 times a
    power of ten that gives at most ``max_ticks`` of them."""
    if hi <= lo:
        return [lo]
    base = 10.0 ** math.floor(math.log10((hi - lo) / max_ticks))
    for step in (base, 2 * base, 2.5 * base, 5 * base, 10 * base):
        first = math.ceil(lo / step - 1e-9)
        last = math.floor(hi / step + 1e-9)
        if last - first + 1 <= max_ticks:
            return [k * step for k in range(first, last + 1)]
    return [lo, hi]


def tick_label(value: float, ticks) -> str:
    """The tick's text with as many decimals as the step needs."""
    step = abs(ticks[1] - ticks[0]) if len(ticks) > 1 else 1.0
    decimals = 0
    while decimals < 6 and abs(step * 10 ** decimals
                               - round(step * 10 ** decimals)) > 1e-6:
        decimals += 1
    text = f"{value:.{decimals}f}"
    return "0" if float(text) == 0.0 else text


def _frame(canvas: Canvas, x0, y0, x1, y1) -> None:
    for a, b, c, d in ((x0, y0, x1, y0), (x0, y1, x1, y1), (x0, y0, x0, y1),
                       (x1, y0, x1, y1)):
        canvas.line(a, b, c, d, BLACK, SPINE_PX)


def _colorbar(canvas: Canvas, box, cmap: str, vmin, vmax, ticks,
              alpha: float = 1.0) -> None:
    """A vertical colorbar in ``box`` (x0, y0, x1, y1), ``vmin`` at the
    bottom, ticked and labelled on the right."""
    x0, y0, x1, y1 = box
    h = y1 - y0
    rows = vmax - (np.arange(h) + 0.5) / h * (vmax - vmin)
    rgb = colormap(cmap, normalize(rows, vmin, vmax))
    rgb = alpha * rgb + (1.0 - alpha) * np.asarray(WHITE)
    canvas.image(x0, y0, np.repeat(rgb[:, None, :], x1 - x0, axis=1))
    _frame(canvas, x0, y0, x1, y1)
    for t in ticks:
        y = y1 - (t - vmin) / (vmax - vmin) * h if vmax > vmin else y1
        canvas.line(x1, y, x1 + TICK_LEN, y, BLACK, SPINE_PX)
        canvas.text(x1 + TICK_LEN + 4, y, tick_label(t, ticks), ha="left")


def draw_confusion_matrix(cm: np.ndarray, names: Sequence[str]):
    """The 1000 x 800 figure of the count matrix ``cm`` (n, n); returns
    (canvas, the pixel box (x0, y0, x1, y1) of each cell, (n, n, 4))."""
    cm = np.asarray(cm)
    n = cm.shape[0]
    canvas = Canvas(1000, 800)
    ax0, ay0, side = 96, 37, 705
    edges = np.round(np.linspace(0, side, n + 1)).astype(int)
    vmin, vmax = float(cm.min()), float(cm.max())
    colours = colormap("Blues", normalize(cm, vmin, vmax))
    boxes = np.zeros((n, n, 4), np.int64)
    for i in range(n):
        for j in range(n):
            box = (ax0 + edges[j], ay0 + edges[i], ax0 + edges[j + 1],
                   ay0 + edges[i + 1])
            boxes[i, j] = box
            canvas.rect(*box, colours[i, j])
    for i in range(n):
        for j in range(n):
            x0, y0, x1, y1 = boxes[i, j]
            canvas.text((x0 + x1) / 2, (y0 + y1) / 2, str(cm[i, j]),
                        WHITE if cm[i, j] > cm.max() / 2 else BLACK)
    ax1, ay1 = ax0 + side, ay0 + side
    _frame(canvas, ax0, ay0, ax1, ay1)
    for k, name in enumerate(names):
        c = ax0 + (edges[k] + edges[k + 1]) / 2
        canvas.line(c, ay1, c, ay1 + TICK_LEN, BLACK, SPINE_PX)
        canvas.text(c, ay1 + TICK_LEN + 3, name, va="top")
        r = ay0 + (edges[k] + edges[k + 1]) / 2
        canvas.line(ax0 - TICK_LEN, r, ax0, r, BLACK, SPINE_PX)
        canvas.text(ax0 - TICK_LEN - 4, r, name, ha="right")
    canvas.text((ax0 + ax1) / 2, ay1 + 27, "Predicted", va="top")
    canvas.text(ax0 - 44, (ay0 + ay1) / 2, "True", rotate=True)
    canvas.text((ax0 + ax1) / 2, ay0 - 5, "Confusion Matrix", size=TITLE_PX,
                va="bottom")
    _colorbar(canvas, (846, ay0, 881, ay1), "Blues", vmin, vmax,
              nice_ticks(vmin, vmax))
    return canvas, boxes


def draw_tsne(coords: np.ndarray, labels: Sequence[int], title: str):
    """The 800 x 600 scatter of ``coords`` (n, 2) coloured by ``labels``;
    returns (canvas, each point's pixel centre, (n, 2))."""
    coords = np.asarray(coords, np.float64)
    labels = np.asarray([int(v) for v in labels])
    canvas = Canvas(800, 600)
    ax0, ay0, ax1, ay1 = 62, 37, 640, 542
    lims = []
    for c in range(2):
        lo, hi = float(coords[:, c].min()), float(coords[:, c].max())
        pad = 0.05 * (hi - lo) if hi > lo else 0.5
        lims.append((lo - pad, hi + pad))
    (xlo, xhi), (ylo, yhi) = lims
    px = ax0 + (coords[:, 0] - xlo) / (xhi - xlo) * (ax1 - ax0)
    py = ay1 - (coords[:, 1] - ylo) / (yhi - ylo) * (ay1 - ay0)
    vmin, vmax = float(labels.min()), float(labels.max())
    colours = colormap("coolwarm", normalize(labels, vmin, vmax))
    for x, y, colour in zip(px, py, colours):
        canvas.disc(x, y, SCATTER_RADIUS, colour, SCATTER_ALPHA)
    _frame(canvas, ax0, ay0, ax1, ay1)
    xt = nice_ticks(xlo, xhi)
    for t in xt:
        x = ax0 + (t - xlo) / (xhi - xlo) * (ax1 - ax0)
        canvas.line(x, ay1, x, ay1 + TICK_LEN, BLACK, SPINE_PX)
        canvas.text(x, ay1 + TICK_LEN + 3, tick_label(t, xt), va="top")
    yt = nice_ticks(ylo, yhi)
    for t in yt:
        y = ay1 - (t - ylo) / (yhi - ylo) * (ay1 - ay0)
        canvas.line(ax0 - TICK_LEN, y, ax0, y, BLACK, SPINE_PX)
        canvas.text(ax0 - TICK_LEN - 4, y, tick_label(t, yt), ha="right")
    canvas.text((ax0 + ax1) / 2, ay1 + 27, "Dim 1", va="top")
    canvas.text(ax0 - 44, (ay0 + ay1) / 2, "Dim 2", rotate=True)
    canvas.text((ax0 + ax1) / 2, ay0 - 5, title, size=TITLE_PX, va="bottom")
    _colorbar(canvas, (678, ay0, 712, ay1), "coolwarm", vmin, vmax,
              sorted(set(labels.tolist())), alpha=SCATTER_ALPHA)
    return canvas, np.stack([px, py], axis=1)


def save_confusion_matrix_png(
    y_true: Sequence[int],
    y_pred: Sequence[int],
    class_names: Dict[str, int],
    save_path: str | Path,
) -> None:
    labels = sorted(class_names, key=class_names.get)
    short = [name.split("_")[0] for name in labels]
    cm = confusion_matrix(y_true, y_pred, len(labels))
    draw_confusion_matrix(cm, short)[0].save(save_path)


def save_tsne_png(
    features,
    labels: Sequence[int],
    save_path: str | Path,
    title: str = "t-SNE of Validation Predictions (Best Model)",
    seed: int = 42,
    device: str | torch.device = "cuda",
) -> None:
    """Embed ``features`` (n, d) with ``utils.tsne`` on ``device`` and draw
    the scatter. ``seed`` is the JAX function's; the PCA start draws
    nothing, so it does not move the embedding."""
    coords = tsne(features, device=device).embedding
    draw_tsne(coords, labels, title)[0].save(save_path)
