"""Debug visualization (JAX ``utils/viz.py``; the reference's ``debug``
config dumps — ProtoSAM.py:25-44, 292-347, 562-578;
validation_protosam.py:125-166).  Every plot takes tensors (on any device)
or arrays; matplotlib is imported at the first plot."""

from __future__ import annotations

import os

import numpy as np


def _np(x):
    """A tensor or array as a numpy array (tensors via the host, f32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ensure_dir(path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def plot_coarse_pred(query_image, pred, fg_prob=None,
                     path: str = "debug/coarse_pred.png"):
    plt = _mpl()
    _ensure_dir(path)
    fig, axes = plt.subplots(1, 2 if fg_prob is None else 3, figsize=(12, 5))
    axes = np.atleast_1d(axes)
    axes[0].imshow(_np(query_image), cmap="gray")
    axes[0].imshow(_np(pred), alpha=0.5)
    axes[0].set_title("coarse pred")
    if fg_prob is not None:
        axes[1].imshow(_np(fg_prob))
        axes[1].set_title("fg prob")
    fig.savefig(path)
    plt.close(fig)


def plot_connected_components(labels, image,
                              path: str = "debug/connected_components.png"):
    plt = _mpl()
    _ensure_dir(path)
    labels = _np(labels)
    rng = np.random.default_rng(0)
    color = np.zeros((*labels.shape, 3), np.uint8)
    for lb in np.unique(labels):
        if lb == 0:
            continue
        color[labels == lb] = rng.integers(0, 255, 3)
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(_np(image), cmap="gray")
    axes[0].set_title("image")
    axes[1].imshow(color)
    axes[1].set_title("components")
    fig.savefig(path)
    plt.close(fig)


def plot_prompts(image, pred, points=None, point_labels=None, boxes=None,
                 path: str = "debug/most_conf_points.png"):
    plt = _mpl()
    _ensure_dir(path)
    fig = plt.figure(figsize=(8, 8))
    img = _np(image).astype(np.float32)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    plt.imshow(img, cmap="gray")
    plt.imshow(_np(pred), alpha=0.4)
    if points is not None:
        pts = _np(points).reshape(-1, 2)
        labs = (_np(point_labels).reshape(-1)
                if point_labels is not None else np.ones(len(pts)))
        pos, neg = pts[labs == 1], pts[labs == 0]
        if len(pos):
            plt.scatter(pos[:, 0], pos[:, 1], c="lime", marker="*", s=150)
        if len(neg):
            plt.scatter(neg[:, 0], neg[:, 1], c="red", marker="*", s=150)
    if boxes is not None:
        for box in _np(boxes).reshape(-1, 4):
            x0, y0, x1, y1 = box
            plt.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], c="green")
    fig.savefig(path)
    plt.close(fig)


def plot_pred_gt(query_image, pred, gt, support_image=None,
                 support_mask=None, score=None,
                 path: str = "debug/pred_vs_gt.png"):
    plt = _mpl()
    _ensure_dir(path)
    ncols = 3 if support_image is None else 4
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 4))
    img = _np(query_image).astype(np.float32)
    axes[0].imshow(img, cmap="gray")
    axes[0].set_title("query")
    axes[1].imshow(img, cmap="gray")
    axes[1].imshow(_np(pred), alpha=0.5)
    axes[1].set_title("pred")
    axes[2].imshow(img, cmap="gray")
    axes[2].imshow(_np(gt), alpha=0.5)
    axes[2].set_title("gt")
    if support_image is not None:
        axes[3].imshow(_np(support_image), cmap="gray")
        if support_mask is not None:
            axes[3].imshow(_np(support_mask), alpha=0.5)
        axes[3].set_title("support")
    if score is not None:
        fig.suptitle(f"sam score: {score}")
    fig.savefig(path)
    plt.close(fig)
