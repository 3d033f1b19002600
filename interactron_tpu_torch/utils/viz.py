"""Visualization helpers (own copy of interactron_tpu/utils/viz.py): PR
curves and IoU histograms of the evaluators' detection records
(engine/ap.py), and the PR points behind them. matplotlib is imported only
inside the plotting functions, so nothing on a train or serve path needs
it."""

import numpy as np


def plot_pr_curve(p, r, path=None, title="PR curve"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(r, p)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_title(title)
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_iou_histogram(detections, path=None, bins=20):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ious = [d["iou"] for d in detections if d["type"] == "tp"]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.hist(ious, bins=bins, range=(0, 1))
    ax.set_xlabel("IoU")
    ax.set_ylabel("count")
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def compute_pr(detections, nsamples=100, iou_thresh=0.5, min_area=0.0, max_area=1.0):
    """(precision, recall) at confidences 0, 1/nsamples, ..., over the
    records of `detections` whose area lies in (min_area, max_area): a tp
    below `iou_thresh` counts as an fp."""
    dets = [d for d in detections if min_area < d["area"] < max_area]
    tps = [d for d in dets if d["type"] == "tp" and d["iou"] >= iou_thresh]
    fps = [d for d in dets if d["type"] == "fp"] + [
        d for d in dets if d["type"] == "tp" and d["iou"] < iou_thresh
    ]
    n_fn = len([d for d in dets if d["type"] == "fn"])
    tp_scores = np.sort(np.asarray([d["pred_score"] for d in tps]))[::-1]
    fp_scores = np.sort(np.asarray([d["pred_score"] for d in fps]))[::-1]
    p, r = [], []
    for conf in np.arange(0.0, 1.0, 1.0 / nsamples):
        ntp = int(np.sum(tp_scores >= conf))
        nfp = int(np.sum(fp_scores >= conf))
        p.append(0 if ntp == 0 else ntp / (ntp + nfp))
        r.append(0 if ntp == 0 else ntp / (ntp + n_fn))
    return p, r
