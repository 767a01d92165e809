"""Diagnostic plots: per-link prediction overlays and channel-magnitude
images (the port's copy of ``mamimo_tpu/eval/plots.py``: the 20
prediction-vs-truth PNGs of ``massiveMIMO_CSI_prediction_DNN.py:432-439``
and the ``plot_mimo_channel`` helper of ``generate_maMIMO_LTF.m:646``).
matplotlib is imported at the first plot, not with the module."""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_predictions(outdir: str, pred, truth, n_pics: int = 20) -> None:
    """Per-sample prediction-vs-truth overlays, one PNG per plane and
    sample; pred, truth: (B, C, num_tx, num_rx) complex."""
    plt = _plt()
    os.makedirs(outdir, exist_ok=True)
    B, C, T, R = pred.shape
    flat_p = np.transpose(pred, (0, 3, 2, 1)).reshape(-1, C)
    flat_t = np.transpose(truth, (0, 3, 2, 1)).reshape(-1, C)
    n = min(n_pics, flat_p.shape[0])
    for plane, op in (("real", np.real), ("imag", np.imag)):
        for i in range(n):
            plt.figure()
            plt.plot(op(flat_p[i]))
            plt.plot(op(flat_t[i]))
            plt.legend(["prediction", "truth"])
            plt.savefig(os.path.join(outdir, f"{i}_{plane}_bluePred.png"))
            plt.close()


def plot_mimo_channel(outpath: str, h, num_rx: int | None = None) -> None:
    """Channel magnitude per Rx antenna, |H(c, tx)| images; h: (C,
    num_tx, num_rx) complex."""
    plt = _plt()
    h = np.asarray(h)
    num_rx = num_rx or h.shape[2]
    fig, axes = plt.subplots(1, num_rx, figsize=(4 * num_rx, 3),
                             squeeze=False)
    for r in range(num_rx):
        im = axes[0][r].imshow(np.abs(h[:, :, r]), aspect="auto",
                               origin="lower")
        axes[0][r].set_title(f"Rx {r}")
        axes[0][r].set_xlabel("Tx antenna")
        axes[0][r].set_ylabel("subcarrier")
        fig.colorbar(im, ax=axes[0][r])
    os.makedirs(os.path.dirname(os.path.abspath(outpath)), exist_ok=True)
    fig.savefig(outpath)
    plt.close(fig)
