"""Evaluation of CSI estimators (the port's part of
``mamimo_tpu/eval/closed_loop.py``): the per-packet metric container and
the sounding-only NMSE summary. The closed loop itself
(``evaluate_closed_loop``: precoding, coded transmission and decoding
per estimator source) comes with the closed-loop slice of ROADMAP.md
(§1.6) and raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.ops.metrics import nmse_subk
from mamimo_tpu_torch.pipeline.dataset import CSIDataset
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

CLOSED_LOOP_TODO = (
    "the closed loop (pipeline/datatx.py, ops/omp.py, ops/coding.py and "
    "eval/snr_sweep.py) is not ported yet; it comes with the closed-loop "
    "slice of ROADMAP.md (§1.6)")


@dataclasses.dataclass
class ClosedLoopMetrics:
    """Per-packet metric arrays for one estimator source (the metrics.mat
    contents, BER_test_maMIMO_LTF.m:652-668)."""

    ber: np.ndarray       # (B,)
    evm: np.ndarray       # (B,)
    nmse: np.ndarray      # (B,) NMSE_subk vs perfect CSI
    bf_gain: np.ndarray   # (B,)

    def summary(self) -> Dict[str, float]:
        return {
            "ber": float(np.mean(self.ber)),
            "evm": float(np.mean(self.evm)),
            "nmse": float(np.mean(self.nmse)),
            "nmse_db": float(10 * np.log10(np.mean(self.nmse) + 1e-30)),
            "bf_gain": float(np.mean(self.bf_gain)),
        }


def nmse_vs_snr(ds: CSIDataset, predictions: Optional[np.ndarray] = None,
                device=None) -> Dict[str, np.ndarray]:
    """The sounding-only NMSE of each estimator source against the oracle
    CSI, per packet: {"ls", "lmmse" (if the dataset has it), "dnn" (if
    ``predictions``, (B, C, T, R) complex, are given)}. Computed on
    ``device``: None means the card, and raises without one."""
    dev = resolve_device("cuda" if device is None else device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.complex64), device=dev)

    ref = put(ds.h_perfect)
    srcs = {"ls": ds.h_ls, "lmmse": ds.h_mmse, "dnn": predictions}
    with full_f32_matmul():
        return {k: nmse_subk(ref, put(v)).cpu().numpy()
                for k, v in srcs.items() if v is not None}


def evaluate_closed_loop(ds: CSIDataset, *args, **kwargs):
    """The closed-loop evaluation: not ported yet."""
    raise NotImplementedError(f"evaluate_closed_loop: {CLOSED_LOOP_TODO}")
