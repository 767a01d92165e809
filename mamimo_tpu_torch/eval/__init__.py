"""Evaluation: the closed loop of the CSI estimators (``closed_loop``),
the SNR sweeps (``snr_sweep``) and the diagnostic plots (``plots``,
matplotlib at first use)."""

from mamimo_tpu_torch.eval.closed_loop import (  # noqa: F401
    ClosedLoopMetrics,
    evaluate_closed_loop,
    nmse_vs_snr,
)
