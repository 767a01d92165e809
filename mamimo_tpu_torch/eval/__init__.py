"""Evaluation: the per-packet metric container, the sounding NMSE
summary and the diagnostic plots (``plots``, matplotlib at first use).
The closed loop and the SNR sweep are not ported yet."""

from mamimo_tpu_torch.eval.closed_loop import (  # noqa: F401
    ClosedLoopMetrics,
    evaluate_closed_loop,
    nmse_vs_snr,
)
