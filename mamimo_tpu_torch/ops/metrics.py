"""Quality metrics on tensors: NMSE, MSE, EVM, BER (the port's copy of
``mamimo_tpu/ops/metrics.py``).

Definitions match ``BER_test_maMIMO_LTF.m:574-691``. Each takes tensors
(array-likes are converted) and computes on their device.
"""

from __future__ import annotations

import torch


def nmse_subk(ref, pred) -> torch.Tensor:
    """Per-(tx, rx) subchannel NMSE averaged over antenna pairs
    (``NMSE_subk``, BER_test_maMIMO_LTF.m:675-686).

    ref, pred: (..., num_carriers, num_tx, num_rx) complex. Returns the
    (...,) NMSE, linear (not dB)."""
    ref, pred = torch.as_tensor(ref), torch.as_tensor(pred)
    num = ((ref - pred).abs() ** 2).sum(-3)
    den = (ref.abs() ** 2).sum(-3)
    return (num / den).mean((-2, -1))


def mse_abs(ref, pred) -> torch.Tensor:
    """``MSE`` helper (BER_test_maMIMO_LTF.m:688-691): mean |diff| over
    the last three axes."""
    ref, pred = torch.as_tensor(ref), torch.as_tensor(pred)
    return (ref - pred).abs().mean((-3, -2, -1))


def evm_rms(rx_syms, constellation) -> torch.Tensor:
    """RMS EVM in percent, the reference point being the nearest
    constellation point, normalized by the constellation's mean power
    (comm.EVM at BER_test_maMIMO_LTF.m:574-578).

    rx_syms: (..., n) complex; constellation: (m,) complex. Returns
    (...,) EVM in %."""
    rx = torch.as_tensor(rx_syms)
    c = torch.as_tensor(constellation, device=rx.device)
    err2 = ((rx[..., None] - c).abs() ** 2).amin(-1)
    avg_pow = (c.abs() ** 2).mean()
    return 100.0 * torch.sqrt(err2.mean(-1) / avg_pow)


def bit_error_rate(tx_bits, rx_bits) -> torch.Tensor:
    """BER over the last axis (comm.ErrorRate), float32."""
    tx = torch.as_tensor(tx_bits)
    rx = torch.as_tensor(rx_bits, device=tx.device)
    return (tx != rx).float().mean(-1)
