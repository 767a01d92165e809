"""Channel sounding (the port's copy of ``pad_signal`` from
``mamimo_tpu/pipeline/sounding.py``; the sounding loop itself waits for
the data-generation slice)."""

from __future__ import annotations

import torch

from mamimo_tpu_torch.config import SimConfig


def pad_signal(cfg: SimConfig, sig) -> torch.Tensor:
    """Append the channel-delay zero padding (helperApplyMUChannel.m:34):
    sig (nsamp, num_tx), a tensor or a numpy array, → (nsamp +
    num_pad_zeros, num_tx) on sig's device."""
    sig = torch.as_tensor(sig)
    pad = torch.zeros((cfg.num_pad_zeros, sig.shape[1]), dtype=sig.dtype,
                      device=sig.device)
    return torch.cat([sig, pad], dim=0)
