"""Checkpoints (npz, with the optimizer state), the training step and
``fit``, its three single-card modes, and ``evaluate_dataset``
(``train.loop``)."""

from mamimo_tpu_torch.train.ckpt import load_checkpoint, save_checkpoint  # noqa: F401
from mamimo_tpu_torch.train.loop import (  # noqa: F401
    TrainResult,
    evaluate_dataset,
    fit,
)
