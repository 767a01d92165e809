"""Checkpoints (npz). The training loop is not ported yet."""

from mamimo_tpu_torch.train.ckpt import load_checkpoint, save_checkpoint  # noqa: F401
