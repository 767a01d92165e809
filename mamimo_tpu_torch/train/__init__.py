"""Checkpoints (npz, with the optimizer state) and the training step in
array form (``train.loop``); ``fit`` is not ported yet."""

from mamimo_tpu_torch.train.ckpt import load_checkpoint, save_checkpoint  # noqa: F401
