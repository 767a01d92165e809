"""Numerical helpers (the port's copy of what it needs from
``mamimo_tpu/utils``)."""
