"""Profiling helpers (the port's copy of ``mamimo_tpu/utils/profiling.py``):
the reference's TF-profiler inference traces
(``massiveMIMO_CSI_prediction_DNN.py:441-475``, gated by --execTime)
become ``torch.profiler`` Chrome traces, timed with CUDA events on the
card, plus a steps/s counter for training loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block with ``torch.profiler`` (the host, and the card
    when there is one) into ``<logdir>/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_inference(fn: Callable, args: tuple, iters: int = 10,
                   logdir: str | None = None,
                   device=None) -> Dict[str, float]:
    """Time ``iters`` back-to-back calls of fn(*args) after one warm-up
    call (the --execTime harness), optionally traced into ``logdir``.

    On the card (``device`` None or CUDA) CUDA events bound the window;
    with ``device='cpu'`` the host clock does (``clock`` says which).
    Returns {"seconds_per_call", "calls_per_second", "clock"}."""
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("time_inference: no CUDA device")
    fn(*args)
    ctx = trace(logdir) if logdir else contextlib.nullcontext()
    with ctx:
        if on_card:
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn(*args)
            b.record()
            b.synchronize()
            dt = a.elapsed_time(b) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            dt = (time.perf_counter() - t0) / iters
    return {"seconds_per_call": dt, "calls_per_second": 1.0 / dt,
            "clock": "cuda events" if on_card else "host"}


class StepsPerSecond:
    """Rolling steps/s counter for training loops (host clock)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def step(self, n: int = 1) -> None:
        self.steps += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else 0.0
