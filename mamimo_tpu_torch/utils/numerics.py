"""Numerics shared across the port: ``unit_phasor``, the host and device
copies ``put_complex``/``get_complex`` and ``fetch_tree``/
``fetch_tree_async`` (the port's copies from
``mamimo_tpu/utils/numerics.py``), ``fma32``, and the precision of
products on the card (``full_f32_matmul``, ``matmul_precision``)."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def _tf32(allow: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def full_f32_matmul():
    """Run float32 (and complex64) products on the card in full float32,
    not TF32, for the duration; the caller's settings are restored
    after."""
    return _tf32(False)


# the names of JAX's matmul precisions that the port takes
PRECISIONS = ("highest", "high", "default")


def matmul_precision(name: str | None):
    """The products of the duration at a JAX precision, by name:
    'highest' (or None) runs them in full float32; 'high' and 'default'
    (JAX's 3-pass and 1-pass bf16 on the TPU) run them in TF32 on the
    card. The CPU computes float32 for every name."""
    name = "highest" if name is None else str(name).lower()
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; expected one of "
                         f"{PRECISIONS}")
    return _tf32(name != "highest")


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c in float32 with one rounding, as XLA's compiled float32
    code computes a product feeding a sum (a fused multiply-add): the
    product of two float32 values is exact in float64, so the float64 sum
    rounded to float32 differs from a true fused multiply-add only at a
    float32 tie. The same on the CPU and the card."""
    a = torch.as_tensor(a).double()
    return (a * torch.as_tensor(b, device=a.device).double()
            + torch.as_tensor(c, device=a.device).double()).float()


def unit_phasor(cycles: torch.Tensor) -> torch.Tensor:
    """exp(+j·2π·cycles) with argument reduction to [0, 1) cycles.

    ``cycles`` (float32) may be arbitrarily large; pass negative values
    for exp(−j·...). The reduction and the angle are float32, in the JAX
    package's order. Returns complex64.
    """
    c = cycles - torch.floor(cycles)
    ang = (2.0 * math.pi) * c
    return torch.complex(torch.cos(ang), torch.sin(ang))


def put_complex(x, device=None) -> torch.Tensor:
    """A host complex array as complex64 on ``device`` (None: the card,
    raising without one), copied as its two float32 planes and combined
    there (the JAX package's transfer shim; PyTorch could copy the
    complex array itself)."""
    from mamimo_tpu_torch.models.predictor import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    planes = [torch.from_numpy(np.ascontiguousarray(part, np.float32))
              .to(dev) for part in (np.real(x), np.imag(x))]
    return torch.complex(*planes)


def get_complex(x: torch.Tensor, fetch_dtype=None) -> np.ndarray:
    """A complex tensor as host complex64, copied as float planes.
    ``fetch_dtype=torch.bfloat16`` rounds the planes to bf16 on the device
    first (half the bytes copied, about -50 dB: never for noiseless
    labels), widened back to float32 on the host."""
    dt = fetch_dtype or torch.float32
    re, im = (_numpy(p.to(dt).cpu()).astype(np.float32)
              for p in (x.real, x.imag))
    return (re + 1j * im).astype(np.complex64)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """Start copying t to host memory: a CUDA tensor goes into pinned
    memory without waiting (read it only after the stream's work before
    the copy is done); a CPU tensor is returned as it is."""
    if not t.is_cuda:
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    return buf


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _fetch_leaf(t: torch.Tensor, fetch_dtype):
    """Start the copy of one leaf; returns a function giving its numpy
    array once the copy is done."""
    if t.is_complex() and fetch_dtype is not None:
        re, im = (_host_copy(p.to(fetch_dtype)) for p in (t.real, t.imag))
        return lambda: (_numpy(re).astype(np.float32)
                        + 1j * _numpy(im).astype(np.float32)
                        ).astype(np.complex64)
    h = _host_copy(t)
    return lambda: _numpy(h)


def fetch_tree_async(tree, fetch_dtype=None):
    """Start copying every tensor of ``tree`` (a tensor, or a NamedTuple,
    tuple, list or dict of tensors and None) to the host, and return
    ``wait()``, which waits for the copies and gives the same structure
    of numpy arrays.

    CUDA tensors are copied into pinned host memory without blocking, and
    an event recorded after the copies is waited on before any array is
    read: reading the buffers earlier would give whatever they held.
    ``fetch_dtype`` (e.g. torch.bfloat16) applies to complex leaves only
    (the corpus bulk): their real and imaginary planes are rounded to it
    on the device, which halves the bytes copied, and widened back to
    complex64 on the host (about -50 dB for bf16: never for noiseless
    labels). Real and integer leaves (SNRs, delays) are copied exactly.
    """
    def start(node):
        if node is None:
            return lambda: None
        if isinstance(node, torch.Tensor):
            return _fetch_leaf(node, fetch_dtype)
        if isinstance(node, dict):
            parts = {k: start(v) for k, v in node.items()}
            return lambda: {k: f() for k, f in parts.items()}
        parts = [start(v) for v in node]
        if hasattr(node, "_fields"):                # a NamedTuple
            return lambda: type(node)(*(f() for f in parts))
        return lambda: type(node)(f() for f in parts)

    finish = start(tree)
    event = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        event = torch.cuda.Event()
        event.record()

    def wait():
        if event is not None:
            event.synchronize()
        return finish()

    return wait


def fetch_tree(tree, fetch_dtype=None):
    """``fetch_tree_async(tree, fetch_dtype)()``: the tensors of ``tree``
    as numpy arrays, once their copies are done."""
    return fetch_tree_async(tree, fetch_dtype)()
