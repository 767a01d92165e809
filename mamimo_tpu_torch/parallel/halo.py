"""Sequence-parallel time-domain channel convolution with a halo exchange
(the port's copy of ``mamimo_tpu/parallel/halo.py``).

The Tx sample stream is split over the ranks of a mesh axis along time;
applying the channel's FIR response needs each rank to see the tail of
its left neighbour's chunk (the overlap-save halo, n_taps − 1 samples).

* ``channel_taps`` — the banded impulse response of a scattering
  realization (sinc fractional-delay interpolation of each path);
* ``apply_channel_taps`` — the unsharded FFT convolution (the oracle);
* ``sharded_apply_channel`` — per rank: receive the left neighbour's
  tail (``tail.to(device)``), prepend it (``torch.cat``), convolve
  locally, keep the valid region. This exchange is the plain version of
  kernel 7 (``parallel/rdma_halo.py``).

The FFTs and complex products are PyTorch (the JAX package leaves them
to XLA) and run in full float32 (TF32 off).
"""

from __future__ import annotations

import torch

from mamimo_tpu_torch.channel.scattering import ChannelRealization
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.parallel.mesh import Mesh
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def channel_taps(cfg: SimConfig, chan: ChannelRealization,
                 n_taps: int = 512) -> torch.Tensor:
    """Impulse response h[d, m, n] = Σ_s cr(m,n,s)·sinc(d − τ_s·Fs),
    (..., n_taps, num_tx, num_rx) complex64 for a realization with
    leading packet dims (...) or none.

    Full-length sinc interpolation (no window): on the sounding grid the
    reconstruction error is limited by the sinc tail beyond n_taps,
    which num_pad_zeros covers for the default geometry.
    """
    delays = chan.tau * cfg.chan_srate                  # (..., ns) samples
    d = torch.arange(n_taps, dtype=torch.float32, device=delays.device)
    w = torch.sinc(d - delays[..., None])               # (..., ns, n_taps)
    with full_f32_matmul():
        return torch.einsum("...mns,...sd->...dmn", chan.cr,
                            w.to(torch.complex64))


def _fft_conv(x: torch.Tensor, taps: torch.Tensor, size: int):
    """Circular convolution of x (..., n, Nt) with taps (..., T, Nt, Nr)
    over ``size`` points, summed over Nt: (..., size, Nr) complex64."""
    xf = torch.fft.fft(x, n=size, dim=-2)
    hf = torch.fft.fft(taps, n=size, dim=-3)
    with full_f32_matmul():
        yf = torch.einsum("...fm,...fmn->...fn", xf, hf)
    return torch.fft.ifft(yf, dim=-2)


def apply_channel_taps(sig: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Unsharded linear convolution via FFT (the oracle of the sharded
    forms). sig (..., N, Nt), taps (..., T, Nt, Nr) -> (..., N, Nr)
    complex64."""
    n = sig.shape[-2]
    return _fft_conv(sig.to(torch.complex64), taps,
                     n + taps.shape[-3])[..., :n, :]


def overlap_save(ext: torch.Tensor, taps: torch.Tensor, chunk: int,
                 halo: int) -> torch.Tensor:
    """One rank's valid output from its extended block ext (halo + chunk,
    Nt) = [left neighbour's tail ‖ own chunk]: position p of ext is the
    absolute sample i·chunk − halo + p, so rows [halo, halo + chunk) of
    the local convolution are the rank's (chunk, Nr) output."""
    return _fft_conv(ext, taps, chunk + 2 * halo)[halo:halo + chunk]


def seq_chunks(mesh: Mesh, axis: str, n: int, taps: torch.Tensor):
    """(devices along ``axis``, chunk, halo) for an n-sample signal split
    over them; raises unless the split is even and each chunk exceeds
    the channel memory (halo = n_taps − 1)."""
    if mesh.num_processes > 1:
        raise NotImplementedError(
            "the sharded convolutions run every rank in one process; the "
            f"mesh spans {mesh.num_processes} processes")
    devs = mesh.axis_devices(axis)
    d = len(devs)
    if n % d:
        raise ValueError(f"{n} samples do not divide over {d} ranks")
    chunk, halo = n // d, taps.shape[0] - 1
    if not halo < chunk:
        raise ValueError(f"chunk {chunk} must exceed the channel memory "
                         f"{halo} (n_taps - 1)")
    return devs, chunk, halo


def sharded_apply_channel(cfg: SimConfig, mesh: Mesh, sig: torch.Tensor,
                          taps: torch.Tensor, axis: str = "seq"):
    """Overlap-save convolution with the time axis split over ``axis``.

    Each rank's chunk goes to its device; each rank receives the last
    n_taps − 1 samples of its left neighbour's chunk (zeros on rank 0),
    prepends them, convolves locally and keeps the valid region.

    Args:
      sig: (N, Nt) complex64, N divisible by mesh.shape[axis].
      taps: (T, Nt, Nr) complex64 impulse response (each rank uses a
        copy on its device).

    Returns:
      (N, Nr) complex64 — gathered on the mesh's first device (the JAX
      package leaves it sharded over ``axis``); close to
      apply_channel_taps(sig, taps).
    """
    del cfg
    sig = torch.as_tensor(sig).to(torch.complex64)
    devs, chunk, halo = seq_chunks(mesh, axis, sig.shape[0], taps)
    chunks = [sig[i * chunk:(i + 1) * chunk].to(dev)
              for i, dev in enumerate(devs)]
    ys = []
    for i, dev in enumerate(devs):
        if i == 0:    # no left neighbour in a linear convolution
            recv = torch.zeros((halo, sig.shape[1]), dtype=sig.dtype,
                               device=dev)
        else:
            recv = chunks[i - 1][chunk - halo:].to(dev)
        ext = torch.cat([recv, chunks[i]])               # (halo+chunk, Nt)
        ys.append(overlap_save(ext, taps.to(dev), chunk, halo))
    return torch.cat([y.to(mesh.first) for y in ys])
