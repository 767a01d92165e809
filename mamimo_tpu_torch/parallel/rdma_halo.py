"""Fused halo exchange for the sequence-parallel channel convolution
(the port of ``mamimo_tpu/parallel/rdma_halo.py``).

The ppermute form (``parallel/halo.py::sharded_apply_channel``) moves
each rank's (n_taps − 1)-sample tail to its right neighbour and then
concatenates the received halo with the local chunk: an extra pass that
materializes the extended block. Here one kernel per rank,
``csrc/halo.cu`` (kernel 7), copies the rank's chunk into the body of its
extended block and stores its tail straight into the right neighbour's
halo slot, through a pointer that may lie on another card.

A mesh is a list of torch devices and one card can hold several ranks;
the pointer into a neighbour's block is in the same address space
whether the neighbour is on the same card or on another card with peer
access, so the same kernel serves both. On the CPU the wrappers run the
plain exchange (``tail.to(device)`` and ``torch.cat``).
"""

from __future__ import annotations

import ctypes

import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import on_cuda
from mamimo_tpu_torch.parallel.halo import overlap_save, seq_chunks
from mamimo_tpu_torch.parallel.mesh import Mesh
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def ext_block_plain(x: torch.Tensor, left: torch.Tensor | None,
                    halo: int) -> torch.Tensor:
    """Plain version of one rank's extended block: [the last ``halo``
    rows of the left neighbour's planes ``left`` (zeros when None) ‖
    x], x (2, chunk, nt) → (2, halo + chunk, nt) on x's device."""
    if left is None:
        recv = torch.zeros((2, halo, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    else:
        recv = left[:, left.shape[1] - halo:].to(x.device)
    return torch.cat([recv, x], dim=1)


def _check_planes(devs, planes, halo: int) -> tuple[int, int]:
    if len(planes) != len(devs):
        raise ValueError(f"{len(planes)} planes for {len(devs)} ranks")
    shape = tuple(planes[0].shape)
    for r, (x, dev) in enumerate(zip(planes, devs)):
        if x.dim() != 3 or x.shape[0] != 2 or tuple(x.shape) != shape \
                or x.dtype != torch.float32:
            raise ValueError(f"rank {r}: planes must be (2, chunk, nt) "
                             f"float32 like rank 0's {shape}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"rank {r}: planes on {x.device}, its rank "
                             f"is on {dev}")
    chunk = shape[1]
    if not (0 <= halo < chunk or halo == chunk == 0):
        raise ValueError(f"chunk {chunk} must exceed the halo {halo}")
    return chunk, shape[2]


def halo_exchange_pallas(mesh: Mesh, planes, halo: int, *,
                         axis: str = "seq") -> list[torch.Tensor]:
    """Build every rank's overlap-save extended block.

    Args:
      planes: one (2, chunk, nt) float32 tensor per rank along ``axis``
        (real and imaginary planes of the rank's time chunk), each on
        its rank's device.
      halo: n_taps − 1 overlap samples, < chunk.

    Returns:
      one (2, halo + chunk, nt) float32 block per rank, on its device:
      [left neighbour's last ``halo`` rows ‖ own chunk], zeros in rank
      0's halo. (Per rank, as the JAX kernel returns it under shard_map.)

    CUDA: ``csrc/halo.cu``, one launch per rank on that rank's device
    and current stream (none for chunk 0). CPU: the plain exchange.
    """
    devs = mesh.axis_devices(axis)
    chunk, nt = _check_planes(devs, planes, halo)
    if not on_cuda(*planes):
        return [ext_block_plain(x, planes[r - 1] if r else None, halo)
                for r, x in enumerate(planes)]
    planes = [x.contiguous() for x in planes]
    # every block is allocated before any launch: no put can land in a
    # block that does not exist yet
    outs = [torch.empty((2, halo + chunk, nt), dtype=torch.float32,
                        device=x.device) for x in planes]
    if chunk == 0:
        return outs
    streams = [torch.cuda.current_stream(x.device) for x in planes]
    lib = _halo_lib()
    # neighbours on different streams (ranks on different cards)
    cross = [r for r in range(len(planes) - 1)
             if streams[r] != streams[r + 1]]
    for r in cross:
        # the neighbour barrier: rank r's put waits until rank r+1's
        # block is free on its own stream
        if planes[r].device != planes[r + 1].device:
            _enable_peer(lib, planes[r].device, planes[r + 1].device)
        streams[r].wait_stream(streams[r + 1])
        outs[r + 1].record_stream(streams[r])
    # every rank launches before any stream waits on a put, so launches on
    # different cards overlap: rank r+1's launch writes only its body rows,
    # rank r's put only r+1's halo rows
    for r, x in enumerate(planes):
        right = outs[r + 1] if r + 1 < len(planes) else None
        _launch(lib, x, outs[r], right, halo, r == 0, streams[r])
    for r in cross:
        # recv_sem: rank r+1's stream reads its block only after rank r's
        # put
        streams[r + 1].wait_stream(streams[r])
    return outs


halo_exchange_pallas.launches = 0


def _launch(lib, x, out_self, out_right, halo, is_first, stream) -> None:
    """One rank's launch on ``stream``: x (2, chunk, nt) into its own
    block ``out_self``, the tail also into ``out_right`` (None on the
    last rank), zeros in the halo when ``is_first``; counted."""
    chunk, nt = x.shape[1], x.shape[2]
    if chunk == 0:
        return
    with torch.cuda.device(x.device):
        rc = lib.halo_exchange_launch(
            x.data_ptr(), out_self.data_ptr(),
            None if out_right is None else out_right.data_ptr(),
            chunk, halo, nt, int(is_first), stream.cuda_stream)
    _build.check(rc, lib, "halo_exchange_error_string", "halo_exchange")
    halo_exchange_pallas.launches += 1


def _enable_peer(lib, dev: torch.device, peer: torch.device) -> None:
    """Let kernels on ``dev`` store into ``peer``'s memory; raises when
    the cards cannot reach each other (no copy through the host)."""
    rc = lib.halo_enable_peer(dev.index, peer.index)
    _build.check(rc, lib, "halo_exchange_error_string",
                 f"peer access {dev} -> {peer}")


def _halo_lib() -> ctypes.CDLL:
    lib = _build.library("halo")
    fn = lib.halo_exchange_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn = lib.halo_enable_peer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def sharded_apply_channel_rdma(cfg: SimConfig, mesh: Mesh, sig, taps,
                               axis: str = "seq"):
    """``parallel/halo.py::sharded_apply_channel`` with the halo exchange
    and the extended-block build fused into kernel 7 (same contract and
    output).

    Args:
      sig: (N, Nt) complex64, N divisible by mesh.shape[axis].
      taps: (T, Nt, Nr) complex64 impulse response.

    Returns:
      (N, Nr) complex64, gathered on the mesh's first device (the JAX
      package leaves it sharded over ``axis``).
    """
    del cfg
    sig = torch.as_tensor(sig).to(torch.complex64)
    devs, chunk, halo = seq_chunks(mesh, axis, sig.shape[0], taps)
    planes = [torch.view_as_real(sig[i * chunk:(i + 1) * chunk].to(dev))
              .permute(2, 0, 1).contiguous() for i, dev in enumerate(devs)]
    ext2 = halo_exchange_pallas(mesh, planes, halo, axis=axis)
    ys = []
    with full_f32_matmul():
        for e, dev in zip(ext2, devs):
            ext = torch.complex(e[0], e[1])               # (halo+chunk, Nt)
            ys.append(overlap_save(ext, taps.to(dev), chunk, halo))
    return torch.cat([y.to(mesh.first) for y in ys])
