"""Fused halo exchange for the sequence-parallel channel convolution
(the port of ``mamimo_tpu/parallel/rdma_halo.py``).

The ppermute form (``parallel/halo.py::sharded_apply_channel``) moves
each rank's (n_taps − 1)-sample tail to its right neighbour and then
concatenates the received halo with the local chunk: an extra pass that
materializes the extended block. Here kernel 7, ``csrc/halo.cu``, copies
every rank's chunk into the body of its extended block and stores its
tail straight into the right neighbour's halo slot, through a pointer
that may lie on another card.

A mesh is a list of torch devices and one card can hold several ranks.
The kernel runs once per card over all of that card's ranks
(``_launch_plan``); neighbours on different cards order their puts
through device-side flags (the JAX kernel's barrier and ``recv_sem``),
so the host issues one launch per card and waits on nothing. On the CPU
the wrappers run the plain exchange (``tail.to(device)`` and
``torch.cat``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import on_cuda
from mamimo_tpu_torch.parallel.halo import overlap_save, seq_chunks
from mamimo_tpu_torch.parallel.mesh import Mesh
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

MAX_RANKS_PER_CARD = 8      # HALO_MAX_RANKS of csrc/halo.cu


def ext_block_plain(x: torch.Tensor, left: torch.Tensor | None,
                    halo: int) -> torch.Tensor:
    """Plain version of one rank's extended block: [the last ``halo``
    rows of the left neighbour's planes ``left`` (zeros when None) ‖
    x], x (2, chunk, nt) → (2, halo + chunk, nt) on x's device (any
    number of planes: the complex form passes one)."""
    if left is None:
        recv = torch.zeros((x.shape[0], halo, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    else:
        recv = left[:, left.shape[1] - halo:].to(x.device)
    return torch.cat([recv, x], dim=1)


def _rows(c: torch.Tensor) -> torch.Tensor:
    """A contiguous (n, nt) complex64 chunk as one plane of float rows,
    (1, n, 2·nt) float32 (a view)."""
    return torch.view_as_real(c).view(1, c.shape[0], 2 * c.shape[1])


def _ext_complex_plain(x: torch.Tensor, left: torch.Tensor | None,
                       halo: int) -> torch.Tensor:
    """Plain version of the complex form: ``ext_block_plain`` on the
    chunks' rows, x (chunk, nt) complex64 → (halo + chunk, nt)."""
    ext = ext_block_plain(_rows(x.contiguous()), None if left is None
                          else _rows(left.contiguous()), halo)
    return torch.view_as_complex(ext.view(halo + x.shape[0], x.shape[1], 2))


class _Slot(NamedTuple):
    """One rank of a card's launch."""

    rank: int
    right: int | None       # the rank whose block takes this rank's tail
    zero_halo: bool         # rank 0: zeros in its own halo rows
    right_remote: bool      # right on another card: barrier + recv flags
    left_remote: bool       # left on another card: it posts / waits


def _launch_plan(devs) -> list[tuple[torch.device, tuple[_Slot, ...]]]:
    """The launches of one exchange along an axis whose ranks lie on
    ``devs`` (any order, repeats allowed): one per card, in the order the
    cards first appear, each over that card's ranks. Raises ValueError
    when a card holds more than MAX_RANKS_PER_CARD ranks."""
    d = len(devs)
    cards: dict[torch.device, list[_Slot]] = {}
    for r, dev in enumerate(devs):
        right = r + 1 if r + 1 < d else None
        cards.setdefault(dev, []).append(_Slot(
            rank=r, right=right, zero_halo=r == 0,
            right_remote=right is not None and devs[right] != dev,
            left_remote=r > 0 and devs[r - 1] != dev))
    for dev, slots in cards.items():
        if len(slots) > MAX_RANKS_PER_CARD:
            raise ValueError(f"{len(slots)} ranks on {dev}: the halo kernel "
                             f"takes at most {MAX_RANKS_PER_CARD} a card")
    return [(dev, tuple(slots)) for dev, slots in cards.items()]


class _CSlot(ctypes.Structure):
    """struct HaloSlot of csrc/halo.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "out_self", "out_right", "ready_wait", "arrived_post",
        "puts_done", "ready_post", "arrived_wait")] \
        + [("is_first", ctypes.c_int), ("rank", ctypes.c_int)]


class _Signals:
    """The flags of one mesh axis whose neighbours cross cards: an int64
    buffer of 3·d words on each card (ready[r], arrived[r], puts_done[r]
    of the pair r → r + 1 at r, d + r, 2d + r; ready and puts_done on the
    putter's card, arrived on the receiver's), and the epoch of the last
    call. Made once per axis; flags hold epochs, so nothing is reset."""

    def __init__(self, lib, devs):
        self.d = len(devs)
        self.epoch = 0
        self.bufs = {dev: torch.zeros(3 * self.d, dtype=torch.int64,
                                      device=dev)
                     for dev in dict.fromkeys(devs)}
        for r in range(self.d - 1):
            a, b = devs[r], devs[r + 1]
            if a != b:                  # puts a → b, flags both ways
                _enable_peer(lib, a, b)
                _enable_peer(lib, b, a)
        # the zeros land before any other card's kernel posts a flag here
        for dev in self.bufs:
            torch.cuda.synchronize(dev)

    def flag(self, dev: torch.device, kind: int, r: int) -> int:
        return self.bufs[dev].data_ptr() + 8 * (kind * self.d + r)


_signals: dict[tuple, _Signals] = {}


@functools.lru_cache(maxsize=64)
def _cached_plan(devs: tuple) -> tuple:
    """_launch_plan of a tuple of devices, and whether a pair crosses
    cards (kept: the plan depends on the devices alone)."""
    plan = _launch_plan(devs)
    return plan, any(s.right_remote for _, slots in plan for s in slots)


def _exchange(devs, xs, outs, halo: int, planes: int, chunk: int,
              w: int) -> None:
    """Kernel 7 on float rows: xs[r] holds (planes, chunk, w) float32
    rows and outs[r] its (planes, halo + chunk, w) block (contiguous, on
    devs[r]; complex64 chunks pass as they are, one plane of 2·nt
    floats a row); one launch per card on its current stream, counted."""
    if chunk == 0:
        return
    key = tuple(devs)
    plan, crosses = _cached_plan(key)
    lib = _halo_lib()
    sig = None
    if halo > 0 and crosses:
        sig = _signals.get(key)
        if sig is None:
            sig = _signals[key] = _Signals(lib, devs)
        sig.epoch += 1
    # every card's table and stream first, then the launches back to
    # back: a card's kernel waits on its neighbours' from its start
    launches = []
    for dev, slots in plan:
        table = (_CSlot * len(slots))()
        launches.append((dev, table, len(slots),
                         torch.cuda.current_stream(dev).cuda_stream))
        for e, s in zip(table, slots):
            e.x, e.out_self = xs[s.rank].data_ptr(), outs[s.rank].data_ptr()
            e.is_first, e.rank = int(s.zero_halo), s.rank
            if s.right is not None:
                e.out_right = outs[s.right].data_ptr()
            if sig is not None and s.right_remote:
                e.ready_wait = sig.flag(dev, 0, s.rank)
                e.arrived_post = sig.flag(devs[s.right], 1, s.rank)
                e.puts_done = sig.flag(dev, 2, s.rank)
            if sig is not None and s.left_remote:
                e.ready_post = sig.flag(devs[s.rank - 1], 0, s.rank - 1)
                e.arrived_wait = sig.flag(dev, 1, s.rank - 1)
    epoch = sig.epoch if sig is not None else 0
    for dev, table, n, stream in launches:
        rc = lib.halo_card_launch(table, n, planes, chunk, halo, w, epoch,
                                  dev.index, stream)
        _build.check(rc, lib, "halo_exchange_error_string", "halo_exchange")
        halo_exchange_pallas.launches += 1


def _check_ranks(devs, xs, halo: int, what: str,
                 chunk_dim: int) -> tuple[int, ...]:
    """Raise unless xs holds one tensor per rank, each on its rank's
    device and shaped like rank 0's, and the chunk (dimension
    ``chunk_dim``) exceeds the halo; returns rank 0's shape."""
    if len(xs) != len(devs):
        raise ValueError(f"{len(xs)} {what} for {len(devs)} ranks")
    shape, dtype = tuple(xs[0].shape), xs[0].dtype
    for r, (x, dev) in enumerate(zip(xs, devs)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"rank {r}: {what} {tuple(x.shape)} {x.dtype}, "
                             f"rank 0's are {shape} {dtype}")
        if x.device != dev:
            raise ValueError(f"rank {r}: {what} on {x.device}, its rank "
                             f"is on {dev}")
    chunk = shape[chunk_dim]
    if not (0 <= halo < chunk or halo == chunk == 0):
        raise ValueError(f"chunk {chunk} must exceed the halo {halo}")
    return shape


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

    CUDA: ``csrc/halo.cu``, one launch per card on its current stream
    (none for chunk 0); the host waits on no stream. CPU: the plain
    exchange.
    """
    devs = mesh.axis_devices(axis)
    if planes and (planes[0].dim() != 3 or planes[0].shape[0] != 2
                   or planes[0].dtype != torch.float32):
        raise ValueError(f"planes must be (2, chunk, nt) float32, got "
                         f"{tuple(planes[0].shape)} {planes[0].dtype}")
    _, chunk, nt = _check_ranks(devs, planes, halo, "planes", 1)
    if not on_cuda(*planes):
        return [ext_block_plain(x, planes[r - 1] if r else None, halo)
                for r, x in enumerate(planes)]
    planes = [x.contiguous() for x in planes]
    # every block is allocated before the launches: no put can land in a
    # block that does not exist yet
    outs = [torch.empty((2, halo + chunk, nt), dtype=torch.float32,
                        device=x.device) for x in planes]
    _exchange(devs, planes, outs, halo, 2, chunk, nt)
    return outs


halo_exchange_pallas.launches = 0


def _halo_exchange_complex(mesh: Mesh, chunks, halo: int, *,
                           axis: str = "seq") -> list[torch.Tensor]:
    """``halo_exchange_pallas`` on complex chunks: one (chunk, nt)
    complex64 tensor per rank → one (halo + chunk, nt) complex64 block
    per rank. The kernel takes each chunk as one plane of 2·nt floats a
    row, so no planes are built and no complex is rebuilt. CPU: its
    plain version ``_ext_complex_plain``."""
    devs = mesh.axis_devices(axis)
    if chunks and (chunks[0].dim() != 2
                   or chunks[0].dtype != torch.complex64):
        raise ValueError(f"chunks must be (chunk, nt) complex64, got "
                         f"{tuple(chunks[0].shape)} {chunks[0].dtype}")
    chunk, nt = _check_ranks(devs, chunks, halo, "chunks", 0)
    if not on_cuda(*chunks):
        return [_ext_complex_plain(x, chunks[r - 1] if r else None, halo)
                for r, x in enumerate(chunks)]
    chunks = [x.contiguous() for x in chunks]
    outs = [torch.empty((halo + chunk, nt), dtype=torch.complex64,
                        device=x.device) for x in chunks]
    _exchange(devs, chunks, outs, halo, 1, chunk, 2 * nt)
    return outs


def _enable_peer(lib, dev: torch.device, peer: torch.device) -> None:
    """Let kernels on ``dev`` store into ``peer``'s memory; raises when
    the cards cannot reach each other (no copy through the host)."""
    rc = lib.halo_enable_peer(dev.index, peer.index)
    _build.check(rc, lib, "halo_exchange_error_string",
                 f"peer access {dev} -> {peer}")


@functools.cache
def _halo_lib() -> ctypes.CDLL:
    lib = _build.library("halo")
    fn = lib.halo_card_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_CSlot)] + [ctypes.c_int] * 5 \
        + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p]
    fn = lib.halo_enable_peer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def sharded_apply_channel_rdma(cfg: SimConfig, mesh: Mesh, sig, taps,
                               axis: str = "seq"):
    """``parallel/halo.py::sharded_apply_channel`` with the halo exchange
    and the extended-block build fused into kernel 7 (same contract and
    output). Each rank's chunk is a view of ``sig`` (copied only to a
    rank on another device) and goes through the kernel as complex64.

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
    exts = _halo_exchange_complex(
        mesh, [sig[i * chunk:(i + 1) * chunk].to(dev)
               for i, dev in enumerate(devs)], halo, axis=axis)
    ys = []
    with full_f32_matmul():
        for ext, dev in zip(exts, devs):
            ys.append(overlap_save(ext, taps.to(dev), chunk, halo))
    return torch.cat([y.to(mesh.first) for y in ys])
