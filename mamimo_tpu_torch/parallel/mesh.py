"""Device meshes (the port's counterpart of ``mamimo_tpu/parallel/mesh.py``).

A ``Mesh`` is the counterpart of a JAX mesh: named axes, a shape and an
array of ``torch.device``s, one per rank. One device may repeat, so
several ranks can share one card (or the CPU); the sharded functions of
``parallel/`` then run each rank's share of the work on its device from
one Python process. After ``parallel.multihost.init`` a mesh spans the
ranks of every joined process: each rank has an owning process
(``procs``), ranks are numbered process by process, and each process
computes only its own ranks (the others' devices are names only; they
may be another machine's cards). The axes:

  * ``data``    — packets × antenna-pair samples
  * ``model``   — hidden units of the MLP (the training slice)
  * ``seq``     — OFDM-symbol blocks of the preamble, or time chunks of
                  the signal (sequence parallelism)
  * ``antenna`` — the num_tx pilot heads of the DNN
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch


class Mesh:
    """Named axes over an array of torch devices (one per rank), each
    rank owned by one process (``procs``, all 0 in one process)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 procs: np.ndarray | None = None, process_index: int = 0):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.procs = (np.zeros(devices.shape, np.int64) if procs is None
                      else np.asarray(procs, np.int64).reshape(devices.shape))
        self.process_index = int(process_index)
        self.local_ranks = [int(r) for r in
                            np.flatnonzero(self.procs.ravel()
                                           == self.process_index)]
        if not self.local_ranks:
            raise ValueError(f"process {self.process_index} owns no rank "
                             f"of the mesh")

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, in axis order (as a JAX mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return int(self.devices.size)

    @property
    def num_processes(self) -> int:
        """The number of processes the ranks belong to."""
        return int(self.procs.max()) + 1

    @property
    def first(self) -> torch.device:
        """This process's first rank's device: where gathered outputs
        come back."""
        return self.rank_device(self.local_ranks[0])

    def rank_device(self, r: int) -> torch.device:
        """The device of flat rank r (row-major over the axes)."""
        return self.devices.flat[r]

    def is_local(self, r: int) -> bool:
        """True when this process owns flat rank r."""
        return int(self.procs.flat[r]) == self.process_index

    def position(self, r: int, axis: str) -> int:
        """Rank r's index along ``axis`` (0 for an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 0
        return int(np.unravel_index(r, self.devices.shape)[
            self.axis_names.index(axis)])

    def group(self, r: int, axes) -> list[int]:
        """The flat ranks that share rank r's indices on every axis but
        ``axes`` (axes the mesh lacks are ignored), in increasing order."""
        coords = np.unravel_index(r, self.devices.shape)
        idx = tuple(slice(None) if a in axes else c
                    for a, c in zip(self.axis_names, coords))
        flat = np.arange(self.size).reshape(self.devices.shape)[idx]
        return [int(x) for x in np.ravel(flat)]

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis indices (0 on unnamed axes)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axes {sorted(unknown)} in mesh "
                             f"{self.shape}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def axis_ranks(self, axis: str) -> list[int]:
        """The flat ranks along ``axis`` (index 0 on every other axis)."""
        if axis not in self.axis_names:
            raise KeyError(axis)
        return self.group(0, (axis,))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis)."""
        return [self.rank_device(r) for r in self.axis_ranks(axis)]


def _indexed(dev: torch.device) -> torch.device:
    """'cuda' as the current card's 'cuda:<i>', so a rank's device
    compares equal to the device of the tensors made on it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(axes: Mapping[str, int] | None = None,
              devices: Sequence | None = None) -> Mesh:
    """Build a mesh from {axis: size}; sizes must multiply to #ranks.

    ``devices``: torch devices or their names, one per rank, repeats
    allowed (several ranks on one card). Default: every visible CUDA
    device; raises without one. Default axes: all ranks on 'data'.

    In a run joined by ``parallel.multihost.init``, ``devices`` are this
    process's ranks (default: its current card) and the mesh spans every
    process's ranks in process order; each process must name the same
    number, of the type of the group's transport (CPU ranks for gloo,
    cards for NCCL).
    """
    from mamimo_tpu_torch.parallel import multihost

    n_proc = multihost.process_count()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA GPU is available; pass "
                               "devices= to build a mesh of other devices")
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if n_proc > 1 else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    devices = [_indexed(torch.device(d)) for d in devices]
    procs = [0] * len(devices)
    me = multihost.process_index()
    if n_proc > 1:
        dist = torch.distributed
        want = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if any(d.type != want for d in devices):
            raise ValueError(f"the {dist.get_backend()} group carries "
                             f"{want} ranks, got {devices}")
        names = [None] * n_proc
        dist.all_gather_object(names, [str(d) for d in devices])
        if len({len(n) for n in names}) != 1:
            raise ValueError(f"every process must name as many ranks: "
                             f"{names}")
        devices = [torch.device(d) if p != me else devices[i]
                   for p, ns in enumerate(names) for i, d in enumerate(ns)]
        procs = [p for p, ns in enumerate(names) for _ in ns]
    if axes is None:
        axes = {"data": len(devices)}
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh {dict(axes)} needs {int(np.prod(shape))} devices, "
            f"got {len(devices)}"
        )
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), names, np.asarray(procs).reshape(shape),
                me)
