"""Device meshes (the port's counterpart of ``mamimo_tpu/parallel/mesh.py``).

A ``Mesh`` is the single-controller counterpart of a JAX mesh: named
axes, a shape and an array of ``torch.device``s, one per rank. One
device may repeat, so several ranks can share one card (or the CPU);
the sharded functions of ``parallel/`` then run each rank's share of
the work on its device from one Python process. The axes:

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
    """Named axes over an array of torch devices (one per rank)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, in axis order (as a JAX mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The first rank's device: where gathered outputs come back."""
        return self.devices.flat[0]

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis indices (0 on unnamed axes)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axes {sorted(unknown)} in mesh "
                             f"{self.shape}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis)."""
        if axis not in self.axis_names:
            raise KeyError(axis)
        return list(self.devices[tuple(slice(None) if a == axis else 0
                                       for a in self.axis_names)])


def _indexed(dev: torch.device) -> torch.device:
    """'cuda' as the current card's 'cuda:<i>', so a rank's device
    compares equal to the device of the tensors made on it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(axes: Mapping[str, int] | None = None,
              devices: Sequence | None = None) -> Mesh:
    """Build a mesh from {axis: size}; sizes must multiply to #devices.

    ``devices``: torch devices or their names, one per rank, repeats
    allowed (several ranks on one card). Default: every visible CUDA
    device; raises without one. Default axes: all devices on 'data'.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA GPU is available; pass "
                               "devices= to build a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
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
    return Mesh(arr.reshape(shape), names)
