"""ctypes binding for the native (C++) streaming dataset loader (the
port's copy of ``mamimo_tpu/data/native_loader.py``).

``native/src/dataloader.cpp`` is compiled with ``g++`` at first use into
the port's own ``mamimo_tpu_torch/_build/`` (a library per source hash)
and loaded with ``ctypes``; the JAX package's cache ``native/build/`` is
never touched. There is no silent fallback: a build or open failure
raises. The NumPy gather is the loader's plain version, used only when
the caller asks for it (``native=False``).

Raw container (``write_raw``; the header of ``dataloader.cpp``):
``MMIMORAW``, six little-endian int64 (B, L, R, C, T, 0), then rx
(B, L, R) and h_ls (B, C, T, R) as complex64 in C order. Sample index
contract: idx = p·(R·T) + r·T + t.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

MAGIC = b"MMIMORAW"
HEADER_BYTES = 56
REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "src" / "dataloader.cpp"
BUILD_DIR = REPO / "mamimo_tpu_torch" / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmamimo_dataloader-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile dataloader.cpp with g++ unless its library (named by the
    hash of source and flags) exists; raises RuntimeError on failure."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                            "-lpthread"], capture_output=True, text=True,
                           timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native loader build failed: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"native loader build failed (g++ rc "
                           f"{r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [ctypes.c_char_p]
    lib.dl_meta.restype = ctypes.c_int
    lib.dl_meta.argtypes = [ctypes.c_void_p, _i64p]
    for fn in (lib.dl_gather, lib.dl_gather_packets):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, _i64p, ctypes.c_int64, _f32p, _f32p,
                       ctypes.c_int]
    lib.dl_prefetch.restype = ctypes.c_int
    lib.dl_prefetch.argtypes = [ctypes.c_void_p, _i64p, ctypes.c_int64,
                                ctypes.c_int]
    lib.dl_wait.restype = ctypes.c_int64
    lib.dl_wait.argtypes = [ctypes.c_void_p, _f32p, _f32p]
    lib.dl_close.restype = None
    lib.dl_close.argtypes = [ctypes.c_void_p]
    return lib


def native_library() -> ctypes.CDLL:
    """The loaded native loader, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build_library())))
        return _lib


def write_raw(path: str, rx: np.ndarray, h_ls: np.ndarray) -> None:
    """Write the raw container (``CSIDataset.save_raw``): the same bytes
    as the JAX package's ``write_raw``."""
    B, L, R = rx.shape
    _, C, T, _ = h_ls.shape
    header = MAGIC + np.asarray([B, L, R, C, T, 0], np.int64).tobytes()
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(rx, np.complex64).tobytes())
        f.write(np.ascontiguousarray(h_ls, np.complex64).tobytes())


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class NativeBatchLoader:
    """Gather (signal planes, label planes) batches by sample index from a
    raw container: through the C++ loader, or with ``native=False``
    through its NumPy plain version (same results, bit for bit)."""

    def __init__(self, path: str, n_threads: Optional[int] = None,
                 native: bool = True):
        self.path = path
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self._handle = None
        self._np = None
        self._pending = None
        if native:
            self._lib = native_library()
            h = self._lib.dl_open(os.fsencode(path))
            if not h:
                raise OSError(f"{path}: the native loader cannot open it "
                              "(missing, not a raw container, or short)")
            self._handle = ctypes.c_void_p(h)
            meta = (ctypes.c_int64 * 6)()
            self._lib.dl_meta(self._handle, meta)
            (self.B, self.L, self.R, self.C, self.T,
             self.num_samples) = (int(v) for v in meta)
        else:
            self._open_numpy()

    @property
    def using_native(self) -> bool:
        return self._handle is not None

    def _open_numpy(self) -> None:
        with open(self.path, "rb") as f:
            head = f.read(HEADER_BYTES)
        if head[:8] != MAGIC:
            raise ValueError(f"{self.path}: not a raw container")
        dims = np.frombuffer(head[8:], np.int64)
        self.B, self.L, self.R, self.C, self.T = (int(v) for v in dims[:5])
        self.num_samples = self.B * self.R * self.T
        rx_n = self.B * self.L * self.R
        h_n = self.B * self.C * self.T * self.R
        m = np.memmap(self.path, np.complex64, mode="r",
                      offset=HEADER_BYTES, shape=(rx_n + h_n,))
        self._np = (m[:rx_n].reshape(self.B, self.L, self.R),
                    m[rx_n:].reshape(self.B, self.C, self.T, self.R))

    def gather(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """idx (n,) int64 → (sig (n, 2, L) f32, y (n, 2, C) f32); an index
        outside the container raises IndexError."""
        idx = np.ascontiguousarray(idx, np.int64)
        n = len(idx)
        sig = np.empty((n, 2, self.L), np.float32)
        y = np.empty((n, 2, self.C), np.float32)
        if self._handle is not None:
            rc = self._lib.dl_gather(self._handle, _ptr(idx, _i64p), n,
                                     _ptr(sig, _f32p), _ptr(y, _f32p),
                                     self.n_threads)
            if rc != 0:
                raise IndexError(f"dl_gather failed with code {rc}")
            return sig, y
        if n == 0 or idx.min() < 0 or idx.max() >= self.num_samples:
            raise IndexError(f"dl_gather failed with code "
                             f"{-1 if n == 0 else -2}")
        rx, h = self._np
        per_pkt = self.R * self.T
        p = idx // per_pkt
        r = (idx % per_pkt) // self.T
        t = idx % self.T
        s = rx[p, :, r]
        lab = h[p, :, t, r]
        sig[:, 0], sig[:, 1] = s.real, s.imag
        y[:, 0], y[:, 1] = lab.real, lab.imag
        return sig, y

    def gather_packets(self, pkts: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Whole packets as planes (the window-streaming path): pkts (n,)
        int64 → (rx planes (2, n, L, R) f32, h planes (2, n, C, T, R)
        f32); a packet outside the container raises IndexError."""
        pkts = np.ascontiguousarray(pkts, np.int64)
        n = len(pkts)
        sig = np.empty((2, n, self.L, self.R), np.float32)
        y = np.empty((2, n, self.C, self.T, self.R), np.float32)
        if self._handle is not None:
            rc = self._lib.dl_gather_packets(
                self._handle, _ptr(pkts, _i64p), n, _ptr(sig, _f32p),
                _ptr(y, _f32p), self.n_threads)
            if rc != 0:
                raise IndexError(f"dl_gather_packets failed ({rc})")
            return sig, y
        if n == 0 or pkts.min() < 0 or pkts.max() >= self.B:
            raise IndexError(f"dl_gather_packets failed "
                             f"({-1 if n == 0 else -2})")
        rx, h = self._np
        s, lab = rx[pkts], h[pkts]
        sig[0], sig[1] = s.real, s.imag
        y[0], y[1] = lab.real, lab.imag
        return sig, y

    def prefetch(self, idx: np.ndarray) -> None:
        """Start the gather of the next batch on a background C++ thread
        (the plain version gathers at once); one prefetch at a time, read
        by ``wait``."""
        idx = np.ascontiguousarray(idx, np.int64)
        if self._pending is not None:
            raise RuntimeError("a prefetch is already in flight: wait first")
        if self._handle is not None:
            rc = self._lib.dl_prefetch(self._handle, _ptr(idx, _i64p),
                                       len(idx), self.n_threads)
            if rc != 0:
                raise RuntimeError(f"dl_prefetch failed with code {rc}")
            self._pending = len(idx)
        else:
            self._pending = self.gather(idx)

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        """Block for the prefetch in flight and return its (sig, y)."""
        pending, self._pending = self._pending, None
        if pending is None:
            raise RuntimeError("no prefetch in flight")
        if self._handle is None:
            return pending
        n = int(pending)
        sig = np.empty((n, 2, self.L), np.float32)
        y = np.empty((n, 2, self.C), np.float32)
        rc = self._lib.dl_wait(self._handle, _ptr(sig, _f32p),
                               _ptr(y, _f32p))
        if rc != n:
            raise RuntimeError(f"dl_wait failed with code {rc}")
        return sig, y

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dl_close(self._handle)
            self._handle = None
        self._np = None

    def __enter__(self) -> "NativeBatchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover
        self.close()
