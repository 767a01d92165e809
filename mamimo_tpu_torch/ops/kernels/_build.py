"""Build and load the hand-written CUDA kernels.

Each source ``mamimo_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface,
``mamimo_tpu_torch/_build/<name>-<hash>.so``, and loaded with
``ctypes``. The hash covers the sources, the flags and any ``-D``
defines, so an edited source is rebuilt. Builds happen at first use (or in one parallel batch
through ``build_all``); nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("ls_v2", "ls_v1", "ls_pair", "ls_parts", "fused_factored",
           "mlp_infer", "int8_mm", "matmul", "matmul_bf16", "halo",
           "tf32_split")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(defines=()) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _target(name: str, defines=()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, defines=()) -> dict[str, float]:
    """Compile every source whose library is missing, all at once (one
    ``nvcc`` each), with ``-D`` for each of ``defines``. Returns the wall seconds of each build started; the
    ptxas report (registers, shared memory, spills) lands next to each
    library as ``<name>-<hash>.log``. Raises on the first failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    secs, failed = {}, []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return secs


def ptxas_report(name: str) -> str:
    """The ptxas lines of the last build of ``name`` ('' if none):
    registers, spills and any warning (a wgmma the compiler serialized,
    a setmaxnreg it ignored)."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return ""
    keys = ("Used", "spill", "Compiling", "warning")
    return "\n".join(l.strip() for l in log.read_text().splitlines()
                     if any(k in l for k in keys))


def sass_counts(name: str, kernels) -> dict:
    """How many wgmma (HGMMA bf16, IGMMA int8) and mma.sync (HMMA bf16,
    IMMA int8) instructions the SASS of each kernel of the built library
    ``name`` holds (``cuobjdump -sass``): {kernel: {"HGMMA": n, "HMMA": n,
    "IGMMA": n, "IMMA": n}}. A kernel is matched by a substring of its
    mangled name; the instantiations of a template add up."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {k: dict.fromkeys(("HGMMA", "HMMA", "IGMMA", "IMMA"), 0)
              for k in kernels}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current is not None and "*/" in line:
            # "/*0450*/  @P0 HGMMA.64x64x16.F32.BF16 R24, ... ;  /* 0x.. */"
            for tok in line.split("*/")[1].split():
                op = tok.split(".")[0]
                if op in counts[current]:
                    counts[current][op] += 1
    return counts


def library(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``
    (none for the kernels the package launches), built if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_all((name,), defines)
            lib = ctypes.CDLL(str(_target(name, defines)))
            _libs[key] = lib
        return lib


def check(rc: int, lib: ctypes.CDLL, err_fn: str, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        fn = getattr(lib, err_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({fn(rc).decode()})")
