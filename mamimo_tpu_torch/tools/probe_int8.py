#!/usr/bin/env python3
"""Where the int8 GEMM kernel (csrc/int8_mm.cu) spends its time, on the
card.

    python3 mamimo_tpu_torch/tools/probe_int8.py [--old DIR]

At the int8 DNN's three layer shapes at S = 4096 (BS32: 32 heads, H =
1024, 234 carriers): layer 1 (4096, 10240) @ (10240, 1024), layer 2
(131072, 1024) @ (1024, 1024), layer 3 (131072, 1024) @ (1024, 234);
seeded random int8 operands, CUDA events, with the card's SM clock and
power draw sampled by ``nvidia-smi`` beside each timed window
(``tools/probe_tail.py``'s timer):

1. each shape's answer held bit for bit to the float64 plain version,
   and the bytes the SMs take in per call (A and B tiles as the kernel
   loads them, zero-filled rows included);
2. phase cuts: the kernel built with ``-DINT8_CUT=<bits>`` (1 no
   products, 2 no stores, 3 the loads alone; each build hashed apart in
   ``_build/``). The cut builds compute wrong answers by design and are
   never used outside this probe;
3. with ``--old DIR``: the kernel against an earlier design whose
   sources (``int8_mm.cu`` and its headers, e.g. a ``git archive`` of an
   earlier commit's ``mamimo_tpu_torch/csrc``) lie in DIR and keep the
   same C launch function, first held to it bit for bit, then timed in
   turns (old, new, new, old) in one process.

Prints one line per measurement, and a JSON summary as the last line.
Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CUTS = {                  # INT8_CUT bits of csrc/int8_mm.cu
    "no products": 1,
    "no stores": 2,
    "loads only": 1 | 2,
}
S = 4096
SHAPES = {                # (M, K, N)
    "layer 1": (S, 10240, 1024),
    "layer 2": (S * 32, 1024, 1024),
    "layer 3": (S * 32, 1024, 234),
}
KMAX = 1024               # the kernel's resident-slab limit
SMS = 132                 # H100 SXM


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f = lib.int8_mm_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    return lib


def bytes_into_sms(m: int, k: int, n: int) -> dict:
    """Bytes the SMs take in per call: the mma.sync kernel's 128 x 128
    tiles (A and Bt rows over the whole K each), and this kernel's
    resident slabs (K <= KMAX: A once per 128 columns, one slab a block)
    or 128 x 256 tiles in 2-block clusters (an odd last M-tile paired
    with one past M)."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    old = cdiv(m, 128) * cdiv(n, 128) * 256 * k
    if k <= KMAX:
        ns, tiles = cdiv(n, 128), cdiv(m, 128)
        blocks = ns * min(max(SMS // ns, 1), tiles)
        new = ns * tiles * 128 * k + blocks * 128 * k
    else:
        new = cdiv(n, 256) * cdiv(cdiv(m, 128), 2) * 2 * 384 * k
    return {"old": old, "new": new}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of an earlier design's csrc sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_int8: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.int8_mm import (
        _matmul_int8_plain,
        matmul_int8,
    )
    from mamimo_tpu_torch.tools.probe_tail import _fmt, _old_lib, _time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    variants = {"kernel": ()}
    variants.update({n: (f"INT8_CUT={b}",) for n, b in CUTS.items()})
    with ThreadPoolExecutor(len(variants)) as pool:   # one nvcc each
        list(pool.map(lambda d: _build.build_all(("int8_mm",), d),
                      variants.values()))
    for line in _build.ptxas_report("int8_mm").splitlines():
        print(f"  int8_mm: {line}")
    kerns = ("int8_mm_kernel_slab", "int8_mm_kernel_ring")
    sass = _build.sass_counts("int8_mm", kerns)
    for k, ops in sass.items():
        print(f"  int8_mm: {k} SASS: {ops}")

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    libs = {n: _bind(_build.library("int8_mm", d))
            for n, d in variants.items()}
    old = _bind(_old_lib(args.old, "int8_mm")) if args.old else None
    summary = {"card": card, "S": S, "sass": sass, "shapes": {}}
    for lyr, (m, k, n) in SHAPES.items():
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        out = torch.empty((m, n), dtype=torch.int32, device=dev)

        def run(lib, a=a, bt=bt, out=out, m=m, n=n, k=k):
            rc = lib.int8_mm_launch(a.data_ptr(), bt.data_ptr(),
                                    out.data_ptr(), m, n, k, stream())
            if rc:
                raise RuntimeError(f"int8_mm_launch: CUDA error {rc}")

        ref = _matmul_int8_plain(a, bt.T)
        got = matmul_int8(a, bt)
        bad = int((got != ref).sum())
        sizes = bytes_into_sms(m, k, n)
        print(f"{lyr} ({m}, {k}) @ ({k}, {n}): "
              f"{'exact' if not bad else f'{bad} values differ'} vs float64; "
              f"into the SMs {sizes['old'] / 1e9:.3f} GB (mma.sync tiles) "
              f"-> {sizes['new'] / 1e9:.3f} GB")
        if bad:
            raise AssertionError(f"{lyr}: {bad} values differ")
        rec = summary["shapes"][lyr] = {"shape": [m, k, n],
                                        "bytes_into_sms": sizes, "cuts": {}}
        for vname, lib in libs.items():
            ms, clk, pwr = _time_ms(lambda lib=lib: run(lib))
            print(f"  {lyr} {vname}: {_fmt(ms, clk, pwr)}  [{card}]")
            rec["cuts"][vname] = ms
        if old is not None:
            run(old)
            torch.cuda.synchronize()
            bad = int((out != got).sum())
            print(f"  {lyr}: new vs old: "
                  f"{'equal' if not bad else f'{bad} values differ'}")
            if bad:
                raise AssertionError(f"{lyr}: the designs disagree")
            ab = rec["ab"] = []
            for tag in ("old", "new", "new", "old"):
                ms, clk, pwr = _time_ms(
                    lambda lib=(old if tag == "old" else libs["kernel"]):
                    run(lib))
                print(f"  {tag} {lyr}: {_fmt(ms, clk, pwr)}  [{card}]")
                ab.append((tag, ms, clk, pwr))
        del a, bt, out, ref, got
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
