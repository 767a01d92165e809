#!/usr/bin/env python3
"""Where the three LS kernels (csrc/ls_sm90.cuh) spend their time, on the
card.

    python3 mamimo_tpu_torch/tools/probe_ls.py [--old DIR]

At the bench shape (BS32: num_tx = 32, 234 carriers, S = 4096 rows of
10240 samples, 1024 packets of 4 rx), seeded random bf16 planes, CUDA
events, with the card's SM clock and power draw sampled by
``nvidia-smi`` beside each timed window (``tools/probe_tail.py``'s
timer):

1. phase cuts: ``ls_planes_v2_kernel`` (full mode, and seq rank 1 of 4),
   ``ls_planes_v1_kernel`` (raw f32 and raw bf16 planes) and
   ``ls_pair_kernel``, and the float32 modes of ``ls_planes_v2`` and
   ``ls_pair_kernel`` (float32 planes, the constants' TF32 parts; "no
   products" keeps the split of the input into its TF32 parts), built
   with ``-DLS_CUT=<bits>`` (1 no products,
   2 no despread, 4 no store; each build hashed apart in ``_build/``).
   The cut builds compute wrong answers by design and are never used
   outside this probe; the differences split each kernel's time by
   phase, and the build with every cut is what the loads alone take;
2. with ``--old DIR``: each kernel against an earlier design whose
   sources (``ls_v2.cu``, ``ls_v1.cu``, ``ls_pair.cu`` and their
   headers, e.g. a ``git archive`` of an earlier commit's
   ``mamimo_tpu_torch/csrc``) lie in DIR and keep the same C launch
   functions (their bf16 modes: an earlier design has no float32 mode;
   the arguments each library's launch functions take are read from its
   sources), timed in turns (old, new, new, old) in one process, after
   holding the two designs' answers to each other (NMSE, and whether
   they are bit-identical). An earlier design's kernel takes the
   (2·fft, 2·Cp) constants of ``ls_kernel_constants`` where its source
   does not include ``ls_sm90.cuh`` (the mma.sync bodies before them).

Prints one line per measurement, and a JSON summary as the last line.
Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CUTS = {                  # LS_CUT bits of the LS kernels' sources
    "no products": 1,
    "no despread": 2,
    "no store": 4,
    "loads only": 1 | 2 | 4,
}
PACKETS = 1024


SOURCES = ("ls_v2", "ls_v1", "ls_pair")


def _arity(src_dir: Path, name: str, fn: str) -> int:
    """The number of parameters of launch function fn in src_dir/<name>.cu
    (earlier designs' per-pair launch has no float32 flag)."""
    m = re.search(rf"int {fn}\(([^)]*)\)",
                  (src_dir / f"{name}.cu").read_text())
    return len(m.group(1).split(","))


def _bind(lib: ctypes.CDLL, src_dir: Path, name: str) -> ctypes.CDLL:
    """Argument types of the launch function of a library built from
    src_dir/<name>.cu; ``lib.pair_flag``: whether its per-pair launch
    takes the float32 flag."""
    lib.pair_flag = False
    for fn, n_ptr in (("ls_planes_v2_launch", 4), ("ls_planes_v1_launch", 4),
                      ("ls_pair_launch", 3)):
        f = getattr(lib, fn, None)
        if f is not None:
            n = _arity(src_dir, name, fn)
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p] * n_ptr \
                + [ctypes.c_int] * (n - n_ptr - 1) + [ctypes.c_void_p]
            if fn == "ls_pair_launch":
                lib.pair_flag = n == 13
    return lib


def _hopper(src_dir: Path, name: str) -> bool:
    """Whether csrc/<name>.cu in src_dir runs on ls_sm90.cuh (and so takes
    the permuted constants of ls_sm90_constants)."""
    return '#include "ls_sm90.cuh"' in (src_dir / f"{name}.cu").read_text()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of an earlier design's csrc sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ls: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mamimo_tpu_torch.config import SimConfig
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        ls_kernel_constants,
        ls_sm90_constants,
    )
    from mamimo_tpu_torch.tools.probe_tail import _fmt, _old_lib, _time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    _build.build_all(SOURCES)
    for name in SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            print(f"  {name}: {line}")

    cfg = SimConfig()
    nt, nr, C = cfg.num_tx, cfg.num_rx, cfg.num_carriers
    S, L = PACKETS * nr, cfg.len_ltf
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn((2, S, L), generator=g, device=dev)
    x = x32.to(torch.bfloat16)
    lq = L // 4
    xq = x[:, :, lq:2 * lq].contiguous()       # seq rank 1 of 4
    kc_old = ls_kernel_constants(cfg, dev)
    kc_new = ls_sm90_constants(cfg, dev).bt
    kc_f32 = ls_sm90_constants(cfg, dev, torch.float32).bt
    cpad = kc_old.shape[1] // 2
    out = torch.empty((2, S, nt, C), device=dev)
    out_p = torch.empty((PACKETS, C, nt, nr), dtype=torch.complex64,
                        device=dev)
    raw = {dt: torch.empty((2, S * nt, cpad), dtype=dt, device=dev)
           for dt in (torch.float32, torch.bfloat16)}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    geo = (C, cfg.sym_len, cfg.cp_length, cfg.fft_length, cpad)

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def v1(lib, consts, dt):
        h = raw[dt]
        return lambda: check(lib.ls_planes_v1_launch(
            x.data_ptr(), consts.data_ptr(), h[0].data_ptr(),
            h[1].data_ptr(), S, S, nt, *geo[1:], int(dt == torch.bfloat16),
            stream()), "ls_planes_v1_launch")

    def both(libs, consts, f32=False):
        """The five timed launches of the bf16 modes on built (ls_v2,
        ls_v1, ls_pair) libraries, each with its output; consts[name]: the
        constants each library takes. With f32 also the float32 modes of
        ls_planes_v2 and ls_pair_kernel."""
        v2, l1, pr = libs
        flag = (0,) if pr.pair_flag else ()
        fns = {
            # f32 store without sums: mode 0, no ssq buffer
            "ls_planes_v2": (lambda: check(v2.ls_planes_v2_launch(
                x.data_ptr(), consts["ls_v2"].data_ptr(), out.data_ptr(),
                None, S, nt, nt, 0, *geo, 0, stream()),
                "ls_planes_v2_launch"), out),
            "ls_planes_v2 seq 1/4": (lambda: check(v2.ls_planes_v2_launch(
                xq.data_ptr(), consts["ls_v2"].data_ptr(), out.data_ptr(),
                None, S, nt, nt // 4, 1, *geo, 0, stream()),
                "ls_planes_v2_launch (seq)"), out),
            "ls_planes_v1 raw f32": (v1(l1, consts["ls_v1"], torch.float32),
                                     raw[torch.float32]),
            "ls_planes_v1 raw bf16": (v1(l1, consts["ls_v1"], torch.bfloat16),
                                      raw[torch.bfloat16]),
            "ls_pair_kernel": (lambda: check(pr.ls_pair_launch(
                x.data_ptr(), consts["ls_pair"].data_ptr(), out_p.data_ptr(),
                S, nr, nt, *geo, *flag, stream()), "ls_pair_launch"),
                torch.view_as_real(out_p))}
        if f32:
            fns["ls_planes_v2 float32"] = (lambda: check(
                v2.ls_planes_v2_launch(
                    x32.data_ptr(), kc_f32.data_ptr(), out.data_ptr(), None,
                    S, nt, nt, 0, *geo, 4, stream()),
                "ls_planes_v2_launch (float32)"), out)
            fns["ls_pair_kernel float32"] = (lambda: check(pr.ls_pair_launch(
                x32.data_ptr(), kc_f32.data_ptr(), out_p.data_ptr(), S, nr,
                nt, *geo, 1, stream()), "ls_pair_launch (float32)"),
                torch.view_as_real(out_p))
        return fns

    csrc = ROOT / "mamimo_tpu_torch" / "csrc"

    def new_libs(defines=()):
        return tuple(_bind(_build.library(n, defines), csrc, n)
                     for n in SOURCES)

    k_new = dict.fromkeys(SOURCES, kc_new)

    summary = {"card": card, "S": S}
    print(f"phase cuts, S = {S}:")
    variants = {"kernel": ()}
    variants.update({n: (f"LS_CUT={b}",) for n, b in CUTS.items()})
    with ThreadPoolExecutor(len(variants)) as pool:   # one nvcc each
        list(pool.map(lambda d: _build.build_all(SOURCES, d),
                      variants.values()))
    cut = {}
    for vname, defines in variants.items():
        fns = both(new_libs(defines), k_new, f32=True)
        for kname, (fn, _) in fns.items():
            ms, clk, pwr = _time_ms(fn)
            print(f"  {kname} {vname}: {_fmt(ms, clk, pwr)}  [{card}]")
            cut.setdefault(kname, {})[vname] = ms
    for kname, t in cut.items():
        k = t["kernel"]
        split = {"products": k - t["no products"],
                 "despread": k - t["no despread"],
                 "store": k - t["no store"], "loads only": t["loads only"]}
        print(f"  {kname} split: " + ", ".join(
            f"{n} {v:.4f} ms" for n, v in split.items()) + f" of {k:.4f}")
        cut[kname]["split"] = split
    summary["cuts"] = cut

    if args.old is not None:
        old = tuple(_bind(_old_lib(args.old, n), args.old, n)
                    for n in SOURCES)
        k_old = {n: kc_new if _hopper(args.old, n) else kc_old
                 for n in SOURCES}
        fns = {"old": both(old, k_old), "new": both(new_libs(), k_new)}
        same = {}
        for kname in fns["new"]:
            got = {}
            for tag in ("old", "new"):
                fn, res = fns[tag][kname]
                fn()
                torch.cuda.synchronize()
                got[tag] = res.float().clone()
            err = float(torch.sum((got["new"] - got["old"]) ** 2)
                        / torch.sum(got["old"] ** 2))
            db = 10 * torch.log10(torch.tensor(max(err, 1e-30))).item()
            same[kname] = bool(torch.equal(got["new"], got["old"]))
            print(f"  {kname}: new vs old NMSE {db:.2f} dB, "
                  f"{'bit-identical' if same[kname] else 'not identical'}")
            if not db <= -45.0:
                raise AssertionError(f"{kname}: the designs disagree "
                                     f"({db:.2f} dB)")
        summary["identical_to_old"] = same
        print(f"A/B in turns (old, new, new, old), S = {S}:")
        ab = {k: [] for k in fns["new"]}
        for tag in ("old", "new", "new", "old"):
            for kname, (fn, _) in fns[tag].items():
                ms, clk, pwr = _time_ms(fn)
                print(f"  {tag} {kname}: {_fmt(ms, clk, pwr)}  [{card}]")
                ab[kname].append((tag, ms, clk, pwr))
        summary["ab"] = ab

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
