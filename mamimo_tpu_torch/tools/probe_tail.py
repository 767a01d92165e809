#!/usr/bin/env python3
"""Where the two MLP tail kernels spend their time, on the card.

    python3 mamimo_tpu_torch/tools/probe_tail.py [--old DIR]

At the full BS32 width (H = 1024, num_tx = 32, 234 carriers), random
seeded weights, CUDA events, with the card's SM clock and power draw
sampled by ``nvidia-smi`` beside each timed window:

1. blocks in flight: ``factored_tail`` at S = 64, 128, 256 and 4096
   (64 to 4096 blocks);
2. phase cuts: ``factored_tail`` at S = 4096 built with
   ``-DTAIL_CUT=<bits>`` (see ``csrc/tail_sm90.cuh``), each cutting one
   phase out (building h, the layer-2 products, the layer-3 products,
   all products). The differences split the kernel's time by phase. The
   cut builds compute wrong answers by design and are never used
   outside this probe;
3. cluster size: both tails built with ``-DTAIL_CLUSTER=1, 2, 4``
   (blocks sharing each weight tile by TMA multicast; 2 is the kernel's),
   ``factored_tail`` at S = 4096 and ``mlp_infer_tail`` at M = 131072
   rows; each build's answer must equal the default build's;
4. the streaming mode above 1024 units (``STREAM`` in
   ``csrc/tail_sm90.cuh``): ``factored_rows_tail`` on both planes'
   rows at hidden (2048, 2048) and (4096, 1024), 131072 rows a plane,
   whole and with the phase cuts, and ``mlp_infer_tail`` at H 2048;
5. with ``--old DIR``: each tail against an earlier design whose sources
   (``fused_factored.cu``, ``mlp_infer.cu`` and their headers, e.g. a
   ``git archive`` of an earlier commit's ``mamimo_tpu_torch/csrc``) lie
   in DIR and keep the C launch functions of the commit before the
   streaming mode (``factored_tail_launch`` with one hidden width H),
   timed in turns (old, new, new, old) in one process at H 1024.

Prints one line per measurement, and a JSON summary as the last line.
Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CUTS = {                 # TAIL_CUT bits of csrc/tail_sm90.cuh
    "no h build": 1,
    "no layer-2 mma": 2,
    "no layer-3 mma": 4,
    "no mma": 2 | 4,
}
SMI = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
       "--format=csv,noheader,nounits"]


def _time_ms(fn, iters=20):
    """Mean device ms of fn over iters launches (CUDA events), and the
    median SM clock (MHz) and power draw (W) sampled every 20 ms from just
    before the window to its end."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen([*SMI, "-lms", "20"], stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, text=True)
    try:
        # the sampler's first line: it runs before the window starts
        first = smi.stdout.readline()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in line.split(",")]
               for line in [first, *out.splitlines()]
               if line.count(",") == 1]
    clk = statistics.median(s[0] for s in samples) if samples else None
    pwr = statistics.median(s[1] for s in samples) if samples else None
    return a.elapsed_time(b) / iters, clk, pwr


def _fmt(ms, clk, pwr):
    return (f"{ms:.4f} ms (SM clock {clk} MHz, {pwr} W)" if clk is not None
            else f"{ms:.4f} ms (clocks not sampled)")


def _old_lib(src_dir: Path, name: str) -> ctypes.CDLL:
    """csrc/<name>.cu of an earlier design, built from src_dir into
    _build/ (hashed apart from the package's own builds)."""
    from mamimo_tpu_torch.ops.kernels import _build

    h = hashlib.sha256(b"old")
    for src in sorted(src_dir.glob("*.cu*")):
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"old-{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build._flags(), "-o", str(out),
                        str(src_dir / f"{name}.cu")], check=True,
                       capture_output=True, timeout=600)
    return ctypes.CDLL(str(out))


def _argtypes(lib, fn, n_ptr, n_int=4):
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    return f


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of an earlier design's csrc sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_tail: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked, plane
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _TAIL_ARGS,
        _ff_lib,
        factored_tail,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        _mlp_lib,
        prepare_mlp_infer_weights,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    _build.build_all(("fused_factored", "mlp_infer"))
    cfg, tcfg = SimConfig(), TrainConfig()
    C, nt, H = cfg.num_carriers, cfg.num_tx, tcfg.hidden[0]
    params, bn = init_stacked(torch.Generator().manual_seed(0), cfg, tcfg,
                              device="cuda")
    prep = prepare_factored_weights(cfg, tcfg, params, bn)
    pm = plane(prepare_mlp_infer_weights(tcfg, params, bn), 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    summary = {"card": card}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    print("blocks in flight (factored_tail):")
    for s in (64, 128, 256, 4096):
        sp = torch.randn((2, s, H), generator=g, device="cuda")
        ms, clk, pwr = _time_ms(lambda: factored_tail(prep, sp, C))
        blocks = 2 * nt * -(-s // 64)
        print(f"  S={s}: {blocks} blocks, {_fmt(ms, clk, pwr)}")
        summary[f"factored_tail S={s}"] = ms

    s, M = 4096, 4096 * nt
    sp = torch.randn((2, s, H), generator=g, device="cuda")
    out = torch.empty((2, s, nt, C), device="cuda")
    ff_args = [sp.data_ptr(), *(prep[k].data_ptr() for k in _TAIL_ARGS),
               out.data_ptr(), s, nt, H, H, C, prep["b3"].shape[-1]]
    h1 = torch.randn((M, H), generator=g, device="cuda").to(torch.bfloat16)
    y = torch.empty((M, C), device="cuda")
    mk = ("w2t", "b2", "s2", "t2", "w3t", "b3")
    mlp_args = [h1.data_ptr(), *(pm[k].data_ptr() for k in mk),
                y.data_ptr(), M, H, H, C]

    def ff_run(lib, argv=ff_args):
        rc = lib.factored_tail_launch(*argv, stream())
        if rc:
            raise RuntimeError(f"factored_tail_launch: CUDA error {rc}")

    def mlp_run(lib, argv=mlp_args):
        rc = lib.mlp_tail_launch(*argv, stream())
        if rc:
            raise RuntimeError(f"mlp_tail_launch: CUDA error {rc}")

    print(f"phase cuts (factored_tail, S={s}):")
    libs = {"kernel": _ff_lib()}
    libs.update({n: _ff_lib((f"TAIL_CUT={b}",)) for n, b in CUTS.items()})
    for n, lib in libs.items():
        ms, clk, pwr = _time_ms(lambda lib=lib: ff_run(lib))
        print(f"  {n}: {_fmt(ms, clk, pwr)}  [{card}]")
        summary[f"cut {n}"] = ms

    print(f"cluster size (factored_tail S={s}, mlp_infer_tail M={M}):")
    ff_run(_ff_lib())
    mlp_run(_mlp_lib())
    torch.cuda.synchronize()
    ref_ff, ref_mlp = out.clone(), y.clone()
    for cl in (1, 2, 4):
        d = (f"TAIL_CLUSTER={cl}",)
        lf = _ff_lib(d)
        lm = _build.library("mlp_infer", d)
        _argtypes(lm, "mlp_tail_launch", 8)
        out.zero_()
        y.zero_()
        ff_run(lf)
        mlp_run(lm)
        torch.cuda.synchronize()
        same = torch.equal(out, ref_ff) and torch.equal(y, ref_mlp)
        if not same:
            raise AssertionError(f"TAIL_CLUSTER={cl} changed the answer")
        t_ff = _time_ms(lambda: ff_run(lf))
        t_mlp = _time_ms(lambda: mlp_run(lm))
        print(f"  CL={cl}: factored_tail {_fmt(*t_ff)}; mlp_infer_tail "
              f"{_fmt(*t_mlp)}; answers equal the default build's  "
              f"[{card}]")
        summary[f"CL={cl}"] = {"factored_tail": t_ff[0],
                               "mlp_infer_tail": t_mlp[0]}

    print(f"streaming mode (rows above 1024 units), M = 2 x {M}:")
    for hidden in ((2048, 2048), (4096, 1024)):
        tw = TrainConfig(hidden=hidden)
        pw, bw = init_stacked(torch.Generator().manual_seed(2), cfg, tw,
                              device="cuda")
        prw = prepare_factored_weights(cfg, tw, pw, bw)
        hw = torch.randn((2, M, hidden[0]), generator=g,
                         device="cuda").to(torch.bfloat16)
        yw = torch.empty((2, M, C), device="cuda")
        argw = [hw.data_ptr(), *(prw[k].data_ptr() for k in
                                 ("w2t", "b2", "a2", "c2", "w3t", "b3")),
                yw.data_ptr(), M, hidden[0], hidden[1], C,
                prw["b3"].shape[-1]]

        def rows_run(lib, argv=argw):
            rc = lib.factored_rows_tail_launch(*argv, stream())
            if rc:
                raise RuntimeError(f"factored_rows_tail_launch: CUDA error "
                                   f"{rc}")

        for n, lib in libs.items():
            ms, clk, pwr = _time_ms(lambda lib=lib: rows_run(lib), iters=5)
            print(f"  factored_rows_tail {hidden} {n}: {_fmt(ms, clk, pwr)}"
                  f"  [{card}]")
            summary[f"stream {hidden} {n}"] = ms
        del pw, bw, prw, hw, yw
    tw = TrainConfig(hidden=(2048, 2048))
    pw, bw = init_stacked(torch.Generator().manual_seed(3), cfg, tw,
                          device="cuda")
    pmw = plane(prepare_mlp_infer_weights(tw, pw, bw), 0)
    h1w = torch.randn((M, 2048), generator=g, device="cuda").to(torch.bfloat16)
    argm = [h1w.data_ptr(), *(pmw[k].data_ptr() for k in mk), y.data_ptr(),
            M, 2048, 2048, C]
    ms, clk, pwr = _time_ms(lambda: mlp_run(_mlp_lib(), argm), iters=5)
    print(f"  mlp_infer_tail (2048, 2048): {_fmt(ms, clk, pwr)}  [{card}]")
    summary["stream mlp_infer_tail (2048, 2048)"] = ms
    del pw, bw, pmw, h1w

    if args.old is not None:
        old_ff = _old_lib(args.old, "fused_factored")
        old_mlp = _old_lib(args.old, "mlp_infer")
        _argtypes(old_ff, "factored_tail_launch", 11)
        _argtypes(old_mlp, "mlp_tail_launch", 8)
        # the commit before the streaming mode: one hidden width H, b3
        # of 256 columns a plane
        ff_old = [sp.data_ptr(), *(prep[k].data_ptr() for k in _TAIL_ARGS),
                  out.data_ptr(), s, nt, H, C]
        mlp_old = mlp_args
        new_ff, new_mlp = _ff_lib(), _mlp_lib()
        print(f"A/B in turns (old, new, new, old), S={s} / M={M}:")
        ab = {"factored_tail": [], "mlp_infer_tail": []}
        for tag, kind in (("old", 0), ("new", 1), ("new", 1), ("old", 0)):
            t_ff = _time_ms(lambda: ff_run(old_ff, ff_old) if kind == 0
                            else ff_run(new_ff))
            t_mlp = _time_ms(lambda: mlp_run(old_mlp, mlp_old) if kind == 0
                             else mlp_run(new_mlp))
            print(f"  {tag}: factored_tail {_fmt(*t_ff)}; mlp_infer_tail "
                  f"{_fmt(*t_mlp)}  [{card}]")
            ab["factored_tail"].append((tag, *t_ff))
            ab["mlp_infer_tail"].append((tag, *t_mlp))
        summary["ab"] = ab

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
