#!/usr/bin/env python3
"""Where the two MLP tail kernels spend their time, on the card.

    python3 mamimo_tpu_torch/tools/probe_tail.py [--old DIR] [--f32]
        [--heads]

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
4. the bf16 rows tails: ``factored_rows_tail`` on both planes' rows at
   hidden (2048, 2048), (4096, 1024), (1536, 640) and (1024, 1024,
   1024), and ``mlp_infer_tail`` at 2048 units, on their two-GEMM route
   (``csrc/mm_sm90.cuh``), held to the plain version in dB,
   each design's bytes into an SM a row printed beside it; with ``--old
   DIR`` the earlier fused tail of DIR (its rows streamed slab by slab
   above 1024 units) beside them, held in dB too, and at the streamed
   widths its phase cuts (``-DTAIL_CUT``), cluster sizes
   (``-DTAIL_CLUSTER=1/4``) and a copy without the loads of h's slabs
   (``NO_H_LOADS``), timed in turns (old, new, ..., new, old);
5. with ``--f32``: the float32 mode's tail (``layers23_f32``):
   ``factored_rows_tail`` on both planes' float32 rows and
   ``mlp_infer_tail`` on one plane's, 131072 rows a plane, hidden (1024,
   1024), whole and with the phase cuts (bit 1 then cuts the TF32 split
   of h in registers; "no mma" leaves the loads of h and of both parts
   of each W tile); then the tail built with other stretches (copies of
   the sources with ``tail_sm90.cuh``'s ``F_STRETCH`` set to 2, 4 or 8,
   ``stretch_sources``) and, with ``--old DIR``, the earlier design's
   float32 tails (their weights unsplit) beside the package's own, each
   held to its plain version in dB, timed in turns (old, each stretch,
   then back);
6. with ``--heads --old DIR`` (alone, instead of 1-7): the bf16
   per-head rows ``factored_heads`` (``factored_heads_launch``, mode 0)
   at S = 4096, nt = 32 and H1 1024, 1536, 2048 and 4096 against DIR's,
   bit for bit, then in turns (old, new, new, old) beside its byte bound;
   and the two-GEMM route's outputs bit for bit against DIR's at widths
   where H2 % 256 = 128 (the hidden layer's epilogue reads its bias and
   affine only at the layer's N columns): ``factored_rows_gemms_launch``
   at hidden (1536, 640), ``mlp_tail_gemms_launch`` at 1152 units and
   bf16 ``factored_dense``'s hidden layer of 640 units (DIR's launch
   given the vectors padded to 768 a plane, as its wrapper padded them),
   each with its hidden rows;
7. with ``--old DIR``: the bf16 tails (``factored_tail``,
   ``mlp_infer_tail`` at H 1024, held bit for bit; ``factored_rows_tail``
   at (1024, 1024) on the per-head rows, the earlier fused tail against
   the two GEMMs, each in dB of the plain version) against an earlier
   design whose sources (``fused_factored.cu``, ``mlp_infer.cu`` and their
   headers, e.g. a ``git archive`` of an earlier commit's
   ``mamimo_tpu_torch/csrc``, one that serves two hidden widths) lie in
   DIR: each launch function is bound from its declaration in its own
   source (an earlier design's has no mode argument), then timed in turns
   (old, new, new, old) in one process at H 1024.

Prints one line per measurement, and a JSON summary as the last line.
Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CSRC = ROOT / "mamimo_tpu_torch" / "csrc"

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


def _launch_fn(lib, src_dir: Path, name: str, fn: str):
    """Launch function fn of lib, bound from its declaration in
    src_dir/<name>.cu: a callable of the arguments before the stream,
    trailing ints it is not given passed as 0 (the mode, bf16 with a
    float32 store, where the source has one). Raises on a launch error."""
    import torch

    m = re.search(rf"int {fn}\(([^)]*)\)", (src_dir / f"{name}.cu").read_text())
    params = m.group(1).split(",")
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p if "*" in q else ctypes.c_int
                  for q in params]

    def call(*argv):
        args = list(argv) + [0] * (len(params) - 1 - len(argv))
        rc = f(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{fn}: CUDA error {rc}")

    return call


STRETCH = {"gemm": ("gemm_sm90.cuh", "TF_STRETCH"),    # gemm_tf32x3's
           "tail": ("tail_sm90.cuh", "F_STRETCH")}     # layers23_f32's


def const_copy(header: str, name: str, value: int) -> Path:
    """A copy of the package's csrc under _build/ with ``constexpr int
    NAME = ...;`` of header set to value, for _old_lib and _launch_fn."""
    from mamimo_tpu_torch.ops.kernels import _build

    pat = rf"constexpr int {name} = [^;]+;"
    text = (CSRC / header).read_text()
    if not re.search(pat, text):
        raise ValueError(f"{header} has no constexpr int {name}")
    d = _build.BUILD_DIR / f"const-{Path(header).stem}-{name}-{value}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    (d / header).write_text(re.sub(pat, f"constexpr int {name} = {value};",
                                   text))
    return d


def stretch_sources(body: str, stretches=(2, 4, 8)) -> tuple[int, dict]:
    """The package's own stretch of a float32 body ("gemm" or "tail":
    the k-steps of 32 it sums into a fresh accumulator, a constant in
    its header) and, for each other stretch n, a copy of the package's
    csrc with that constant set to n (const_copy): {n: directory}, for
    _old_lib and _launch_fn."""
    header, name = STRETCH[body]
    own = int(re.search(rf"constexpr int {name} = (\d+);",
                        (CSRC / header).read_text()).group(1))
    return own, {n: const_copy(header, name, n) for n in stretches
                 if n != own}


def _f32_ab(old, ff_lib, mlp_lib, rows_run, mlp_run, p32, pm32, h32, y32,
            y, arg32, m32, M, H, C, card, summary) -> None:
    """The float32 tails built with each stretch (stretch_sources) and, with
    old, the earlier design's (W2 and W3 unsplit, split in shared memory)
    beside the package's own, each against its plain version on the same
    rows, timed in turns (old, the stretches up, then back down)."""
    import torch

    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _hidden_plain,
        _out_plain,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import _tail_plain
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    def db(got, ref):
        g64, r64 = got.double(), ref.double()
        return 10 * float(torch.log10((g64 - r64).square().sum()
                                      / r64.square().sum()))

    rows = 8192                 # rows of each plane held to the plain version
    with full_f32_matmul():
        ref_rows = _out_plain(p32, _hidden_plain(p32, 2, h32[:, :rows]), C)
        ref_mlp = _tail_plain(pm32, h32[0, :rows], torch.float32)
    own, dirs = stretch_sources("tail")
    designs = {f"stretch {n}": (d, arg32, m32) for n, d in dirs.items()}
    designs[f"stretch {own} (the package's)"] = (CSRC, arg32, m32)
    if old is not None:
        # the earlier design reads the unsplit K-major weights
        kt = lambda w: w.transpose(-1, -2).contiguous()  # noqa: E731
        unsplit = [kt(p32["w2"]), kt(p32["w3"]), kt(pm32["w2"]),
                   kt(pm32["w3"])]
        old_arg32, old_m32 = list(arg32), list(m32)
        old_arg32[1], old_arg32[5] = (t.data_ptr() for t in unsplit[:2])
        old_m32[1], old_m32[5] = (t.data_ptr() for t in unsplit[2:])
        designs = {"old": (old, old_arg32, old_m32), **designs}
    with ThreadPoolExecutor(2 * len(designs)) as pool:   # nvcc in parallel
        list(pool.map(lambda a: _old_lib(*a), [
            (d, n) for d, *_ in designs.values() if d != CSRC
            for n in ("fused_factored", "mlp_infer")]))
    libs = {tag: (ff_lib(src=d), mlp_lib(src=d), a_rows, a_mlp)
            for tag, (d, a_rows, a_mlp) in designs.items()}
    for tag, (lf, lm, a_rows, a_mlp) in libs.items():
        y32.zero_()
        y.zero_()
        rows_run(lf, a_rows)
        mlp_run(lm, a_mlp)
        torch.cuda.synchronize()
        e_rows = db(y32.view(2, M, C)[:, :rows], ref_rows)
        e_mlp = db(y[:rows], ref_mlp)
        print(f"{tag}: float32 tails against their plain versions "
              f"({rows} rows a plane): factored_rows_tail {e_rows:.2f} dB, "
              f"mlp_infer_tail {e_mlp:.2f} dB")
        summary[f"f32 {tag} db"] = {"factored_rows_tail": e_rows,
                                    "mlp_infer_tail": e_mlp}
    order = [*libs, *reversed(libs)]
    print(f"float32 A/B in turns ({', '.join(order)}), M = 2 x {M} / {M}:")
    ab = {"factored_rows_tail": [], "mlp_infer_tail": []}
    for tag in order:
        lf, lm, a_rows, a_mlp = libs[tag]
        t_rows = _time_ms(lambda: rows_run(lf, a_rows), iters=5)
        t_mlp = _time_ms(lambda: mlp_run(lm, a_mlp), iters=5)
        print(f"  {tag}: factored_rows_tail {_fmt(*t_rows)}; mlp_infer_tail "
              f"{_fmt(*t_mlp)}  [{card}]", flush=True)
        ab["factored_rows_tail"].append((tag, *t_rows))
        ab["mlp_infer_tail"].append((tag, *t_mlp))
    summary["f32 ab"] = ab


def _db(got, ref) -> float:
    import torch

    g64, r64 = got.double(), ref.double()
    return 10 * float(torch.log10((g64 - r64).square().sum()
                                  / r64.square().sum()))


def _copy_lib(src_dir: Path, name: str, defines=(), edits=()):
    """csrc/<name>.cu of src_dir built with -D defines into _build/, after
    the regex edits (file, pattern, replacement) to a copy of the sources
    (hashed apart from every other build)."""
    from mamimo_tpu_torch.ops.kernels import _build

    h = hashlib.sha256(repr((defines, edits)).encode())
    for src in sorted(src_dir.glob("*.cu*")):
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    out = _build.BUILD_DIR / f"copy-{name}-{tag}.so"
    if not out.exists():
        d = _build.BUILD_DIR / f"copy-src-{tag}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src_dir, d)
        for f, pat, rep in edits:
            text, n = re.subn(pat, rep, (d / f).read_text())
            if n == 0:
                raise ValueError(f"{f} has no {pat!r}")
            (d / f).write_text(text)
        subprocess.run([_build._nvcc(), *_build._flags(defines), "-o",
                        str(out), str(d / f"{name}.cu")], check=True,
                       capture_output=True, timeout=900)
    return ctypes.CDLL(str(out))


# the earlier streamed tail (tail_sm90.cuh's STREAM mode, before the
# two-GEMM route)
# without the TMA loads of h's slabs: what the loads of W alone cost
NO_H_LOADS = (
    ("tail_sm90.cuh", r"STREAM && r < KT \? SLAB_BYTES : 0", "0"),
    ("tail_sm90.cuh", r"if constexpr \(STREAM\)\n(\s+)tma_load_3d\(sh",
     r"if constexpr (false)\n\1tma_load_3d(sh"))


def _intake_per_row(design: str, h1: int, h2: int) -> float:
    """Bytes into an SM per row of the last hidden layer and the output
    (256 padded columns), bf16, as each design's tiles bring them in (a
    multicast box counted in every block that receives it): the fused
    tail's 64-row block takes W2 and W3 once per 64 rows and h once
    (resident) or once per 128 columns of W2 (streamed); a GEMM on 128 x
    256 tiles takes a row's A once per 256 columns and B's 256 x K once
    per 128 rows, for both layers (h2 written and read once on top)."""
    w = (h1 * h2 + h2 * 256) * 2 / 64
    if design == "fused":
        return w + h1 * 2 * (h2 // 128 if h1 > 1024 else 1)
    gemm = lambda k, n: n / 256 * (k * 2 + 256 * k * 2 / 128)  # noqa: E731
    return gemm(h1, h2) + gemm(h2, 256)


def _rows_section(args, cfg, card, summary, g, M) -> None:
    """The bf16 rows tails (factored_rows_tail on both planes' rows,
    mlp_infer_tail at 2048 units): the two-GEMM route against the
    plain version in dB and timed; with args.old the earlier fused tail
    of DIR (streamed slab by slab above 1024 units) beside them, held in
    dB too, its phase cuts (TAIL_CUT), cluster sizes (TAIL_CLUSTER) and
    a copy without h's loads at the streamed widths, all in turns (old,
    new, new, old); each design's bytes into an SM a row printed beside
    its time."""
    import torch

    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked, plane
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _hidden_plain,
        _out_plain,
        factored_rows_tail,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        _tail_plain,
        mlp_infer_tail,
        prepare_mlp_infer_weights,
    )
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    C = cfg.num_carriers
    keys = ("w2t", "b2", "a2", "c2", "w3t", "b3")
    old_libs = {}
    if args.old is not None:
        variants = {"old": ((), ())}
        variants.update({f"old {n}": ((f"TAIL_CUT={b}",), ())
                         for n, b in CUTS.items() if b != 1})
        variants.update({f"old CL={c}": ((f"TAIL_CLUSTER={c}",), ())
                         for c in (1, 4)})
        variants["old no h loads"] = ((), NO_H_LOADS)
        with ThreadPoolExecutor(len(variants)) as pool:       # nvcc at once
            built = list(pool.map(lambda v: _copy_lib(
                args.old, "fused_factored", *v), variants.values()))
        old_libs = {n: _launch_fn(lib, args.old, "fused_factored",
                                  "factored_rows_tail_launch")
                    for n, lib in zip(variants, built)}
    print(f"the bf16 rows tails, M = 2 x {M} rows (bytes into an SM a row "
          f"beside each design):")
    for hidden in ((2048, 2048), (4096, 1024), (1536, 640),
                   (1024, 1024, 1024)):
        tw = TrainConfig(hidden=hidden)
        pw, bw = init_stacked(torch.Generator().manual_seed(2), cfg, tw,
                              device="cuda")
        prw = prepare_factored_weights(cfg, tw, pw, bw)
        d = len(hidden)
        h1, h2 = prw[f"w{d}"].shape[1], prw[f"w{d}"].shape[2]
        kd = (f"w{d}t", f"b{d}", f"a{d}", f"c{d}", f"w{d + 1}t", f"b{d + 1}")
        hw = torch.relu(torch.randn((2, M, h1), generator=g,
                                    device="cuda")).to(torch.bfloat16)
        yw = torch.empty((2, M, C), device="cuda")
        argw = [hw.data_ptr(), *(prw[k].data_ptr() for k in kd),
                yw.data_ptr()]
        ints = [M, h1, h2, C, prw[f"b{d + 1}"].shape[-1]]
        with full_f32_matmul():
            ref = _out_plain(prw, _hidden_plain(prw, d, hw[:, :8192]), C)
        runs = {"new": lambda: factored_rows_tail(prw, hw, C)}
        runs.update({n: (lambda f=f: f(*argw, *ints, 0))
                     for n, f in old_libs.items()})
        for n, run in runs.items():
            if n not in ("new", "old"):
                continue             # the cuts' answers are wrong by design
            yw.fill_(float("nan"))
            got = run()
            torch.cuda.synchronize()
            got = yw if got is None else got
            print(f"  {hidden} {n}: {_db(got[:, :8192], ref):.2f} dB vs the "
                  f"plain version")
        fused_in = _intake_per_row("fused", h1, h2)
        gemm_in = _intake_per_row("gemms", h1, h2)
        print(f"  {hidden}: bytes into an SM a row: fused tail "
              f"{fused_in:.0f}, two GEMMs {gemm_in:.0f}")
        order = [n for n in runs if n in ("old", "new")]
        order += [n for n in runs if n not in order]
        ts = {n: [] for n in runs}
        for n in order + order[::-1]:
            if n.startswith("old ") and (h1 <= 1024 or len(ts[n])):
                continue             # the old cuts: streamed widths, once
            ts[n].append(_time_ms(runs[n], iters=3)[0])
        for n, v in ts.items():
            if v:
                print(f"  {hidden} {n}: " + " / ".join(f"{x:.4f}" for x in v)
                      + f" ms  [{card}]", flush=True)
        summary[f"rows {hidden}"] = {"ms": ts, "intake_per_row": {
            "fused": fused_in, "gemms": gemm_in}}
        del pw, bw, prw, hw, yw
        torch.cuda.empty_cache()
    # mlp_infer_tail at 1024 units, one plane: the resident fused tail it
    # runs beside the two GEMMs it does not take there
    tw = TrainConfig(hidden=(1024, 1024))
    pw, bw = init_stacked(torch.Generator().manual_seed(3), cfg, tw,
                          device="cuda")
    pm = plane(prepare_mlp_infer_weights(tw, pw, bw), 0)
    h1w = torch.relu(torch.randn((M, 1024), generator=g,
                                 device="cuda")).to(torch.bfloat16)
    h2w = torch.empty((M, 1024), device="cuda", dtype=torch.bfloat16)
    yw = torch.empty((M, C), device="cuda")
    gemms = _launch_fn(_build.library("mlp_infer"), CSRC, "mlp_infer",
                       "mlp_tail_gemms_launch")
    argg = [h1w.data_ptr(), *(pm[k].data_ptr() for k in
                              ("w2t", "b2", "s2", "t2", "w3t", "b3")),
            yw.data_ptr(), h2w.data_ptr(), M, 1024, 1024, C]
    with full_f32_matmul():
        ref = _tail_plain(pm, h1w[:8192])
    gemms(*argg)
    torch.cuda.synchronize()
    print(f"  mlp_infer_tail 1024: fused {_db(mlp_infer_tail(pm, h1w)[:8192], ref):.2f}"
          f" dB, two GEMMs {_db(yw[:8192], ref):.2f} dB vs the plain version")
    runs = {"fused (the route)": lambda: mlp_infer_tail(pm, h1w),
            "two GEMMs": lambda: gemms(*argg)}
    ts = {n: [] for n in runs}
    for n in list(runs) + list(runs)[::-1]:
        ts[n].append(_time_ms(runs[n], iters=5)[0])
    print("  mlp_infer_tail (1024, 1024): " + "; ".join(
        f"{n} " + " / ".join(f"{x:.4f}" for x in v) for n, v in ts.items())
        + f" ms  [{card}]")
    summary["mlp_infer_tail (1024, 1024)"] = ts
    del pw, bw, pm, h1w, h2w
    # mlp_infer_tail at 2048 units, one plane
    tw = TrainConfig(hidden=(2048, 2048))
    pw, bw = init_stacked(torch.Generator().manual_seed(3), cfg, tw,
                          device="cuda")
    pm = plane(prepare_mlp_infer_weights(tw, pw, bw), 0)
    h1w = torch.relu(torch.randn((M, 2048), generator=g,
                                 device="cuda")).to(torch.bfloat16)
    yw = torch.empty((M, C), device="cuda")
    with full_f32_matmul():
        ref = _tail_plain(pm, h1w[:8192])
    runs = {"new": lambda: mlp_infer_tail(pm, h1w)}
    if args.old is not None:
        old_mlp = _launch_fn(_old_lib(args.old, "mlp_infer"), args.old,
                             "mlp_infer", "mlp_tail_launch")
        argm = [h1w.data_ptr(), *(pm[k].data_ptr() for k in
                                  ("w2t", "b2", "s2", "t2", "w3t", "b3")),
                yw.data_ptr(), M, 2048, 2048, C]
        runs["old"] = lambda: old_mlp(*argm)
        old_mlp(*argm)
        torch.cuda.synchronize()
        print(f"  mlp_infer_tail 2048: old {_db(yw[:8192], ref):.2f} dB, new "
              f"{_db(mlp_infer_tail(pm, h1w[:8192]), ref):.2f} dB vs the "
              f"plain version")
    order = ["old", "new", "new", "old"] if "old" in runs else ["new"]
    ts = {n: [] for n in runs}
    for n in order:
        ts[n].append(_time_ms(runs[n], iters=3)[0])
    print("  mlp_infer_tail (2048, 2048): " + "; ".join(
        f"{n} " + " / ".join(f"{x:.4f}" for x in v) for n, v in ts.items())
        + f" ms  [{card}]")
    summary["mlp_infer_tail (2048, 2048)"] = ts


HBM_BYTES_PER_S = 3.35e12                # H100 SXM


def _heads_section(old: Path, card: str, summary: dict) -> None:
    """factored_heads (bf16 rows) against DIR's kernel, bit for bit and in
    turns, at H1 1024 / 1536 / 2048 / 4096 (S = 4096, nt = 32)."""
    import torch

    from mamimo_tpu_torch.ops.kernels import _build

    S, nt = 4096, 32
    fn = "factored_heads_launch"
    new = _launch_fn(_build.library("fused_factored"), CSRC,
                     "fused_factored", fn)
    oldf = _launch_fn(_old_lib(old, "fused_factored"), old,
                      "fused_factored", fn)
    g = torch.Generator(device="cuda").manual_seed(5)
    print(f"factored_heads (bf16 rows), S = {S}, nt = {nt}, in turns (old, "
          f"new, new, old):")
    for h1 in (1024, 1536, 2048, 4096):
        sp = torch.randn((2, S, h1), generator=g, device="cuda")
        hb = torch.randn((2, nt, h1), generator=g, device="cuda")
        a1 = torch.rand((2, h1), generator=g, device="cuda") + 0.5
        c1 = torch.randn((2, h1), generator=g, device="cuda")
        outs = {t: torch.empty((2, S * nt, h1), dtype=torch.bfloat16,
                               device="cuda") for t in ("old", "new")}
        runs = {t: (lambda f=f, o=outs[t]: f(sp.data_ptr(), hb.data_ptr(),
                                             a1.data_ptr(), c1.data_ptr(),
                                             o.data_ptr(), S, nt, h1))
                for t, f in (("old", oldf), ("new", new))}
        for r in runs.values():
            r()
        torch.cuda.synchronize()
        same = torch.equal(outs["old"], outs["new"])
        nb = 2 * S * nt * h1 * 2 + (2 * S * h1 + 2 * nt * h1 + 4 * h1) * 4
        bound = nb / HBM_BYTES_PER_S * 1e3
        ts = []
        for t in ("old", "new", "new", "old"):
            ms, clk, pwr = _time_ms(runs[t])
            ts.append((t, ms, clk, pwr))
            print(f"  H1 {h1} {t}: {_fmt(ms, clk, pwr)}, "
                  f"{bound / ms * 100:.1f}% of {bound:.4f} ms  [{card}]",
                  flush=True)
        print(f"  H1 {h1}: new and old "
              + ("bit-identical" if same else "DIFFER"))
        summary[f"heads H1={h1}"] = {"bound_ms": bound, "ms": ts,
                                     "identical": same}
        if not same:
            raise AssertionError(f"factored_heads at H1 {h1} changed")
        del sp, hb, a1, c1, outs


def _route_bits_section(old: Path, cfg, summary: dict) -> None:
    """The two-GEMM route where H2 % 256 = 128, against DIR's launches
    bit for bit: factored_rows_gemms_launch at (1536, 640),
    mlp_tail_gemms_launch at 1152 units, factored_dense's hidden layer of
    640 units (DIR's given the vectors padded to 768, as its wrapper
    did)."""
    import torch

    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked, plane
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        factored_dense,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        prepare_mlp_infer_weights,
    )

    C, M = cfg.num_carriers, 32768
    g = torch.Generator(device="cuda").manual_seed(6)
    lib_o = _old_lib(old, "fused_factored")
    lib_n = _build.library("fused_factored")
    same = {}

    def run_both(src_fn, name, argv_of):
        """argv_of(tag) -> (argv, outputs) for DIR's and the package's."""
        got = {}
        for tag, lib, src in (("old", lib_o, old), ("new", lib_n, CSRC)):
            argv, outs = argv_of(tag)
            for o in outs:
                o.fill_(float("nan"))
            _launch_fn(lib, src, src_fn[0], src_fn[1])(*argv)
            torch.cuda.synchronize()
            got[tag] = [o.clone() for o in outs]
        same[name] = all(torch.equal(a, b) for a, b in zip(got["old"],
                                                            got["new"]))
        print(f"  {name}: new and old "
              + ("bit-identical" if same[name] else "DIFFER"))

    # factored_rows_tail's two GEMMs at hidden (1536, 640)
    tw = TrainConfig(hidden=(1536, 640))
    pw, bw = init_stacked(torch.Generator().manual_seed(7), cfg, tw,
                          device="cuda")
    prw = prepare_factored_weights(cfg, tw, pw, bw)
    for k in ("b2", "a2", "c2"):
        prw[k] = torch.randn(prw[k].shape, generator=g, device="cuda")
    h = torch.relu(torch.randn((2, M, 1536), generator=g,
                               device="cuda")).to(torch.bfloat16)
    y = torch.empty((2, M, C), device="cuda")
    h2 = torch.empty((2, M, 640), dtype=torch.bfloat16, device="cuda")
    keys = ("w2t", "b2", "a2", "c2", "w3t", "b3")
    run_both(("fused_factored", "factored_rows_gemms_launch"),
             "factored_rows_tail (1536, 640)",
             lambda tag: ([h.data_ptr(), *(prw[k].data_ptr() for k in keys),
                           y.data_ptr(), h2.data_ptr(), M, 1536, 640, C,
                           prw["b3"].shape[-1], 0], [y, h2]))
    # bf16 factored_dense, the hidden layer of 640 units of (1536, 640,
    # 640): DIR's launch on vectors padded to 768 a plane
    tw = TrainConfig(hidden=(1536, 640, 640))
    pw, bw = init_stacked(torch.Generator().manual_seed(8), cfg, tw,
                          device="cuda")
    prd = prepare_factored_weights(cfg, tw, pw, bw)
    for k in ("b2", "a2", "c2"):
        prd[k] = torch.randn(prd[k].shape, generator=g, device="cuda")
    pad = {k: torch.nn.functional.pad(prd[k].reshape(2, 640), (0, 128))
           .contiguous() for k in ("b2", "a2", "c2")}
    yd = torch.empty((2, M, 640), dtype=torch.bfloat16, device="cuda")
    hd = h

    def dense_argv(tag):
        v = pad if tag == "old" else {k: prd[k] for k in pad}
        return ([hd.data_ptr(), prd["w2t"].data_ptr(),
                 *(v[k].data_ptr() for k in ("b2", "a2", "c2")),
                 yd.data_ptr(), M, 640, 1536, 0, 768 if tag == "old"
                 else 640, 0, 0], [yd])
    run_both(("fused_factored", "factored_dense_launch"),
             "factored_dense hidden 640", dense_argv)
    ref = yd.clone()
    torch.cuda.synchronize()
    same["factored_dense wrapper"] = torch.equal(
        factored_dense(prd, 2, hd), ref)
    print("  factored_dense(prepared, 2, h): "
          + ("bit-identical" if same["factored_dense wrapper"]
             else "DIFFERS") + " to the launch above")
    # mlp_infer_tail's two GEMMs at 1152 units, one plane
    tw = TrainConfig(hidden=(1152, 1152))
    pw, bw = init_stacked(torch.Generator().manual_seed(9), cfg, tw,
                          device="cuda")
    pm = plane(prepare_mlp_infer_weights(tw, pw, bw), 0)
    for k in ("b2", "s2", "t2"):
        pm[k] = torch.randn(pm[k].shape, generator=g, device="cuda")
    h1 = torch.relu(torch.randn((M, 1152), generator=g,
                                device="cuda")).to(torch.bfloat16)
    ym = torch.empty((M, C), device="cuda")
    h2m = torch.empty((M, 1152), dtype=torch.bfloat16, device="cuda")
    lib_o, lib_n = _old_lib(old, "mlp_infer"), _build.library("mlp_infer")
    mk = ("w2t", "b2", "s2", "t2", "w3t", "b3")
    run_both(("mlp_infer", "mlp_tail_gemms_launch"),
             "mlp_infer_tail 1152",
             lambda tag: ([h1.data_ptr(), *(pm[k].data_ptr() for k in mk),
                           ym.data_ptr(), h2m.data_ptr(), M, 1152, 1152, C],
                          [ym, h2m]))
    summary["route identical"] = same
    if not all(same.values()):
        raise AssertionError(f"the two-GEMM route changed: {same}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of an earlier design's csrc sources")
    ap.add_argument("--f32", action="store_true",
                    help="also time the float32 mode's tail")
    ap.add_argument("--heads", action="store_true",
                    help="alone, with --old: factored_heads and the "
                         "two-GEMM route against DIR's")
    args = ap.parse_args()
    if args.heads and args.old is None:
        ap.error("--heads needs --old DIR")
    if not torch.cuda.is_available():
        print("probe_tail: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked, plane
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _TAIL_ARGS,
        _hidden_plain,
        _out_plain,
        factored_heads,
        factored_rows_tail,
        factored_tail,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        prepare_mlp_infer_weights,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    _build.build_all(("fused_factored", "mlp_infer"))
    cfg, tcfg = SimConfig(), TrainConfig()
    if args.heads:
        summary = {"card": card}
        _heads_section(args.old, card, summary)
        print("the two-GEMM route where H2 % 256 = 128, against DIR's:")
        _route_bits_section(args.old, cfg, summary)
        print(json.dumps(summary))
        return 0
    C, nt, H = cfg.num_carriers, cfg.num_tx, tcfg.hidden[0]
    params, bn = init_stacked(torch.Generator().manual_seed(0), cfg, tcfg,
                              device="cuda")
    prep = prepare_factored_weights(cfg, tcfg, params, bn)
    pm = plane(prepare_mlp_infer_weights(tcfg, params, bn), 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    summary = {"card": card}

    def rows_run(lib, argv):
        lib["factored_rows_tail"](*argv)

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

    def ff_lib(defines=(), src=CSRC):
        """The fused_factored library built with defines (src: the
        package's sources), its launch functions bound."""
        lib = _build.library("fused_factored", defines) if src == CSRC \
            else _old_lib(src, "fused_factored")
        return {fn: _launch_fn(lib, src, "fused_factored", f"{fn}_launch")
                for fn in ("factored_tail", "factored_rows_tail")}

    def mlp_lib(defines=(), src=CSRC):
        lib = _build.library("mlp_infer", defines) if src == CSRC \
            else _old_lib(src, "mlp_infer")
        return _launch_fn(lib, src, "mlp_infer", "mlp_tail_launch")

    def ff_run(lib, argv=ff_args):
        lib["factored_tail"](*argv)

    def mlp_run(run, argv=mlp_args):
        run(*argv)

    print(f"phase cuts (factored_tail, S={s}):")
    libs = {"kernel": ff_lib()}
    libs.update({n: ff_lib((f"TAIL_CUT={b}",)) for n, b in CUTS.items()})
    for n, lib in libs.items():
        ms, clk, pwr = _time_ms(lambda lib=lib: ff_run(lib))
        print(f"  {n}: {_fmt(ms, clk, pwr)}  [{card}]")
        summary[f"cut {n}"] = ms

    print(f"cluster size (factored_tail S={s}, mlp_infer_tail M={M}):")
    ff_run(ff_lib())
    mlp_run(mlp_lib())
    torch.cuda.synchronize()
    ref_ff, ref_mlp = out.clone(), y.clone()
    for cl in (1, 2, 4):
        d = (f"TAIL_CLUSTER={cl}",)
        lf = ff_lib(d)
        lm = mlp_lib(d)
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

    _rows_section(args, cfg, card, summary, g, M)

    # the per-head rows of the (1024, 1024) model: factored_rows_tail's
    # argv (bf16), for the A/B below
    hr = factored_heads(prep, sp)
    yr = torch.empty((2, M, C), device="cuda")
    rows_args = [hr.data_ptr(), *(prep[k].data_ptr() for k in
                                  ("w2t", "b2", "a2", "c2", "w3t", "b3")),
                 yr.data_ptr(), M, H, H, C, prep["b3"].shape[-1]]

    if args.f32:
        f32 = torch.float32
        p32 = prepare_factored_weights(cfg, tcfg, params, bn, dot_dtype=f32)
        pm32 = plane(prepare_mlp_infer_weights(tcfg, params, bn,
                                               dot_dtype=f32), 0)
        h32 = torch.relu(torch.randn((2, M, H), generator=g, device="cuda"))
        y32 = torch.empty((2, M, C), device="cuda")
        fk = ("w2t_tf32", "b2", "a2", "c2", "w3t_tf32", "b3")
        arg32 = [h32.data_ptr(), *(p32[k].data_ptr() for k in fk),
                 y32.data_ptr(), M, H, H, C, p32["b3"].shape[-1], 2]
        mk32 = ("w2t_tf32", "b2", "s2", "t2", "w3t_tf32", "b3")
        m32 = [h32[0].data_ptr(), *(pm32[k].data_ptr() for k in mk32),
               y.data_ptr(), M, H, H, C, 2]
        print(f"float32 mode (layers23_f32), M = 2 x {M} (factored) / {M} "
              f"(mlp), hidden ({H}, {H}); bit 1 cuts the split of h in "
              f"registers, 'no mma' leaves the loads (both parts of each W "
              f"tile) and h2's staging:")
        cut_bits = {"kernel": 0, **CUTS}
        builds = [(f"TAIL_CUT={b}",) for b in cut_bits.values() if b]
        with ThreadPoolExecutor(len(builds)) as pool:   # nvcc in parallel
            list(pool.map(lambda d: _build.build_all(
                ("fused_factored", "mlp_infer"), d), builds))
        for n, b in cut_bits.items():
            d = (f"TAIL_CUT={b}",) if b else ()
            t_rows = _time_ms(lambda lib=ff_lib(d): rows_run(lib, arg32),
                              iters=5)
            t_mlp = _time_ms(lambda run=mlp_lib(d): mlp_run(run, m32),
                             iters=5)
            print(f"  {n}: factored_rows_tail {_fmt(*t_rows)}; "
                  f"mlp_infer_tail {_fmt(*t_mlp)}  [{card}]")
            summary[f"f32 {n}"] = {"factored_rows_tail": t_rows[0],
                                   "mlp_infer_tail": t_mlp[0]}
        _f32_ab(args.old, ff_lib, mlp_lib, rows_run, mlp_run, p32, pm32,
                h32, y32, y, arg32, m32, M, H, C, card, summary)
        del p32, pm32, h32, y32

    if args.old is not None:
        old_ff, old_mlp = ff_lib(src=args.old), mlp_lib(src=args.old)
        new_ff, new_mlp = ff_lib(), mlp_lib()
        # the resident tails' answers, bit for bit
        outs = []
        for lf, lm in ((old_ff, old_mlp), (new_ff, new_mlp)):
            for t in (out, y):
                t.zero_()
            ff_run(lf)
            mlp_run(lm)
            torch.cuda.synchronize()
            outs.append((out.clone(), y.clone()))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        print(f"old and new designs' answers (factored_tail, mlp_infer_tail "
              f"at H 1024): {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("the resident bf16 tails' answers changed")
        # factored_rows_tail at (1024, 1024) on the per-head rows: the old
        # fused tail against the new two-GEMM route, each in dB of the
        # plain version on 8192 rows a plane
        with full_f32_matmul():
            ref_r = _out_plain(prep, _hidden_plain(prep, 2, hr[:, :8192]), C)
        new_rows = lambda: factored_rows_tail(prep, hr, C)  # noqa: E731
        rows_run(old_ff, rows_args)
        torch.cuda.synchronize()
        e_old = _db(yr.view(2, M, C)[:, :8192], ref_r)
        e_new = _db(new_rows()[:, :8192], ref_r)
        print(f"factored_rows_tail (1024, 1024) vs its plain version: old "
              f"{e_old:.2f} dB, new {e_new:.2f} dB")
        print(f"A/B in turns (old, new, new, old), S={s} / M={M}:")
        ab = {"factored_tail": [], "mlp_infer_tail": [],
              "factored_rows_tail": []}
        for tag, lf, lm in (("old", old_ff, old_mlp), ("new", new_ff, new_mlp),
                            ("new", new_ff, new_mlp), ("old", old_ff, old_mlp)):
            t_ff = _time_ms(lambda: ff_run(lf))
            t_mlp = _time_ms(lambda: mlp_run(lm))
            t_rows = _time_ms(new_rows if tag == "new"
                              else lambda: rows_run(lf, rows_args))
            print(f"  {tag}: factored_tail {_fmt(*t_ff)}; mlp_infer_tail "
                  f"{_fmt(*t_mlp)}; factored_rows_tail {_fmt(*t_rows)}  "
                  f"[{card}]")
            ab["factored_tail"].append((tag, *t_ff))
            ab["mlp_infer_tail"].append((tag, *t_mlp))
            ab["factored_rows_tail"].append((tag, *t_rows))
        summary["ab"] = ab

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
