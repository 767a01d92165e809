#!/usr/bin/env python3
"""The two layer-1 GEMM kernels (csrc/gemm_sm90.cuh) across shapes, on
the card, each beside one ``torch.matmul`` of the same operands.

    python3 mamimo_tpu_torch/tools/probe_gemm.py [--f32] [--old DIR] [--mm]
        [--f32-split] [--dense]

``mlp_infer_layer1`` (bias, ReLU and affine epilogue, bf16 h1) at M =
8192, 32768 and 131072 rows with K = 10272 (the materialized input) and
10240 (a 64-multiple), H1 = 1024; ``factored_sig_proj`` (f32 output) at
S = 4096 and 16384, L = 10240, H = 1024. Seeded random operands, CUDA
events, kernel and matmul timed in turns (kernel, matmul, matmul,
kernel); prints each time, its TFLOP/s and the card's name and power
limit. The matmul writes bf16 and has no epilogue: it is a yardstick,
not the same function. The card's clocks sag over a run, so compare
only within one line.

``--f32``: the float32 body (gemm_sm90.cuh's gemm_tf32x3, 3xTF32 with
the weights' TF32 parts split beforehand) through its four callers:
``mlp_infer_layer1`` at M = 8192 and 131072 rows (K = 10272),
``factored_sig_proj`` at S = 4096, ``factored_dense``'s hidden layer on
(2, 131072, 1024) rows and ``matmul_pallas`` at (4096, 10240) @ (10240,
1024) and (131072, 1024) @ (1024, 1024) (the wrapper's per-call split
of B timed apart), each beside a float32 ``torch.matmul`` with TF32 off
and one with TF32 on (a single TF32 pass, cuBLAS: a third of the work,
the yardstick of the tensor cores' TF32 rate), TFLOP/s counting each
product once; then the body built with -DGEMM_CUT=1, 2, 3 (no split of
A in registers, no products, neither), ``mlp_infer_layer1`` at (131072,
10272) timed in each beside its error against float64 on 8192 rows.
Then the float32 kernels built with other stretches (copies of the
sources with ``gemm_sm90.cuh``'s ``TF_STRETCH``, the k-steps a fresh
accumulator sums, set to 2, 4 or 8: ``probe_tail.stretch_sources``) and,
with ``--old``, the earlier design's (its weights unsplit, split in
shared memory) beside the package's own: ``mlp_infer_layer1``,
``factored_sig_proj``, ``factored_dense``'s hidden layer and the output
layer of a one-hidden-layer model, ``matmul_pallas`` at both shapes,
each against float64, timed in turns (old, each stretch, then back).

``--f32`` also runs the float32 split section (``--f32-split`` runs it
alone, with ``--old`` the SASS comparison after): ``factored_sig_proj``'s
float32 mode at Nt 1024 (S = 128, L = 327680) and Nt 512 (S = 512, L =
163840), H = 1024, the wrapper's launch (the plan's ranges on
``gemm_tf32x3``'s split walk, the partials' sum) against float32 and
float64 x @ W1 and itself (two launches bit-identical), then timed in
turns beside the same launch built with ``-DGEMM_CUT=1, 2, 3`` (no split
of A, no products, loads only) and one float32 ``torch.bmm`` (TF32 off),
the bytes of x, both TF32 parts of W1 and the output over each time;
with ``--old DIR`` the earlier design's one-range launch first and last
(its answer against the same references), and at BS32's S = 4096 (one
range in both designs) the two held bit for bit and timed in turns.

``--dense`` (alone, with ``--old`` the SASS comparison after):
``factored_dense`` bf16 on (2, 131072, 1024) rows, the hidden layer of a
(1024 x 3) model (1024 units, bias, ReLU and affine, bf16 rows out) and
the output layer of a one-hidden-layer model (256 K-major rows of W, 234
columns stored, f32 and bf16 stores): each against its plain version,
then timed in turns beside one bf16 ``torch.bmm`` with its epilogue in
PyTorch and the hidden layer's builds with ``-DMM_CUT=1, 2, 3``; with
``--old DIR`` the earlier design's launch of the same function first and
last, its answers against the same plain versions and against the new
route's (bit for bit or not).

The split walk of ``factored_sig_proj`` (bf16; K cut into ranges where
its tile groups cannot fill the card, ``sig_proj_splits``): at Nt 1024
(S = 128, L = 327680) and Nt 512 (S = 512, L = 163840), H = 1024, the
wrapper's launch (the plan's ranges, the partials' sum) held to float32
x @ W1 and to itself (two launches bit-identical), timed beside one bf16
``torch.bmm``; with ``--old DIR`` also the earlier design's launch (one
range) at those shapes, its error, and the two timed in turns (old, new,
new, old).

``matmul_pallas`` in its bf16 mode (``csrc/matmul_bf16.cu`` on
``mm_sm90.cuh``'s gemm_coop) at (131072, 1024) @ (1024, 1024) and (4096,
10240) @ (10240, 1024): answers against float64 on the first 4096 rows
(B (K, N) as given and Bt, f32 and bf16 stores), then timed in turns
(each line's designs, then back) beside one ``torch.matmul`` (a bf16
result): the call ``matmul_pallas(a, b)`` (the launch on B as given),
the launch on Bt, builds with ``-DMM_CUT=1`` (no products), ``2`` (no
epilogue) and ``3`` (loads only), the bf16 store (STAGED) beside the
DIRECT one, and where K = N the same bytes moved by ``C.copy_(A)`` (A
bf16 in, f32 C out) and C's alone by ``C.fill_``; the rate of the f32
C's bytes over the cuts printed; with ``--old DIR`` the earlier
design's kernel on Bt and its call (Bt copied per call) first and last,
and the float32 mode (``csrc/matmul.cu``) of both designs. Then the one
wave of 128 tiles at K = 10240: the call beside its no-epilogue cut and
the same work on the layer-1 kernel's split walk at 1, 2 and 4 ranges
of K (two planes of 2048 rows), in turns. ``--old`` also compares the
SASS of every kernel of every library (``_build.SOURCES``) with DIR's,
kernel by kernel: identical, different, or in one design only. ``--mm``
runs this section alone (and the SASS comparison with ``--old``).

``--old DIR``: the bf16 kernels against an earlier design whose sources
(``fused_factored.cu``, ``mlp_infer.cu`` and their headers, e.g. a
``git archive`` of an earlier commit's ``mamimo_tpu_torch/csrc``) lie in
DIR, each launch function bound from its declaration in its own source
(an earlier design's has no mode argument): the two libraries' SASS of
each kernel and the answers compared, then timed in turns (old, new,
new, old, twice) at M = 131072, K = 10272 and S = 4096.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "mamimo_tpu_torch" / "csrc"
MLP_SHAPES = ((8192, 10272), (32768, 10272), (131072, 10272),
              (131072, 10240))
SIG_ROWS = (4096, 16384)
H = 1024


def _time_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _turns(kernel, matmul, iters):
    """(kernel ms, matmul ms), each the better of two turns."""
    k1, m1 = _time_ms(kernel, iters), _time_ms(matmul, iters)
    m2, k2 = _time_ms(matmul, iters), _time_ms(kernel, iters)
    return min(k1, k2), min(m1, m2)


def _sass(path: str, kernel: str) -> str:
    """The SASS of the kernels of the library at path whose mangled name
    holds `kernel` (cuobjdump), each line's whitespace collapsed (the
    dump pads its columns to the longest line of the whole library)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, cur = [], False
    for line in text.splitlines():
        if "Function :" in line:
            cur = kernel in line
        elif cur:
            out.append(" ".join(line.split()))
    return "\n".join(out)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f32", action="store_true",
                    help="also time the float32 mode")
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of an earlier design's csrc sources")
    ap.add_argument("--sass-only", action="store_true",
                    help="with --old: only compare every kernel's SASS")
    ap.add_argument("--mm", action="store_true",
                    help="only matmul_pallas bf16 (and with --old the "
                         "SASS comparison)")
    ap.add_argument("--f32-split", action="store_true",
                    help="only the float32 layer 1's split walk (and with "
                         "--old the SASS comparison)")
    ap.add_argument("--dense", action="store_true",
                    help="only factored_dense bf16 (and with --old the "
                         "SASS comparison)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gemm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.sass_only and args.old is not None:
        _sass_section(args.old)
        return 0
    from mamimo_tpu_torch.ops.kernels.fused_factored import factored_sig_proj
    from mamimo_tpu_torch.ops.kernels.mlp_infer import mlp_infer_layer1

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    m_max, k_max = max(m for m, _ in MLP_SHAPES), max(k for _, k in MLP_SHAPES)
    xbuf = torch.randn((m_max * k_max,), generator=g, device=dev).to(bf16)

    def layer1_tree(k, dtype):
        kp = -(-k // 32) * 32
        w1 = torch.zeros((kp, H), device=dev)
        w1[:k] = 0.02 * torch.randn((k, H), generator=g, device=dev)
        w1 = w1.to(dtype)
        return {"w1": w1, "w1t": w1.T.contiguous(),
                "b1": torch.zeros(H, device=dev),
                "s1": torch.ones(H, device=dev),
                "t1": torch.zeros(H, device=dev)}

    print(f"probe_gemm on {smi}")
    if args.mm or args.f32_split or args.dense:
        if args.f32_split:
            _f32_split_section(args, dev, g, smi)
        if args.dense:
            _dense_section(args, dev, g, smi)
        if args.mm:
            _mm_section(args, dev, g, smi)
        if args.old is not None:
            _sass_section(args.old)
        return 0
    for m, k in MLP_SHAPES:
        x = xbuf[:m * k].view(m, k)
        p = layer1_tree(k, bf16)
        iters = max(3, 20 * 8192 // m)
        ms, mm = _turns(lambda: mlp_infer_layer1(p, x),
                        lambda: torch.matmul(x, p["w1"][:k]), iters)
        tf = 2.0 * m * k * H / 1e9
        print(f"  mlp_infer_layer1 ({m}, {k}) @ ({k}, {H}): {ms:.4f} ms "
              f"({tf / ms:.0f} TFLOP/s); matmul {mm:.4f} ms "
              f"({tf / mm:.0f} TFLOP/s)  [{smi}]", flush=True)
    for s in SIG_ROWS:
        L = 10240
        x = xbuf[:2 * s * L].view(2, s, L)
        w = (0.02 * torch.randn((2, L, H), generator=g, device=dev)).to(bf16)
        wt = w.transpose(1, 2).contiguous()
        iters = max(3, 20 * 4096 // s)
        ms, mm = _turns(lambda: factored_sig_proj(x, w, wt),
                        lambda: torch.matmul(x, w), iters)
        tf = 2.0 * 2 * s * L * H / 1e9
        print(f"  factored_sig_proj (2, {s}, {L}) @ (2, {L}, {H}): "
              f"{ms:.4f} ms ({tf / ms:.0f} TFLOP/s); matmul {mm:.4f} ms "
              f"({tf / mm:.0f} TFLOP/s)  [{smi}]", flush=True)

    _split_section(args, dev, g, smi)
    _mm_section(args, dev, g, smi)
    if args.old is not None:
        _sass_section(args.old)

    if args.f32:
        _f32_section(args, dev, g, smi, layer1_tree)
        _f32_split_section(args, dev, g, smi)

    if args.old is not None:
        m, k, s, L = 131072, 10272, 4096, 10240
        x = xbuf[:m * k].view(m, k)
        p = layer1_tree(k, bf16)
        xs = xbuf[:2 * s * L].view(2, s, L)
        ws = (0.02 * torch.randn((2, L, H), generator=g, device=dev)).to(bf16)
        wst = ws.transpose(1, 2).contiguous()
        h1 = torch.empty((m, H), dtype=bf16, device=dev)
        sp = torch.empty((2, s, H), device=dev)
        a_mlp = [x.data_ptr(), p["w1t"].data_ptr(),
                 *(p[n].data_ptr() for n in ("b1", "s1", "t1")),
                 h1.data_ptr(), m, k, p["w1"].shape[0], H]
        a_sig = [xs.data_ptr(), wst.data_ptr(), sp.data_ptr(), s, L, H]
        from mamimo_tpu_torch.ops.kernels import _build
        from mamimo_tpu_torch.tools.probe_tail import _launch_fn, _old_lib

        runs, libs = {}, {}
        for tag, d in (("old", args.old), ("new", CSRC)):
            libs[tag] = {n: _build.library(n) if d == CSRC else _old_lib(d, n)
                         for n in ("mlp_infer", "fused_factored")}
            lm, lf = (_launch_fn(libs[tag][n], d, n, fn)
                      for n, fn in (("mlp_infer", "mlp_layer1_launch"),
                                    ("fused_factored",
                                     "factored_sig_proj_launch")))
            runs[tag] = (lambda lm=lm: lm(*a_mlp), lambda lf=lf: lf(*a_sig))
        for n, kern in (("mlp_infer", "mlp_layer1_kernel"),
                        ("fused_factored", "factored_sig_proj_kernel")):
            old_s, new_s = (_sass(libs[t][n]._name, kern)
                            for t in ("old", "new"))
            print(f"SASS of {kern}: {len(new_s.splitlines())} lines, "
                  f"{'identical' if old_s == new_s else 'DIFFERS'} in the "
                  f"two designs")
        outs = []
        for tag in ("old", "new"):
            h1.zero_()
            sp.zero_()
            for run in runs[tag]:
                run()
            torch.cuda.synchronize()
            outs.append((h1.clone(), sp.clone()))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        print(f"old and new designs' answers: "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("the bf16 layer-1 GEMMs' answers changed")
        print(f"A/B in turns (old, new, new, old): mlp_infer_layer1 ({m}, {k})"
              f", factored_sig_proj (2, {s}, {L}):")
        for tag in ("old", "new", "new", "old") * 2:
            t_m = _time_ms(runs[tag][0], 5)
            t_s = _time_ms(runs[tag][1], 20)
            print(f"  {tag}: mlp_infer_layer1 {t_m:.4f} ms; "
                  f"factored_sig_proj {t_s:.4f} ms  [{smi}]", flush=True)
    return 0


MM_SHAPES = ((131072, 1024, 1024), (4096, 10240, 1024))
# bytes into an SM a million multiply-adds: gemm_coop's 128 x 256 tile
# takes A 16 KB + B 32 KB a k-step of 64 (2M)
INTAKE_KB = 24.0


def _mm_section(args, dev, g, smi) -> None:
    """matmul_pallas bf16: the answers, the cuts, the other store, the
    bytes' rate, and (args.old) the earlier design, timed in turns beside
    torch.matmul; then the one wave at K = 10240 (_wave_section)."""
    import torch

    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.int8_mm import matmul_pallas
    from mamimo_tpu_torch.tools.probe_tail import _launch_fn, _old_lib

    bf16 = torch.bfloat16
    variants = {"no products": ("MM_CUT=1",), "no epilogue": ("MM_CUT=2",),
                "loads only": ("MM_CUT=3",)}
    with ThreadPoolExecutor(len(variants) + 1) as pool:      # nvcc at once
        list(pool.map(lambda d: _build.build_all(("matmul_bf16",), d),
                      list(variants.values()) + [()]))
    fns = {n: _launch_fn(_build.library("matmul_bf16", d), CSRC,
                         "matmul_bf16", "mm_bf16_launch")
           for n, d in {"new": (), **variants}.items()}
    if args.old is not None:
        fns["old"] = _launch_fn(_old_lib(args.old, "matmul"), args.old,
                                "matmul", "mm_float_launch")
    print(f"matmul_pallas bf16 (gemm_coop; {INTAKE_KB:.0f} KB into an SM a "
          f"million multiply-adds):")
    for m, k, n in MM_SHAPES:
        a = torch.randn((m, k), generator=g, device=dev).to(bf16)
        b = torch.randn((k, n), generator=g, device=dev).to(bf16)
        bt = b.T.contiguous()
        c = torch.empty((m, n), device=dev)
        cb = torch.empty((m, n), device=dev, dtype=bf16)
        ref = a[:4096].double() @ b.double()

        def launch(tag, bb, out, mode):
            return lambda: fns[tag](a.data_ptr(), bb.data_ptr(),
                                    out.data_ptr(), m, n, k, mode)

        errs = []
        for tag, bb, mode in (("new", b, 4), ("new", bt, 0), ("old", bt, 0)):
            if tag not in fns:
                continue
            c.fill_(float("nan"))
            launch(tag, bb, c, mode)()
            torch.cuda.synchronize()
            errs.append(f"{tag} mode {mode} {_db(c[:4096], ref):.2f}")
        got = matmul_pallas(a, b, out_dtype=bf16)
        same = torch.equal(got, matmul_pallas(a, b).to(bf16))
        print(f"  ({m}, {k}) @ ({k}, {n}) dB vs float64: " + "; ".join(errs)
              + f"; bf16 store {'=' if same else '!='} the f32 result "
              f"rounded", flush=True)
        runs = {"call matmul_pallas(a, b)": lambda: matmul_pallas(a, b),
                "B as Bt (K-major)": launch("new", bt, c, 0),
                "no products": launch("no products", b, c, 4),
                "no epilogue": launch("no epilogue", b, c, 4),
                "loads only": launch("loads only", b, c, 4),
                "torch.matmul (bf16 C)": lambda: torch.matmul(a, b),
                "bf16 C (STAGED)": lambda: matmul_pallas(a, b,
                                                         out_dtype=bf16),
                "bf16 C, DIRECT": launch("new", b, cb, 5)}
        if k == n:
            # the same bytes as the f32 C's GEMM (A read, C written) moved
            # by one PyTorch copy, and C's alone by a fill
            runs["C.copy_(A): A in, f32 C out"] = lambda: c.copy_(a)
            runs["C.fill_: f32 C out"] = lambda: c.fill_(1.0)
        if "old" in fns:
            runs = {"old kernel (Bt)": launch("old", bt, c, 0),
                    "old call (B.T copied)": lambda: fns["old"](
                        a.data_ptr(), b.T.contiguous().data_ptr(),
                        c.data_ptr(), m, n, k, 0),
                    "old bf16 C": launch("old", bt, cb, 1), **runs}
            # the float32 mode (untouched): the two designs on the same
            # split Bt, bit for bit, and in turns below
            from mamimo_tpu_torch.ops.kernels.util import tf32_split
            f32 = {t: _launch_fn(lib, d, "matmul", "mm_float_launch")
                   for t, lib, d in (("old", _old_lib(args.old, "matmul"),
                                      args.old),
                                     ("new", _build.library("matmul"), CSRC))}
            a32 = a.float()
            p32 = tf32_split(bt.float())
            c32 = [torch.empty((m, n), device=dev) for _ in range(2)]
            for tag, cc in zip(("old", "new"), c32):
                f32[tag](a32.data_ptr(), p32.data_ptr(), cc.data_ptr(), m, n,
                         k, 2)
            torch.cuda.synchronize()
            print(f"  float32 mode: old and new "
                  f"{'bit-identical' if torch.equal(*c32) else 'DIFFER'}")
            for tag, cc in zip(("old", "new"), c32):
                runs[f"float32 mode, {tag}"] = (
                    lambda f=f32[tag], cc=cc: f(a32.data_ptr(),
                                                p32.data_ptr(),
                                                cc.data_ptr(), m, n, k, 2))
        order = list(runs) + list(runs)[::-1]
        ts = {r: [] for r in runs}
        iters = 20 if m * n * k < 2 ** 36 else 10
        for r in order:
            ts[r].append(_time_ms(runs[r], iters))
        moved = (m * k + k * n) * 2 + m * n * 4
        for r, v in ts.items():
            print(f"    {r}: " + " / ".join(f"{x:.4f}" for x in v)
                  + f" ms  [{smi}]", flush=True)
        print(f"    the f32 C's GEMM moves {moved / 1e6:.1f} MB (A and B "
              f"read once, C written): {moved / min(ts['loads only']) / 1e9:.2f}"
              f" TB/s over 'loads only' (A and B alone), "
              f"{moved / min(ts['no products']) / 1e9:.2f} over 'no "
              f"products'", flush=True)
        del a, b, bt, c, cb
        torch.cuda.empty_cache()
    _wave_section(dev, g, smi)


def _wave_section(dev, g, smi) -> None:
    """(4096, 10240) @ (10240, 1024), 128 tiles of 128 x 256 for 132 SMs:
    one wave. matmul_pallas beside its no-epilogue cut, and the same
    work split across the card by the layer-1 kernel's split walk
    (``factored_sig_proj_launch``: two planes of 2048 rows, K cut into 1,
    2 or 4 ranges, the ranges' f32 partials summed in order), each
    against float64, timed in turns."""
    import torch

    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.int8_mm import matmul_pallas
    from mamimo_tpu_torch.tools.probe_tail import _launch_fn

    bf16 = torch.bfloat16
    m, k, n = 4096, 10240, 1024
    a = torch.randn((m, k), generator=g, device=dev).to(bf16)
    b = torch.randn((k, n), generator=g, device=dev).to(bf16)
    c = torch.empty((m, n), device=dev)
    cut = _launch_fn(_build.library("matmul_bf16", ("MM_CUT=2",)), CSRC,
                     "matmul_bf16", "mm_bf16_launch")
    sig = _launch_fn(_build.library("fused_factored"), CSRC, "fused_factored",
                     "factored_sig_proj_launch")
    # the same product as two planes of m / 2 rows, one weight a plane
    x2 = a.view(2, m // 2, k)
    w2t = b.T.contiguous().expand(2, n, k).contiguous()
    out = torch.empty((2, m // 2, n), device=dev)
    ws = torch.empty((4, 2, m // 2, n), device=dev)
    ref = a[:2048].double() @ b.double()
    runs = {"matmul_pallas(a, b)": lambda: matmul_pallas(a, b),
            "no epilogue": lambda: cut(a.data_ptr(), b.data_ptr(),
                                       c.data_ptr(), m, n, k, 4)}
    errs = [f"matmul_pallas {_db(matmul_pallas(a, b)[:2048], ref):.2f}"]
    for splits in (1, 2, 4):
        run = (lambda s=splits: sig(x2.data_ptr(), w2t.data_ptr(),
                                    out.data_ptr(), m // 2, k, n, 0,
                                    ws.data_ptr(), s))
        run()
        torch.cuda.synchronize()
        errs.append(f"{splits} range(s) {_db(out[0], ref):.2f}")
        runs[f"split walk, {splits} range(s)"] = run
    print(f"one wave at ({m}, {k}) @ ({k}, {n}): 128 tiles of 128 x 256 on "
          f"132 SMs; dB vs float64 (2048 rows): " + ", ".join(errs))
    ts = {r: [] for r in runs}
    for r in list(runs) + list(runs)[::-1]:
        ts[r].append(_time_ms(runs[r], 20))
    for r, v in ts.items():
        print(f"    {r}: " + " / ".join(f"{x:.4f}" for x in v)
              + f" ms  [{smi}]", flush=True)
    del a, b, c, x2, w2t, out, ws
    torch.cuda.empty_cache()


def _base(mangled: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    m = re.search(r"\(anonymous\)\d+(\w+?)(?:I|E|$)", mangled)
    return m.group(1) if m else mangled


def _sass_section(old) -> None:
    """Every kernel of every library against DIR's, by mangled name (a
    kernel the new design has under one name only, and the earlier under
    several template instantiations, against each of them); the first
    differing lines of any that differ."""
    import difflib

    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.tools.probe_ls import _sass_kernels
    from mamimo_tpu_torch.tools.probe_tail import _old_lib

    _build.build_all()
    names = [s for s in _build.SOURCES if (old / f"{s}.cu").exists()]
    with ThreadPoolExecutor(len(names)) as pool:             # nvcc at once
        olds = dict(zip(names, pool.map(lambda s: _old_lib(old, s), names)))
    print("SASS of every kernel against the earlier design's:")
    for s in names:
        a = _sass_kernels(olds[s]._name)
        b = _sass_kernels(str(_build._target(s)))
        same = sorted(k for k in a if b.get(k) == a[k])
        diff = sorted(k for k in a if k in b and b[k] != a[k])
        print(f"  {s}: {len(same)} identical, {len(diff)} different"
              + "".join(f"\n    only earlier: {k}" for k in sorted(a)
                        if k not in b)
              + "".join(f"\n    only new: {k}" for k in sorted(b)
                        if k not in a), flush=True)
        for k in (k for k in b if k not in a):
            twins = [o for o in a if o not in b and _base(o) == _base(k)]
            for o in twins:
                print(f"    new {k} against earlier {o}: "
                      f"{'identical' if a[o] == b[k] else 'different'}")
        for k in diff:
            lines = [d for d in difflib.unified_diff(
                a[k].splitlines(), b[k].splitlines(), lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
            print(f"    different: {k}, {len(lines)} lines, the first:"
                  + "".join(f"\n      {d}" for d in lines[:12]))


SPLIT_SHAPES = {"Nt 1024": (128, 327680), "Nt 512": (512, 163840)}


def _split_section(args, dev, g, smi) -> None:
    """factored_sig_proj's split walk at SPLIT_SHAPES: error against
    float32 x @ W1, two launches bit-identical, time beside a bf16 bmm;
    with args.old the earlier design's one-range launch too, in turns."""
    import torch

    from mamimo_tpu_torch.ops.kernels import fused_factored as ff
    from mamimo_tpu_torch.tools.probe_tail import _launch_fn, _old_lib

    old = None
    if args.old is not None:
        old = _launch_fn(_old_lib(args.old, "fused_factored"), args.old,
                         "fused_factored", "factored_sig_proj_launch")
    print("the split walk of factored_sig_proj (bf16):")
    for tag, (s, L) in SPLIT_SHAPES.items():
        x = torch.randn((2, s, L), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((2, L, H), generator=g, device=dev)
             / L ** 0.5).to(torch.bfloat16)
        wt = w.transpose(1, 2).contiguous()
        ref = torch.bmm(x.float(), w.float())
        a = ff.factored_sig_proj(x, w, wt)
        b = ff.factored_sig_proj(x, w, wt)
        splits = ff.sig_proj_splits(s, H, L, ff._sm_count(dev))
        new = lambda: ff.factored_sig_proj(x, w, wt)       # noqa: E731
        line = (f"  {tag} (2, {s}, {L}) @ (2, {L}, {H}): {splits} ranges, "
                f"{_db(a, ref):.2f} dB vs float32 x @ W1, two launches "
                f"{'bit-identical' if torch.equal(a, b) else 'DIFFER'}")
        if old is not None:
            sp = torch.empty((2, s, H), device=dev)
            o = lambda: old(x.data_ptr(), wt.data_ptr(),   # noqa: E731
                            sp.data_ptr(), s, L, H)
            o()
            torch.cuda.synchronize()
            line += f"; old (one range) {_db(sp, ref):.2f} dB"
        print(line, flush=True)
        if old is not None:
            ts = [(t, _time_ms(new if t == "new" else o, 10))
                  for t in ("old", "new", "new", "old")]
            print("  in turns: " + ", ".join(f"{t} {v:.4f}" for t, v in ts)
                  + f" ms  [{smi}]", flush=True)
        print(f"  new {_time_ms(new, 10):.4f} ms; bf16 bmm "
              f"{_time_ms(lambda: torch.bmm(x, w), 10):.4f} ms  [{smi}]",
              flush=True)
        del x, w, wt, ref, a, b
        torch.cuda.empty_cache()


F32_SPLIT_CUTS = {"no A split": "GEMM_CUT=1", "no products": "GEMM_CUT=2",
                  "loads only": "GEMM_CUT=3"}


def _f32_split_section(args, dev, g, smi) -> None:
    """factored_sig_proj's float32 mode split across the card at
    SPLIT_SHAPES: errors, two launches bit-identical, the cuts and (with
    args.old) the earlier one-range design, in turns; with args.old also
    BS32's S = 4096 in one range, bit for bit against the earlier
    design."""
    import torch

    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels import fused_factored as ff
    from mamimo_tpu_torch.ops.kernels.util import tf32_split
    from mamimo_tpu_torch.tools.probe_tail import _launch_fn, _old_lib

    with ThreadPoolExecutor(len(F32_SPLIT_CUTS)) as pool:    # nvcc at once
        list(pool.map(lambda d: _build.build_all(("fused_factored",), (d,)),
                      F32_SPLIT_CUTS.values()))
    fns = {n: _launch_fn(_build.library("fused_factored", (d,)), CSRC,
                         "fused_factored", "factored_sig_proj_launch")
           for n, d in F32_SPLIT_CUTS.items()}
    old = None
    if args.old is not None:
        old = _launch_fn(_old_lib(args.old, "fused_factored"), args.old,
                         "fused_factored", "factored_sig_proj_launch")
    sms = ff._sm_count(dev)
    print("the float32 layer 1 (factored_sig_proj, 3xTF32) split across the "
          "card:")
    for tag, (s, L) in SPLIT_SHAPES.items():
        x = torch.randn((2, s, L), generator=g, device=dev)
        w = torch.randn((2, L, H), generator=g, device=dev) / L ** 0.5
        wp = tf32_split(w.transpose(1, 2).contiguous(), 1)
        ref32 = torch.bmm(x, w)                      # TF32 off (main)
        ref64 = torch.bmm(x.double(), w.double())
        splits = ff.sig_proj_splits(s, H, L, sms, float32=True)
        a = ff.factored_sig_proj(x, w, wp)
        b = ff.factored_sig_proj(x, w, wp)
        out = torch.empty((2, s, H), device=dev)
        ws = torch.empty((max(splits, 1), 2, s, H), device=dev)
        errs = [f"new ({splits} ranges) {_db(a, ref32):.2f} / "
                f"{_db(a, ref64):.2f}"]
        runs = {"new": lambda: ff.factored_sig_proj(x, w, wp)}
        if old is not None:
            runs["old (one range)"] = lambda: old(
                x.data_ptr(), wp.data_ptr(), out.data_ptr(), s, L, H, 2)
            runs["old (one range)"]()
            torch.cuda.synchronize()
            errs.append(f"old {_db(out, ref32):.2f} / {_db(out, ref64):.2f}")
        for n, f in fns.items():
            runs[n] = (lambda f=f: f(x.data_ptr(), wp.data_ptr(),
                                     out.data_ptr(), s, L, H, 2,
                                     ws.data_ptr(), splits))
        runs["torch.bmm f32 (TF32 off)"] = lambda: torch.bmm(x, w)
        print(f"  {tag} (2, {s}, {L}) @ (2, {L}, {H}) f32: dB vs float32 / "
              f"float64 x @ W1: " + "; ".join(errs) + "; two launches "
              f"{'bit-identical' if torch.equal(a, b) else 'DIFFER'}",
              flush=True)
        order = list(runs)
        if old is not None:                  # old first and last
            order.remove("old (one range)")
            order = ["old (one range)"] + order
        ts = {r: [] for r in order}
        for r in order + order[::-1]:
            ts[r].append(_time_ms(runs[r], 5))
        moved = (x.numel() + wp.numel() + 2 * s * H) * 4
        ops = 2.0 * 2 * s * L * H
        for r, v in ts.items():
            print(f"    {r}: " + " / ".join(f"{t:.4f}" for t in v)
                  + f" ms; x, W1's two parts and the output "
                  f"{moved / min(v) / 1e9:.2f} TB/s; {ops / min(v) / 1e9:.0f}"
                  f" TFLOP/s counting each product once  [{smi}]",
                  flush=True)
        del x, w, wp, ref32, ref64, a, b, out, ws
        torch.cuda.empty_cache()
    if old is None:
        return
    # BS32's bench shape: one range in both designs, bit for bit
    s, L = 4096, 10240
    x = torch.randn((2, s, L), generator=g, device=dev)
    w = 0.02 * torch.randn((2, L, H), generator=g, device=dev)
    wp = tf32_split(w.transpose(1, 2).contiguous(), 1)
    out = torch.empty((2, s, H), device=dev)
    runs = {"old": lambda: old(x.data_ptr(), wp.data_ptr(), out.data_ptr(),
                               s, L, H, 2),
            "new": lambda: ff.factored_sig_proj(x, w, wp)}
    runs["old"]()
    torch.cuda.synchronize()
    same = torch.equal(out, runs["new"]())
    ts = [(t, _time_ms(runs[t], 10)) for t in ("old", "new", "new", "old")]
    print(f"  BS32 (2, {s}, {L}) @ (2, {L}, {H}) f32, "
          f"{ff.sig_proj_splits(s, H, L, sms, float32=True)} range: old and "
          f"new {'bit-identical' if same else 'DIFFER'}; in turns "
          + ", ".join(f"{t} {v:.4f}" for t, v in ts) + f" ms  [{smi}]",
          flush=True)
    if not same:
        raise AssertionError("the float32 layer 1 at S = 4096 changed")


DENSE_M = 131072                 # rows of a plane: S = 4096 at Nt 32
DENSE_CUTS = {"no products": "MM_CUT=1", "no epilogue": "MM_CUT=2",
              "loads only": "MM_CUT=3"}


def _dense_section(args, dev, g, smi) -> None:
    """factored_dense bf16: the hidden layer and the output layer, each
    against its plain version, timed in turns beside a bf16 bmm with its
    epilogue, the hidden layer's cuts and (args.old) the earlier design."""
    import torch

    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels import fused_factored as ff
    from mamimo_tpu_torch.tools.probe_tail import _launch_fn, _old_lib

    bf16 = torch.bfloat16
    with ThreadPoolExecutor(len(DENSE_CUTS)) as pool:        # nvcc at once
        list(pool.map(lambda d: _build.build_all(("fused_factored",), (d,)),
                      DENSE_CUTS.values()))
    cuts = {n: _launch_fn(_build.library("fused_factored", (d,)), CSRC,
                          "fused_factored", "factored_dense_launch")
            for n, d in DENSE_CUTS.items()}
    old = None
    if args.old is not None:
        old = _launch_fn(_old_lib(args.old, "fused_factored"), args.old,
                         "fused_factored", "factored_dense_launch")
    M, C, NO = DENSE_M, 234, 256
    h = torch.relu(torch.randn((2, M, H), generator=g, device=dev)).to(bf16)
    vec = lambda n, lo, hi: (lo + (hi - lo) * torch.rand(   # noqa: E731
        (2, 1, n), generator=g, device=dev))
    w = (torch.randn((2, H, H), generator=g, device=dev) / H ** 0.5).to(bf16)
    wo = torch.zeros((2, H, NO), device=dev)
    wo[..., :C] = torch.randn((2, H, C), generator=g, device=dev) / H ** 0.5
    wo = wo.to(bf16)
    # a (1024 x 3)-like tree for the hidden layer (k = 2 of depth 2) and a
    # (1024,) one for the output layer (k = 2 of depth 1)
    hid = {"w1": w, "a1": vec(H, 1, 1), "w2": w,
           "w2t": w.transpose(1, 2).contiguous(), "b2": vec(H, -0.1, 0.1),
           "a2": vec(H, 0.5, 1.5), "c2": vec(H, -0.1, 0.1)}
    out = {"w1": w, "a1": vec(H, 1, 1), "w2": wo,
           "w2t": wo.transpose(1, 2).contiguous(), "b2": vec(NO, -0.1, 0.1)}
    y_h = torch.empty((2, M, H), dtype=bf16, device=dev)
    y_o = {torch.float32: torch.empty((2, M, C), device=dev),
           bf16: torch.empty((2, M, C), dtype=bf16, device=dev)}
    a_hid = [h.data_ptr(), hid["w2t"].data_ptr(),
             *(hid[k].data_ptr() for k in ("b2", "a2", "c2")),
             y_h.data_ptr(), M, H, H, 0, H, 0, 0]

    def a_out(dt):
        return [h.data_ptr(), out["w2t"].data_ptr(),
                *(out["b2"].data_ptr(),) * 3, y_o[dt].data_ptr(), M, NO, H,
                C, NO, 1, int(dt == bf16)]

    ref_h = ff._hidden_plain(hid, 2, h[:, :8192]).to(bf16)
    ref_o = ff._out_plain(out, h[:, :8192], C)
    new_h = ff.factored_dense(hid, 2, h)
    new_o = ff.factored_dense(out, 2, h, C)
    same_o = torch.equal(ff.factored_dense(out, 2, h, C, bf16),
                         new_o.to(bf16))
    same = {True: "bit-identical", False: "differ"}
    line = (f"factored_dense bf16, rows (2, {M}, {H}), dB vs the plain "
            f"version on 8192 rows: hidden layer "
            f"{_db(new_h[:, :8192], ref_h):.2f}, output layer "
            f"{_db(new_o[:, :8192], ref_o):.2f} (bf16 store "
            f"{'=' if same_o else '!='} the f32 result rounded)")
    if old is not None:
        old(*a_hid)
        old(*a_out(torch.float32))
        torch.cuda.synchronize()
        y32 = y_o[torch.float32]
        line += (f"; old {_db(y_h[:, :8192], ref_h):.2f} / "
                 f"{_db(y32[:, :8192], ref_o):.2f}, old and new "
                 f"{same[torch.equal(y_h, new_h)]} / "
                 f"{same[torch.equal(y32, new_o)]}")
    print(line, flush=True)
    del new_h, new_o, ref_h, ref_o

    def lib_hidden():
        y = torch.relu(torch.bmm(h, w) + hid["b2"])
        return (y * hid["a2"] + hid["c2"]).to(bf16)

    groups = {
        "hidden layer (1024 x 3, layer 2)": (
            {"new": lambda: ff.factored_dense(hid, 2, h),
             **{n: (lambda f=f: f(*a_hid)) for n, f in cuts.items()},
             "bf16 bmm + epilogue": lib_hidden},
            lambda: old(*a_hid), 2.0 * 2 * M * H * H),
        "output layer (1024,), f32 store": (
            {"new": lambda: ff.factored_dense(out, 2, h, C),
             "bf16 bmm + bias": lambda: torch.bmm(h, wo)[..., :C]
             + out["b2"][..., :C]},
            lambda: old(*a_out(torch.float32)), 2.0 * 2 * M * H * C),
        "output layer (1024,), bf16 store": (
            {"new": lambda: ff.factored_dense(out, 2, h, C, bf16)},
            lambda: old(*a_out(bf16)), 2.0 * 2 * M * H * C)}
    for name, (runs, run_old, ops) in groups.items():
        order = list(runs)
        if old is not None:
            runs = {"old": run_old, **runs}
            order = ["old"] + order
        ts = {r: [] for r in order}
        for r in order + order[::-1]:
            ts[r].append(_time_ms(runs[r], 10))
        print(f"  {name}: bound {ops / 989e12 * 1e3:.4f} ms (ops at 989 "
              f"TFLOP/s bf16)", flush=True)
        for r, v in ts.items():
            print(f"    {r}: " + " / ".join(f"{t:.4f}" for t in v)
                  + f" ms  [{smi}]", flush=True)
    del h, w, wo, y_h, y_o, hid, out
    torch.cuda.empty_cache()


def _db(got, ref) -> float:
    import torch

    g64, r64 = got.double(), ref.double()
    return 10 * float(torch.log10((g64 - r64).square().sum()
                                  / r64.square().sum()))


def _f32_section(args, dev, g, smi, layer1_tree) -> None:
    """The float32 body: its callers' times beside torch.matmul with TF32
    off and on, the phase cuts, and the A/B of the other stretches (and
    with args.old the earlier design) against the package's own."""
    import torch

    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        factored_dense,
        factored_sig_proj,
    )
    from mamimo_tpu_torch.ops.kernels.int8_mm import matmul_float
    from mamimo_tpu_torch.ops.kernels.mlp_infer import mlp_infer_layer1
    from mamimo_tpu_torch.ops.kernels.util import tf32_split
    from mamimo_tpu_torch.tools.probe_tail import (
        _launch_fn,
        _old_lib,
        stretch_sources,
    )

    f32 = torch.float32

    def tf32_matmul(fn):
        def run():
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return run

    def line(name, tf, ms, mm, m1):
        print(f"  {name}: {ms:.4f} ms ({tf / ms:.0f} TFLOP/s); matmul f32 "
              f"{mm:.4f} ms ({tf / mm:.0f}); matmul TF32 one pass "
              f"{m1:.4f} ms ({tf / m1:.0f})  [{smi}]", flush=True)

    print("float32 mode (3xTF32; TFLOP/s counting each product once; "
          "matmul float32 with TF32 off, and with TF32 on):")
    for m, k in ((8192, 10272), (131072, 10272)):
        x = torch.randn((m, k), generator=g, device=dev)
        p = layer1_tree(k, f32)
        p["w1t_tf32"] = tf32_split(p["w1t"])
        iters = max(2, 10 * 8192 // m)
        ms, mm = _turns(lambda: mlp_infer_layer1(p, x),
                        lambda: torch.matmul(x, p["w1"][:k]), iters)
        m1 = _time_ms(tf32_matmul(lambda: torch.matmul(x, p["w1"][:k])),
                      iters)
        line(f"mlp_infer_layer1 f32 ({m}, {k}) @ ({k}, {H})",
             2.0 * m * k * H / 1e9, ms, mm, m1)
        del x, p
    s, L = 4096, 10240
    x = torch.randn((2, s, L), generator=g, device=dev)
    w = 0.02 * torch.randn((2, L, H), generator=g, device=dev)
    wp = tf32_split(w.transpose(1, 2).contiguous(), 1)
    ms, mm = _turns(lambda: factored_sig_proj(x, w, wp),
                    lambda: torch.matmul(x, w), 5)
    m1 = _time_ms(tf32_matmul(lambda: torch.matmul(x, w)), 5)
    line(f"factored_sig_proj f32 (2, {s}, {L}) @ (2, {L}, {H})",
         2.0 * 2 * s * L * H / 1e9, ms, mm, m1)
    del x, w, wp
    M = 131072
    h = torch.relu(torch.randn((2, M, H), generator=g, device=dev))
    w2 = 0.03 * torch.randn((2, H, H), generator=g, device=dev)
    z = torch.zeros((2, 1, H), device=dev)
    pd = {"w2": w2, "w2t_tf32": tf32_split(w2.transpose(1, 2).contiguous(),
                                            1),
          "b2": z, "a2": z + 1, "c2": z, "w1": w2, "a1": z, "w3": w2}
    ms, mm = _turns(lambda: factored_dense(pd, 2, h),
                    lambda: torch.matmul(h, w2), 3)
    m1 = _time_ms(tf32_matmul(lambda: torch.matmul(h, w2)), 3)
    line(f"factored_dense f32 hidden layer (2, {M}, {H}) @ (2, {H}, {H})",
         2.0 * 2 * M * H * H / 1e9, ms, mm, m1)
    del h, w2, pd
    for m, k, n in ((4096, 10240, 1024), (131072, 1024, 1024)):
        a = torch.randn((m, k), generator=g, device=dev)
        bt = torch.randn((n, k), generator=g, device=dev)
        ms, mm = _turns(lambda: matmul_float(a, bt),
                        lambda: torch.matmul(a, bt.T), 5)
        m1 = _time_ms(tf32_matmul(lambda: torch.matmul(a, bt.T)), 5)
        sp = _time_ms(lambda: tf32_split(bt), 20)
        line(f"matmul_pallas f32 ({m}, {k}) @ ({k}, {n}), B's split "
             f"{sp:.4f} ms of it", 2.0 * m * n * k / 1e9, ms, mm, m1)
        del a, bt

    # the phase cuts, on mlp_infer_layer1
    m, k = 131072, 10272
    x = torch.randn((m, k), generator=g, device=dev)
    p = layer1_tree(k, f32)
    wt = tf32_split(p["w1t"])
    kp = p["w1"].shape[0]
    h1 = torch.empty((m, H), device=dev)
    ref = torch.relu(x[:8192].double() @ p["w1"][:k].double())
    argv = [x.data_ptr(), wt.data_ptr(), *(p[n].data_ptr() for n in
                                           ("b1", "s1", "t1")),
            h1.data_ptr(), m, k, kp, H, 2]
    argc = list(argv)
    argc[6] = 8192
    print(f"phase cuts: mlp_infer_layer1 f32 ({m}, {k}) @ ({k}, {H}); error "
          f"on {argc[6]} rows against float64:")
    variants = [(), ("GEMM_CUT=1",), ("GEMM_CUT=2",), ("GEMM_CUT=3",)]
    with ThreadPoolExecutor(len(variants)) as pool:     # nvcc in parallel
        list(pool.map(lambda d: _build.build_all(("mlp_infer",), d),
                      variants))
    for d in variants:
        run = _launch_fn(_build.library("mlp_infer", d), CSRC, "mlp_infer",
                         "mlp_layer1_launch")
        run(*argc)
        torch.cuda.synchronize()
        err = _db(h1[:8192], ref)
        t = _time_ms(lambda run=run: run(*argv), 3)
        print(f"  {d[0] if d else 'kernel'}: {t:.4f} ms, {err:.2f} dB  "
              f"[{smi}]", flush=True)

    # the designs: the earlier one (weights unsplit), the other stretches,
    # the package's own; at the PERF.md shapes, each error on the first
    # 8192 rows
    own, dirs = stretch_sources("gemm")
    designs = {f"stretch {n}": d for n, d in dirs.items()}
    designs[f"stretch {own} (the package's)"] = CSRC
    if args.old is not None:
        designs = {"old": args.old, **designs}
    libs = ("mlp_infer", "fused_factored", "matmul")
    with ThreadPoolExecutor(len(designs) * len(libs)) as pool:
        list(pool.map(lambda a: _old_lib(*a), [
            (d, n) for d in designs.values() if d != CSRC for n in libs]))
    runs, outs = {}, {}
    ref_l = torch.relu(x[:8192].double() @ p["w1"][:k].double())
    # (name, library, function, old weight, new weight, args (None: the
    # weight), output rows to check, reference, iterations a timing)
    cases = [("mlp_infer_layer1", "mlp_infer", "mlp_layer1_launch",
              p["w1t"], wt, argv, lambda: h1[:8192], ref_l, 3)]
    sx = torch.randn((2, 4096, 10240), generator=g, device=dev)
    sw = 0.02 * torch.randn((2, H, 10240), generator=g, device=dev)
    sp = torch.empty((2, 4096, H), device=dev)
    cases.append(("factored_sig_proj", "fused_factored",
                  "factored_sig_proj_launch", sw, tf32_split(sw, 1),
                  [sx.data_ptr(), None, sp.data_ptr(), 4096, 10240, H, 2],
                  lambda: sp[:, :4096], sx.double()
                  @ sw.double().transpose(1, 2), 10))
    Md = 131072
    hd = torch.relu(torch.randn((2, Md, H), generator=g, device=dev))
    wd = 0.03 * torch.randn((2, H, H), generator=g, device=dev)
    zd, od = torch.zeros((2, H), device=dev), torch.ones((2, H), device=dev)
    yd = torch.empty((2, Md, H), device=dev)
    cases.append(("factored_dense", "fused_factored", "factored_dense_launch",
                  wd, tf32_split(wd, 1),
                  [hd.data_ptr(), None, zd.data_ptr(), od.data_ptr(),
                   zd.data_ptr(), yd.data_ptr(), Md, H, H, 0, H, 0, 2],
                  lambda: yd[:, :4096], torch.relu(
                      hd[:, :4096].double() @ wd.double().transpose(1, 2)),
                  3))
    # the output layer of a one-hidden-layer model: 256 K-major rows (the
    # 234 carriers, zero-padded), bias, 234 columns stored
    C, NO = 234, 256
    wo = torch.zeros((2, NO, H), device=dev)
    wo[:, :C] = 0.03 * torch.randn((2, C, H), generator=g, device=dev)
    bo = 0.1 * torch.randn((2, NO), generator=g, device=dev)
    yo = torch.empty((2, Md, C), device=dev)
    cases.append(("factored_dense output layer", "fused_factored",
                  "factored_dense_launch", wo, tf32_split(wo, 1),
                  [hd.data_ptr(), None, bo.data_ptr(), bo.data_ptr(),
                   bo.data_ptr(), yo.data_ptr(), Md, NO, H, C, NO, 1, 2],
                  lambda: yo[:, :4096],
                  hd[:, :4096].double() @ wo[:, :C].double().transpose(1, 2)
                  + bo[:, None, :C].double(), 3))
    keep = []                  # the operands the launches point at
    for mm, kk, nn in ((4096, 10240, 1024), (131072, 1024, 1024)):
        am = torch.randn((mm, kk), generator=g, device=dev)
        bm = torch.randn((nn, kk), generator=g, device=dev)
        cm = torch.empty((mm, nn), device=dev)
        keep.append(am)
        cases.append((f"matmul_pallas ({mm}, {kk}) @ ({kk}, {nn})", "matmul",
                      "mm_float_launch", bm, tf32_split(bm),
                      [am.data_ptr(), None, cm.data_ptr(), mm, nn, kk, 2],
                      lambda cm=cm: cm[:8192], am[:8192].double()
                      @ bm.double().T, 5))
    # an earlier design with csrc/tf32_split.cu reads the weights' parts
    unsplit = args.old is not None and not (args.old
                                            / "tf32_split.cu").exists()
    for name, lib, fn, w_old, w_new, argv_, got, ref, it in cases:
        for tag, d in designs.items():
            run = _launch_fn(_build.library(lib) if d == CSRC
                             else _old_lib(d, lib), d, lib, fn)
            av = list(argv_)
            av[1] = (w_old if tag == "old" and unsplit else w_new).data_ptr()
            runs[(name, tag)] = (lambda run=run, av=av: run(*av), it)
            run(*av)
            torch.cuda.synchronize()
            outs[(name, tag)] = _db(got(), ref)
        print(f"{name} f32 against float64: " + ", ".join(
            f"{tag} {outs[(name, tag)]:.2f} dB" for tag in designs),
            flush=True)
    order = [*designs, *reversed(designs)]
    print(f"float32 A/B in turns ({', '.join(order)}), each kernel's launch "
          f"alone (the weights split beforehand):")
    for name, *_ in cases:
        ts = [_time_ms(runs[(name, tag)][0], runs[(name, tag)][1])
              for tag in order]
        print(f"  {name}: " + ", ".join(f"{tag} {t:.4f}" for tag, t in
                                        zip(order, ts))
              + f" ms  [{smi}]", flush=True)

if __name__ == "__main__":
    sys.exit(main())
