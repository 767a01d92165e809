#!/usr/bin/env python3
"""The two layer-1 GEMM kernels (csrc/gemm_sm90.cuh) across shapes, on
the card, each beside one ``torch.matmul`` of the same operands.

    python3 mamimo_tpu_torch/tools/probe_gemm.py [--f32] [--old DIR]

``mlp_infer_layer1`` (bias, ReLU and affine epilogue, bf16 h1) at M =
8192, 32768 and 131072 rows with K = 10272 (the materialized input) and
10240 (a 64-multiple), H1 = 1024; ``factored_sig_proj`` (f32 output) at
S = 4096 and 16384, L = 10240, H = 1024. Seeded random operands, CUDA
events, kernel and matmul timed in turns (kernel, matmul, matmul,
kernel); prints each time, its TFLOP/s and the card's name and power
limit. The matmul writes bf16 and has no epilogue: it is a yardstick,
not the same function. The card's clocks sag over a run, so compare
only within one line.

``--f32``: the same kernels' float32 mode (float32 operands, 3xTF32 on
gemm_sm90.cuh's gemm_tf32x3, float32 h1) at M = 8192 and 131072 rows
(K = 10272) and S = 4096, beside a float32 ``torch.matmul`` with TF32
off, TFLOP/s counting each product once.

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
import subprocess
import sys
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gemm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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

    if args.f32:
        print("float32 mode (3xTF32; TFLOP/s counting each product once; "
              "matmul float32, TF32 off):")
        for m, k in ((8192, 10272), (131072, 10272)):
            x = torch.randn((m, k), generator=g, device=dev)
            p = layer1_tree(k, f32)
            iters = max(2, 10 * 8192 // m)
            ms, mm = _turns(lambda: mlp_infer_layer1(p, x),
                            lambda: torch.matmul(x, p["w1"][:k]), iters)
            tf = 2.0 * m * k * H / 1e9
            print(f"  mlp_infer_layer1 f32 ({m}, {k}) @ ({k}, {H}): "
                  f"{ms:.4f} ms ({tf / ms:.0f} TFLOP/s); matmul {mm:.4f} ms "
                  f"({tf / mm:.0f} TFLOP/s)  [{smi}]", flush=True)
            del x, p
        s, L = 4096, 10240
        x = torch.randn((2, s, L), generator=g, device=dev)
        w = 0.02 * torch.randn((2, L, H), generator=g, device=dev)
        wt = w.transpose(1, 2).contiguous()
        ms, mm = _turns(lambda: factored_sig_proj(x, w, wt),
                        lambda: torch.matmul(x, w), 5)
        tf = 2.0 * 2 * s * L * H / 1e9
        print(f"  factored_sig_proj f32 (2, {s}, {L}) @ (2, {L}, {H}): "
              f"{ms:.4f} ms ({tf / ms:.0f} TFLOP/s); matmul {mm:.4f} ms "
              f"({tf / mm:.0f} TFLOP/s)  [{smi}]", flush=True)
        del x, w, wt

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


if __name__ == "__main__":
    sys.exit(main())
