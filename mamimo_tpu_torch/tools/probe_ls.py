#!/usr/bin/env python3
"""Where the three LS kernels (csrc/ls_sm90.cuh) spend their time, on the
card.

    python3 mamimo_tpu_torch/tools/probe_ls.py [--old DIR]
        [--const NAME=VALUE ...] [--no-cuts] [--nt N] [--cp N]
        [--packets N]

At the bench shape (BS32: num_tx = 32, 234 carriers, S = 4096 rows of
10240 samples, 1024 packets of 4 rx), or at another num_tx, cp_length
and number of packets (``--nt``, ``--cp``, ``--packets``: e.g. ``--nt
512 --packets 128``, four 128-symbol parts a sample, or ``--cp 18``,
symbols off TMA's 16-byte grid, both on the general body
``ls_body<0>``), seeded random float32 planes and
their bf16 rounding, CUDA events, with the card's SM clock and power
draw sampled by ``nvidia-smi`` beside each timed window
(``tools/probe_tail.py``'s timer):

1. phase cuts: ``ls_planes_v2_kernel`` (full mode with the f32 store
   and with the bf16 store and per-tile sums, and seq rank 1 of 4),
   ``ls_planes_v1_kernel`` (raw f32 and raw bf16 planes) and
   ``ls_pair_kernel``, and the float32 modes of ``ls_planes_v2`` (full
   mode, and seq rank 1 of 4), ``ls_planes_v1`` (raw f32) and
   ``ls_pair_kernel`` (float32 planes, the constants' TF32 parts), built
   with ``-DLS_CUT=<bits>`` (each build hashed apart in ``_build/``): 1
   no products, 2 no despread, 4 no store, 8 no split (the float32
   mode's TF32 split of the input: its products then read the input as
   it landed, and a stale low part; where symbols are off the 16-byte
   grid, as at ``--cp 18``, also the shift of both modes), 32 no loads
   (the float32 mode's stages are marked full without a load); at
   aligned shapes bits 8 and 32 cut nothing of the bf16 mode. "loads
   only" (1, 2 and 4) keeps the split, "bare loads" (1, 2, 4 and 8) is
   the ring alone, "products only" (2, 4, 8 and 32) the float32
   products and their waits alone. The cut builds compute wrong
   answers by design and are never used outside this probe; the
   differences split each kernel's time by phase (skipped with
   ``--no-cuts``);
2. with ``--old DIR``: each kernel against an earlier design whose
   sources (``ls_v2.cu``, ``ls_v1.cu``, ``ls_pair.cu`` and their
   headers, e.g. a ``git archive`` of an earlier commit's
   ``mamimo_tpu_torch/csrc``) lie in DIR and keep the same C launch
   functions, timed in turns (old, new, new, old) in one process, after
   holding the two designs' answers to each other (NMSE within -45 dB
   for the bf16 modes and -90 dB for the float32 modes, and whether
   they are bit-identical). The float32 modes take part whenever the
   earlier sources have ``ls_body_f32``; designs without it have no
   float32 mode. The arguments each library's launch functions
   take are read from its sources. An earlier design's kernel takes the
   (2·fft, 2·Cp) constants of ``ls_kernel_constants`` where its source
   does not include ``ls_sm90.cuh`` (the mma.sync bodies before them).
   Also says whether the LS kernels' SASS (every kernel of ``ls_v2``,
   ``ls_v1`` and ``ls_pair``, both modes) is the same in both, and
   that of every kernel of the sources on the headers the LS body shares
   (``fused_factored``, ``mlp_infer``, ``matmul``, ``int8_mm``,
   ``tf32_split``), kernel by kernel: each kernel of the earlier design
   against the kernel of the same mangled name (kernels only the new
   sources have, such as the general body's, are listed apart; the
   instantiations whose SASS differs are named). The
   earlier design must take the probe's shape. At the bench shape it
   also serves one request of 1024 packets through
   ``CSIPredictor.estimate_full`` (BS32, hidden (1024, 1024), seeded
   random weights: kernel 1's float32 store, layer 1 and the fused
   tail) twice, on the package's libraries and with the earlier
   design's ``ls_v2`` and ``fused_factored`` in their place (the same C
   launch functions; the Python between the launches is the package's
   own), and says whether h_ls and h_dnn are bit-identical;
3. with ``--const NAME=VALUE`` (repeatable): a copy of the package's
   sources with ``constexpr int NAME`` of ``ls_sm90.cuh`` set to VALUE
   (a settled choice of the float32 body, such as ``F_STAGES``), held to
   the package's own as an earlier design is and its float32 modes
   timed in turns with it and with the earlier design (the copies, new,
   new, the copies backwards).

At 512 symbols a sample and more (``--nt 512``, ``--nt 1024``) the
package's kernels read the part transform's output (``csrc/ls_parts.cu``:
the Walsh-Hadamard transform over a sample's 128-symbol parts, then one
part a tile): each kernel's row is then the transform and the LS launch
on its output together, as the wrapper launches them; the rows
"ls_parts" (the transform alone, bf16 and float32 planes) and "<kernel>
body" (the LS launch alone on a transform made beforehand) split it, and
the phase cuts time the body alone. An earlier design without
``ls_parts.cu`` runs its kernels on the planes as they are (the earlier
general body: all parts a tile); the two designs' float32 modes are then
held within -85 dB of each other (that body's one accumulator over
nh·512 products read -90.87 dB against the plain version at Nt 1024).

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
    "no split": 8,
    "no loads": 32,
    "loads only": 1 | 2 | 4,
    "bare loads": 1 | 2 | 4 | 8,
    "products only": 2 | 4 | 8 | 32,
}
F32_AGREE_DB = -90.0      # two designs' float32 modes against each other
F32_PARTS_AGREE_DB = -85.0   # the same where one runs the part transform
BF16_AGREE_DB = -45.0
PACKETS = 1024
PARTS_MIN_LOC = 512       # symbols a sample from which the parts path runs


SOURCES = ("ls_v2", "ls_v1", "ls_pair")
SERVE_SOURCES = ("ls_v2", "fused_factored")  # estimate_full's at BS32
SERVE_PACKETS = 1024                          # its request: S = 4096
# the other sources on the headers the LS body shares (gemm_sm90.cuh,
# tail_sm90.cuh): the GEMM, tail, split and int8 kernels
SHARED = ("fused_factored", "mlp_infer", "matmul", "int8_mm", "tf32_split")


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


def _sass_kernels(path: str) -> dict:
    """The SASS of each kernel of the library at path (cuobjdump), by
    mangled name with its anonymous namespace's id (a hash of the
    source's path) taken out, each line's whitespace collapsed."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                         "(anonymous)", line.split("Function :")[1].strip())
            out[cur] = []
        elif cur is not None:
            out[cur].append(" ".join(line.split()))
    return {k: "\n".join(v) for k, v in out.items()}


def _same_sass(old_path: str, new_path: str, kernel: str = "") -> tuple:
    """(every kernel of the earlier library whose name holds `kernel` has
    the same SASS in the new one, the new library's kernels the earlier
    one lacks, the earlier library's kernels whose SASS differs)."""
    old, new = _sass_kernels(old_path), _sass_kernels(new_path)
    differ = sorted(k for k, v in old.items()
                    if kernel in k and new.get(k) != v)
    return (not differ,
            sorted(k for k in new if k not in old and kernel in k), differ)


def _serve_bits(old_dir: Path, dev) -> dict:
    """{"h_ls": ..., "h_dnn": ...}: whether BS32 ``estimate_full`` of one
    seeded request answers bit for bit the same on the package's
    libraries and on the earlier design's SERVE_SOURCES (in
    ``_build``'s table of loaded libraries for the second call)."""
    import tempfile

    import numpy as np
    import torch

    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked
    from mamimo_tpu_torch.models.predictor import CSIPredictor
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.tools.probe_tail import _old_lib
    from mamimo_tpu_torch.train.ckpt import save_checkpoint

    cfg, tcfg = SimConfig(), TrainConfig()
    params, bn = init_stacked(torch.Generator().manual_seed(11), cfg, tcfg)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(str(Path(tmp) / "best"), cfg, tcfg, params, bn)
        pred = CSIPredictor(tmp, device=dev)
    req = np.random.default_rng(12).standard_normal(
        (2, SERVE_PACKETS * cfg.num_rx, cfg.len_ltf)).astype(np.float32)
    new = [torch.as_tensor(a) for a in pred.estimate_full(req)]
    own = {n: _build.library(n) for n in SERVE_SOURCES}
    try:
        for n in SERVE_SOURCES:
            _build._libs[(n, ())] = _old_lib(old_dir, n)
        old = [torch.as_tensor(a) for a in pred.estimate_full(req)]
    finally:
        _build._libs.update({(n, ()): lib for n, lib in own.items()})
    return {k: bool(torch.equal(a, b))
            for k, a, b in zip(("h_ls", "h_dnn"), new, old)}


def _has_parts(src_dir: Path) -> bool:
    """Whether the design in src_dir runs the part transform (its LS
    kernels then read the transform's output at PARTS_MIN_LOC symbols a
    sample and more)."""
    return (src_dir / "ls_parts.cu").exists()


def _has_f32(src_dir: Path) -> bool:
    """Whether the LS sources in src_dir have the float32 mode."""
    return "ls_body_f32" in (src_dir / "ls_sm90.cuh").read_text()


def _hopper(src_dir: Path, name: str) -> bool:
    """Whether csrc/<name>.cu in src_dir runs on ls_sm90.cuh (and so takes
    the permuted constants of ls_sm90_constants)."""
    return '#include "ls_sm90.cuh"' in (src_dir / f"{name}.cu").read_text()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--const", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="also a copy of the sources with constexpr int "
                         "NAME of ls_sm90.cuh set to VALUE (repeatable)")
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of an earlier design's csrc sources")
    ap.add_argument("--no-cuts", action="store_true",
                    help="skip the phase cuts (the A/B alone)")
    ap.add_argument("--nt", type=int, default=32, help="num_tx")
    ap.add_argument("--cp", type=int, default=64, help="cp_length")
    ap.add_argument("--packets", type=int, default=PACKETS,
                    help="packets of 4 rx (S = 4 packets)")
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
    from mamimo_tpu_torch.tools.probe_tail import (
        _fmt,
        _old_lib,
        _time_ms,
        const_copy,
    )

    HBM_BYTES_PER_S = 3.35e12                 # H100 SXM

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    _build.build_all(SOURCES + ("ls_parts",))
    for name in SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            print(f"  {name}: {line}")

    cfg = SimConfig(num_tx=args.nt, cp_length=args.cp)
    nt, nr, C = cfg.num_tx, cfg.num_rx, cfg.num_carriers
    S, L = args.packets * nr, cfg.len_ltf
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn((2, S, L), generator=g, device=dev)
    x = x32.to(torch.bfloat16)
    lq = L // 4
    xq = x[:, :, lq:2 * lq].contiguous()       # seq rank 1 of 4
    x32q = x32[:, :, lq:2 * lq].contiguous()
    kc_old = ls_kernel_constants(cfg, dev)
    kc_new = ls_sm90_constants(cfg, dev).bt
    kc_f32 = ls_sm90_constants(cfg, dev, torch.float32).bt
    cpad = kc_old.shape[1] // 2
    out = torch.empty((2, S, nt, C), device=dev)
    out16 = torch.empty((2, S, nt, C), dtype=torch.bfloat16, device=dev)
    ssq = torch.empty((-(-S * nt // 128), 2, C), device=dev)  # tiles
    out_p = torch.empty((args.packets, C, nt, nr), dtype=torch.complex64,
                        device=dev)
    raw = {dt: torch.empty((2, S * nt, cpad), dtype=dt, device=dev)
           for dt in (torch.float32, torch.bfloat16)}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    geo = (C, cfg.sym_len, cfg.cp_length, cfg.fft_length, cpad)
    fft = cfg.fft_length
    # the part transform's output (full mode; a seq rank of 4 holds fewer
    # than PARTS_MIN_LOC symbols at the widths probed) and its geometry
    parts_shape = nt >= PARTS_MIN_LOC
    z = {f: torch.empty((2, S, nt * fft), dtype=xa.dtype, device=dev)
         for f, xa in ((False, x), (True, x32))} if parts_shape else {}
    zgeo = (C, fft, 0, fft, cpad)
    parts_lib = None

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def transform(f32):
        """The part transform of the bf16 (or float32) planes into z."""
        return lambda: check(parts_lib.ls_parts_launch(
            (x32 if f32 else x).data_ptr(), z[f32].data_ptr(), S, nt,
            cfg.sym_len, cfg.cp_length, fft, int(f32), stream()),
            "ls_parts_launch")

    def both(libs, consts, f32=False, parts=False, body=False):
        """The five timed launches of the bf16 modes on built (ls_v2,
        ls_v1, ls_pair) libraries, each with its output; consts[name]: the
        constants each library takes. With f32 also the float32 modes of
        ls_planes_v2 (full, seq rank 1 of 4), ls_planes_v1 (raw f32) and
        ls_pair_kernel. With parts (a design with the part transform, at
        PARTS_MIN_LOC symbols a sample) the full-mode launches read z in
        the ``parts`` mode, each after the transform into z, or with body
        without it (z made beforehand)."""
        v2, l1, pr = libs
        flag = (0,) if pr.pair_flag else ()

        def inp(f32m):
            """(planes, geometry, the kernel's parts bit) of a full-mode
            launch, and the transform to run before it (or None)."""
            if parts:
                return (z[f32m], zgeo, 1,
                        None if body else transform(f32m))
            return x32 if f32m else x, geo, 0, None

        def full(launch, f32m, what):
            xa, g_, pb, pre = inp(f32m)

            def fn():
                if pre is not None:
                    pre()
                check(launch(xa, g_, pb), what)
            return fn

        def v1(consts_, dt, f32m=False):
            h = raw[dt]
            return full(lambda xa, g_, pb: l1.ls_planes_v1_launch(
                xa.data_ptr(), consts_.data_ptr(), h[0].data_ptr(),
                h[1].data_ptr(), S, S, nt, *g_[1:],
                int(dt == torch.bfloat16) + 2 * f32m + 4 * pb, stream()),
                f32m, "ls_planes_v1_launch")

        fns = {
            # f32 store without sums: mode 0, no ssq buffer
            "ls_planes_v2": (full(lambda xa, g_, pb: v2.ls_planes_v2_launch(
                xa.data_ptr(), consts["ls_v2"].data_ptr(), out.data_ptr(),
                None, S, nt, nt, 0, *g_, 8 * pb, stream()), False,
                "ls_planes_v2_launch"), out),
            # bf16 store with the per-tile sums: mode 3
            "ls_planes_v2 bf16 + ssq": (full(
                lambda xa, g_, pb: v2.ls_planes_v2_launch(
                    xa.data_ptr(), consts["ls_v2"].data_ptr(),
                    out16.data_ptr(), ssq.data_ptr(), S, nt, nt, 0, *g_,
                    3 + 8 * pb, stream()), False,
                "ls_planes_v2_launch (bf16 + ssq)"), out16),
            "ls_planes_v2 seq 1/4": (lambda: check(v2.ls_planes_v2_launch(
                xq.data_ptr(), consts["ls_v2"].data_ptr(), out.data_ptr(),
                None, S, nt, nt // 4, 1, *geo, 0, stream()),
                "ls_planes_v2_launch (seq)"), out),
            "ls_planes_v1 raw f32": (v1(consts["ls_v1"], torch.float32),
                                     raw[torch.float32]),
            "ls_planes_v1 raw bf16": (v1(consts["ls_v1"], torch.bfloat16),
                                      raw[torch.bfloat16]),
            "ls_pair_kernel": (full(lambda xa, g_, pb: pr.ls_pair_launch(
                xa.data_ptr(), consts["ls_pair"].data_ptr(),
                out_p.data_ptr(), S, nr, nt, *g_,
                *((2 * pb,) if flag else ()), stream()), False,
                "ls_pair_launch"), torch.view_as_real(out_p))}
        if f32:
            fns["ls_planes_v2 float32"] = (full(
                lambda xa, g_, pb: v2.ls_planes_v2_launch(
                    xa.data_ptr(), kc_f32.data_ptr(), out.data_ptr(), None,
                    S, nt, nt, 0, *g_, 4 | 8 * pb, stream()), True,
                "ls_planes_v2_launch (float32)"), out)
            fns["ls_planes_v2 float32 seq 1/4"] = (lambda: check(
                v2.ls_planes_v2_launch(
                    x32q.data_ptr(), kc_f32.data_ptr(), out.data_ptr(), None,
                    S, nt, nt // 4, 1, *geo, 4, stream()),
                "ls_planes_v2_launch (float32, seq)"), out)
            fns["ls_planes_v1 float32"] = (
                v1(kc_f32, torch.float32, f32m=True), raw[torch.float32])
            fns["ls_pair_kernel float32"] = (full(
                lambda xa, g_, pb: pr.ls_pair_launch(
                    xa.data_ptr(), kc_f32.data_ptr(), out_p.data_ptr(), S,
                    nr, nt, *g_, 1 | 2 * pb, stream()), True,
                "ls_pair_launch (float32)"), torch.view_as_real(out_p))
        return fns

    csrc = ROOT / "mamimo_tpu_torch" / "csrc"

    def new_libs(defines=()):
        return tuple(_bind(_build.library(n, defines), csrc, n)
                     for n in SOURCES)

    k_new = dict.fromkeys(SOURCES, kc_new)

    summary = {"card": card, "S": S, "num_tx": nt, "cp_length": cfg.cp_length}
    if parts_shape:
        # the transform alone, then the body alone on its output
        from mamimo_tpu_torch.ops.kernels.fused_ls import _ls_parts_lib

        parts_lib = _ls_parts_lib()
        nb = 2 * S * nt * fft * (2 + 2)           # bf16 read and written
        pre = {}
        for f32 in (False, True):
            transform(f32)()
            ms, clk, pwr = _time_ms(transform(f32))
            bound = nb * (2 if f32 else 1) / HBM_BYTES_PER_S * 1e3
            pre["float32" if f32 else "bf16"] = {"ms": ms, "bound_ms": bound}
            print(f"  ls_parts {'float32' if f32 else 'bf16'}: "
                  f"{_fmt(ms, clk, pwr)}; bound {bound:.4f} ms (bytes), "
                  f"{bound / ms * 100:.1f}%  [{card}]")
        body = {}
        for kname, (fn, _) in both(new_libs(), k_new, True, True,
                                   True).items():
            if "seq" in kname:
                continue
            ms, clk, pwr = _time_ms(fn)
            body[kname] = ms
            print(f"  {kname} body: {_fmt(ms, clk, pwr)}  [{card}]")
        summary["parts"] = {"transform": pre, "body": body}
    if not args.no_cuts:
        print(f"phase cuts, S = {S}" + (" (the body alone)" if parts_shape
                                        else "") + ":")
        variants = {"kernel": ()}
        variants.update({n: (f"LS_CUT={b}",) for n, b in CUTS.items()})
        with ThreadPoolExecutor(len(variants)) as pool:   # one nvcc each
            list(pool.map(lambda d: _build.build_all(SOURCES, d),
                          variants.values()))
        cut = {}
        for vname, defines in variants.items():
            fns = both(new_libs(defines), k_new, True, parts_shape,
                       parts_shape)
            for kname, (fn, _) in fns.items():
                ms, clk, pwr = _time_ms(fn)
                print(f"  {kname} {vname}: {_fmt(ms, clk, pwr)}  [{card}]")
                cut.setdefault(kname, {})[vname] = ms
        for kname, t in cut.items():
            k = t["kernel"]
            split = {"products": k - t["no products"],
                     "despread": k - t["no despread"],
                     "store": k - t["no store"], "split": k - t["no split"],
                     "loads": k - t["no loads"],
                     "products only": t["products only"],
                     "loads only": t["loads only"],
                     "bare loads": t["bare loads"]}
            print(f"  {kname} split: " + ", ".join(
                f"{n} {v:.4f} ms" for n, v in split.items()) + f" of {k:.4f}")
            cut[kname]["split"] = split
        summary["cuts"] = cut

    # the designs held to the package's own and timed in turns with it
    designs = {}
    if args.old is not None:
        designs["old"] = args.old
    for spec in args.const:
        name, value = spec.split("=")
        designs[spec] = const_copy("ls_sm90.cuh", name, int(value))
    if designs:
        with ThreadPoolExecutor(len(SOURCES) * len(designs)) as pool:
            libs = dict(zip(designs, [tuple(pool.map(
                lambda n, d=d: _bind(_old_lib(d, n), d, n), SOURCES))
                for d in designs.values()]))
        f32 = all(_has_f32(d) for d in designs.values())
        if parts_shape and parts_lib is None:
            from mamimo_tpu_torch.ops.kernels.fused_ls import _ls_parts_lib

            parts_lib = _ls_parts_lib()
        fns = {"new": both(new_libs(), k_new, f32, parts_shape)}
        for tag, d in list(designs.items()):
            fns[tag] = both(libs[tag], {n: kc_new if _hopper(d, n) else kc_old
                                        for n in SOURCES}, f32,
                            parts_shape and _has_parts(d))
            try:            # an earlier design may refuse the probe's shape
                next(iter(fns[tag].values()))[0]()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"  {tag}: refuses num_tx {nt}, cp_length "
                      f"{cfg.cp_length} ({e}); not compared")
                del designs[tag], fns[tag]
        same, sass = {}, {}
        for tag in designs:
            for kname in fns["new"]:
                got = {}
                for t in (tag, "new"):
                    fn, res = fns[t][kname]
                    fn()
                    torch.cuda.synchronize()
                    got[t] = res.float().clone()
                err = float(torch.sum((got["new"] - got[tag]) ** 2)
                            / torch.sum(got[tag] ** 2))
                db = 10 * torch.log10(torch.tensor(max(err, 1e-30))).item()
                same[f"{tag}: {kname}"] = bool(torch.equal(got["new"],
                                                           got[tag]))
                print(f"  {kname}: new vs {tag} NMSE {db:.2f} dB, "
                      + ("bit-identical" if same[f"{tag}: {kname}"]
                         else "not identical"))
                limit = BF16_AGREE_DB if "float32" not in kname else (
                    F32_PARTS_AGREE_DB if parts_shape
                    and not _has_parts(designs[tag]) else F32_AGREE_DB)
                if not db <= limit:
                    raise AssertionError(f"{kname}: new and {tag} disagree "
                                         f"({db:.2f} dB)")
            # the LS kernels' machine code, design against design: every
            # kernel of each library (bf16 and float32 modes, every
            # instantiation), those that differ named
            for name, lo, ln in zip(SOURCES, libs[tag], new_libs()):
                ok, extra, differ = _same_sass(lo._name, ln._name)
                sass[f"{tag}: {name}.cu"] = ok
                print(f"  SASS of every kernel of {name}.cu: "
                      f"{'identical' if ok else 'DIFFERS'} in new and {tag}"
                      + (f" (new only: {len(extra)} kernels)" if extra
                         else ""))
                for k in differ:        # the instantiations that changed
                    print(f"    differs: {k}")
                sass[f"{tag}: {name}.cu differs"] = differ
        if args.old is not None:
            # every kernel of the sources that share the LS body's headers
            _build.build_all(SHARED)
            with ThreadPoolExecutor(len(SHARED)) as pool:
                olds = list(pool.map(lambda n: _old_lib(args.old, n),
                                     SHARED))
            for n, lo in zip(SHARED, olds):
                ok, _, differ = _same_sass(lo._name,
                                           _build.library(n)._name)
                sass[f"old: {n}.cu"] = ok
                print(f"  SASS of every kernel of {n}.cu: "
                      f"{'identical' if ok else 'DIFFERS'} in new and old")
                for k in differ:
                    print(f"    differs: {k}")
            if (nt, cfg.cp_length) == (32, 64):
                serve = _serve_bits(args.old, dev)
                summary["estimate_full_identical"] = serve
                print(f"  estimate_full (BS32, {SERVE_PACKETS} packets) on "
                      f"new and old {'+'.join(SERVE_SOURCES)}: " + ", ".join(
                          f"{k} {'bit-identical' if v else 'DIFFERS'}"
                          for k, v in serve.items()))
        summary["identical"] = same
        summary["sass_identical"] = sass
        # in turns: the others, new, new, the others backwards (old, new,
        # new, old with --old alone); with --const only the float32 modes
        order = [*designs, "new", "new", *reversed(designs)]
        print(f"A/B in turns ({', '.join(order)}), S = {S}:")
        ab = {}
        for tag in order:
            for kname, (fn, _) in fns[tag].items():
                if args.old is None and "float32" not in kname:
                    continue
                ms, clk, pwr = _time_ms(fn)
                print(f"  {tag} {kname}: {_fmt(ms, clk, pwr)}  [{card}]")
                ab.setdefault(kname, []).append((tag, ms, clk, pwr))
        summary["ab"] = ab

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
