#!/usr/bin/env python3
"""Kernel 7 (the fused halo exchange) against an earlier design, in
turns, on one card.

    python3 mamimo_tpu_torch/tools/probe_halo.py [--old DIR]

At the shape of ``chip_smoke.py`` phase 5e: the padded BS32 preamble
(11200 × 32 complex64) over 4 virtual ranks of cuda:0 (chunk 2800), the
512 taps of a seeded scattering realization (halo 511). For each design
and form, first the operators' own host time per call (a CPU
``torch.profiler`` trace), then one window: the host time per call (the
median of 5 batches of back-to-back calls, the card synchronized around
each batch), then a ``torch.profiler``
trace of the same calls for the device time of the halo kernels and the
device-busy time of every kernel, with the card's SM clock and power
draw sampled by ``nvidia-smi`` beside it (``tools/probe_tail.py``'s
sampler). Forms:

* ``exchange``: ``halo_exchange_pallas`` on (2, chunk, 32) f32 planes;
* ``complex exchange``: the complex form the convolution calls
  (new design only);
* ``conv``: ``sharded_apply_channel_rdma`` (FFT convolution included);
* ``plain-exchange conv``: ``parallel/halo.py::sharded_apply_channel``,
  the same convolution with the plain exchange (no kernel; timed with
  the new design, which it does not depend on).

With ``--old DIR`` (an earlier commit's ``mamimo_tpu_torch/csrc``, e.g.
``git archive HEAD mamimo_tpu_torch/csrc | tar -x -C
.chip_tree/parent_csrc --strip-components=2``) the earlier design runs
too: ``DIR/halo.cu`` built under another name in ``_build/`` and driven
by a copy of its wrapper's per-rank launch loop (one launch per rank,
its stream bookkeeping included) and its convolution's planes round
trip; its blocks and convolution are held to the new design's bit for
bit, then the two are timed in turns (old, new, new, old) in one
process.

``trace_device`` is shared with ``tools/halo_cards.py``. Prints one line
per window, and a JSON summary as the last line. Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ITERS = 50


def trace_device(fn, calls: int = 10, match: str = "halo") -> dict:
    """Device time per call of fn() from a torch.profiler trace of
    `calls` back-to-back calls, by card: {card index: {"busy_ms": every
    device event, "match_ms": events whose name holds `match`}}, and
    under "overlap" the share of the matched events' summed time during
    which another matched event ran too (0: the cards never ran them at
    once). Raises when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    cards, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        c = cards.setdefault(e.device_index,
                             {"busy_ms": 0.0, "match_ms": 0.0})
        c["busy_ms"] += us / 1e3 / calls
        if match in e.name:
            c["match_ms"] += us / 1e3 / calls
            spans.append((e.time_range.start, e.time_range.end))
    if not cards:
        raise RuntimeError("the profiler's trace holds no device time")
    total = sum(b - a for a, b in spans)
    union, end = 0, None
    for a, b in sorted(spans):
        if end is None or a >= end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return {"cards": cards,
            "overlap": (1 - union / total) if total > 0 else 0.0}


def host_ops(fn, calls: int = 10, top: int = 8) -> dict:
    """Where the host time of fn() goes, from a torch.profiler trace of
    `calls` back-to-back calls: the operators' own host time per call
    (ms) in all, and the `top` operators as [(name, ms, count per
    call)]. (The profiler's own cost inflates both.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"total_ms": sum(e.self_cpu_time_total for e in ops) / 1e3 / calls,
            "top": [(e.key, e.self_cpu_time_total / 1e3 / calls,
                     e.count / calls) for e in ops[:top]]}


def host_ms(fn, devs, iters: int = ITERS, batches: int = 5) -> float:
    """Host time of fn() in ms per call: the median over `batches`
    batches of back-to-back calls (every card in ``devs`` synchronized
    before and after each batch) of the batch's mean. The host is shared,
    so a single batch can catch a stall."""
    import torch

    def sync():
        for d in dict.fromkeys(devs):
            torch.cuda.synchronize(d)

    for _ in range(3):
        fn()
    per = []
    n = max(1, iters // batches)
    for _ in range(batches):
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        per.append((time.perf_counter() - t0) / n * 1e3)
    return statistics.median(per)


def window(fn, devs) -> dict:
    """host_ms and trace_device of fn, with the SM clock (MHz) and power
    draw (W) of the first card sampled every 20 ms over both (medians)."""
    from mamimo_tpu_torch.tools.probe_tail import SMI

    smi = subprocess.Popen([*SMI, "-lms", "20"], stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, text=True)
    try:
        first = smi.stdout.readline()
        host = host_ms(fn, devs)
        tr = trace_device(fn)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    n_cards = len(dict.fromkeys(devs))
    samples = [[float(v) for v in line.split(",")]
               for line in [first, *out.splitlines()][::n_cards]
               if line.count(",") == 1]
    busy = sum(c["busy_ms"] for c in tr["cards"].values())
    halo = sum(c["match_ms"] for c in tr["cards"].values())
    return {"host_ms": host, "halo_kernel_ms": halo, "busy_ms": busy,
            "sm_mhz": statistics.median(s[0] for s in samples)
            if samples else None,
            "power_w": statistics.median(s[1] for s in samples)
            if samples else None}


def old_design(lib):
    """The earlier design's wrapper (its checks, then one launch per
    rank, each in its device's context on that device's current stream;
    the streams wait on each other only between ranks on different
    streams, none on one card) and its convolution's planes round trip,
    on the library ``lib`` built from an earlier ``halo.cu``."""
    import torch

    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.parallel.halo import overlap_save, seq_chunks
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    fn = lib.halo_exchange_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]

    def exchange(mesh, planes, halo):
        devs = mesh.axis_devices("seq")
        if len(planes) != len(devs):
            raise ValueError(f"{len(planes)} planes for {len(devs)} ranks")
        shape = tuple(planes[0].shape)
        for r, (x, dev) in enumerate(zip(planes, devs)):
            if x.dim() != 3 or x.shape[0] != 2 or tuple(x.shape) != shape \
                    or x.dtype != torch.float32 or x.device != dev:
                raise ValueError(f"rank {r}: bad planes")
        if not 0 <= halo < shape[1]:
            raise ValueError(f"chunk {shape[1]} must exceed the halo {halo}")
        planes = [x.contiguous() for x in planes]
        _, chunk, nt = planes[0].shape
        outs = [torch.empty((2, halo + chunk, nt), dtype=torch.float32,
                            device=x.device) for x in planes]
        streams = [torch.cuda.current_stream(x.device) for x in planes]
        cross = [r for r in range(len(planes) - 1)
                 if streams[r] != streams[r + 1]]
        for r in cross:
            streams[r].wait_stream(streams[r + 1])
            outs[r + 1].record_stream(streams[r])
        for r, x in enumerate(planes):
            right = outs[r + 1] if r + 1 < len(planes) else None
            with torch.cuda.device(x.device):
                rc = fn(x.data_ptr(), outs[r].data_ptr(),
                        None if right is None else right.data_ptr(),
                        chunk, halo, nt, int(r == 0), streams[r].cuda_stream)
            _build.check(rc, lib, "halo_exchange_error_string", "old halo")
        for r in cross:
            streams[r + 1].wait_stream(streams[r])
        return outs

    def conv(mesh, sig, taps):
        devs, chunk, halo = seq_chunks(mesh, "seq", sig.shape[0], taps)
        planes = [torch.view_as_real(sig[i * chunk:(i + 1) * chunk].to(dev))
                  .permute(2, 0, 1).contiguous() for i, dev in enumerate(devs)]
        ys = []
        with full_f32_matmul():
            for e, dev in zip(exchange(mesh, planes, halo), devs):
                ys.append(overlap_save(torch.complex(e[0], e[1]),
                                       taps.to(dev), chunk, halo))
        return torch.cat([y.to(mesh.first) for y in ys])

    return exchange, conv


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of an earlier design's csrc sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_halo: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False

    from mamimo_tpu_torch.channel.scattering import (
        ChannelRealization,
        make_scenario,
        realize_channel,
    )
    from mamimo_tpu_torch.config import SimConfig
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.ltf import gen_preamble
    from mamimo_tpu_torch.parallel.halo import (
        channel_taps,
        sharded_apply_channel,
    )
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.rdma_halo import (
        _halo_exchange_complex,
        halo_exchange_pallas,
        sharded_apply_channel_rdma,
    )
    from mamimo_tpu_torch.pipeline.sounding import pad_signal
    from mamimo_tpu_torch.tools.probe_tail import _old_lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    _build.build_all(("halo",))
    dev = torch.device("cuda", 0)
    cfg = SimConfig()
    d = 4
    mesh = make_mesh({"seq": d}, devices=[dev] * d)
    gch = torch.Generator().manual_seed(5)
    chan = realize_channel(cfg, gch, make_scenario(cfg, gch))
    chan = ChannelRealization(*(t.to(dev) for t in chan))
    sig = pad_signal(cfg, gen_preamble(cfg)).to(dev)
    taps = channel_taps(cfg, chan, n_taps=cfg.fir_taps)
    chunk, halo = sig.shape[0] // d, taps.shape[0] - 1
    planes = [torch.view_as_real(sig[r * chunk:(r + 1) * chunk])
              .permute(2, 0, 1).contiguous() for r in range(d)]
    chunks = [sig[r * chunk:(r + 1) * chunk] for r in range(d)]
    devs = [dev] * d
    print(f"[shape] {d} virtual ranks on cuda:0: chunk {chunk}, halo {halo}, "
          f"nt {cfg.num_tx}")

    designs = {"new": {
        "exchange": lambda: halo_exchange_pallas(mesh, planes, halo),
        "complex exchange": lambda: _halo_exchange_complex(mesh, chunks,
                                                           halo),
        "conv": lambda: sharded_apply_channel_rdma(cfg, mesh, sig, taps),
        "plain-exchange conv": lambda: sharded_apply_channel(cfg, mesh, sig,
                                                             taps)}}
    summary = {"card": card, "chunk": chunk, "halo": halo, "ranks": d,
               "windows": []}
    if args.old is not None:
        old_x, old_conv = old_design(_old_lib(args.old, "halo"))
        designs["old"] = {
            "exchange": lambda: old_x(mesh, planes, halo),
            "conv": lambda: old_conv(mesh, sig, taps)}
        same_x = all(torch.equal(a, b) for a, b in zip(
            designs["old"]["exchange"](), designs["new"]["exchange"]()))
        same_c = torch.equal(designs["old"]["conv"](),
                             designs["new"]["conv"]())
        print(f"[old vs new] blocks bit-identical: {same_x}; convolution "
              f"bit-identical: {same_c}")
        summary["identical_to_old"] = {"exchange": same_x, "conv": same_c}
        if not same_x:
            raise AssertionError("the two designs' blocks differ")
    print("[host] each form's operators by own host time per call (ms, "
          "calls per call; torch.profiler):")
    summary["host_ops"] = {}
    for tag, forms in designs.items():
        for form, fn in forms.items():
            ops = host_ops(fn)
            summary["host_ops"][f"{tag} {form}"] = ops
            print(f"  {tag} {form}: all operators {ops['total_ms']:.4f}; "
                  + "; ".join(f"{n} {ms:.4f} x{c:g}"
                              for n, ms, c in ops["top"]))
    order = ("old", "new", "new", "old") if args.old else ("new",)
    for tag in order:
        for form, fn in designs[tag].items():
            w = window(fn, devs)
            print(f"  {tag} {form}: host {w['host_ms']:.4f} ms per call, "
                  f"halo kernels {w['halo_kernel_ms']:.5f} ms, device busy "
                  f"{w['busy_ms']:.4f} ms (traced); SM {w['sm_mhz']} MHz, "
                  f"{w['power_w']} W  [{card}]")
            summary["windows"].append({"design": tag, "form": form, **w})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
