#!/usr/bin/env python3
"""Kernel 7 (the fused halo exchange) with its ranks on different cards.

    python3 mamimo_tpu_torch/tools/halo_cards.py

Needs two or more CUDA cards that can reach each other (peer access) and
uses every visible one. ``chip_smoke.py`` runs the sequence-parallel
path on virtual ranks of one card, where one launch covers every rank;
this script drives what only several cards exercise: peer access, the
kernel's store through a pointer into another card's memory, and the
device-side flags that order neighbours on different cards (the barrier
before a put, the arrival flag after it, each holding a call's epoch) in
``csrc/halo.cu``.

Three meshes of the ``seq`` axis at BS32 (Nt 32, the padded 11200-sample
preamble, the 512 taps of a seeded scattering realization), over n
cards:

* one rank per card (n ranks, every neighbour on another card);
* two ranks per card (2n ranks, neighbours alternately on one card and
  across cards);
* interleaved, [c0, c1, ..., c0, c1, ...] (2n ranks, every neighbour on
  another card, two ranks of each card in one launch).

On each, checked (any failure ends the run with a non-zero exit code):

1. ``halo_exchange_pallas`` on the preamble's chunks, bit-equal to the
   plain exchange (``ext_block_plain``), rank 0's halo zero, one launch
   per card; then 50 calls back to back on fresh random planes (50
   epochs of the flags), each checked bit for bit as the calls go;
2. ``sharded_apply_channel_rdma`` against the unsharded
   ``apply_channel_taps`` on cuda:0, rel err <= 1e-4 (TF32 off);
3. ``sharded_ls_pallas_v2`` seq and data over the cards (bf16 planes,
   S = 256) against the unsharded ``ls_planes_v2``, <= -100 dB.

Times: the host time per call with every card synchronized (launch
overhead included) of the exchange across the cards, of the same number
of virtual ranks on cuda:0, of the plain exchange across the cards and
of both sharded convolutions; and each card's device time of the halo
kernel and its device-busy time in a ``torch.profiler`` trace of the
exchange and of ``sharded_apply_channel_rdma`` (``probe_halo.
trace_device``), with the share of halo-kernel time during which another
card ran it too. Prints one JSON line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REPEATS = 50


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("halo_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mamimo_tpu_torch.channel.scattering import (
        ChannelRealization,
        make_scenario,
        realize_channel,
    )
    from mamimo_tpu_torch.config import SimConfig
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_ls import ls_planes_v2
    from mamimo_tpu_torch.ops.ltf import gen_preamble
    from mamimo_tpu_torch.parallel.halo import (
        apply_channel_taps,
        channel_taps,
        sharded_apply_channel,
    )
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.rdma_halo import (
        MAX_RANKS_PER_CARD,
        ext_block_plain,
        halo_exchange_pallas,
        sharded_apply_channel_rdma,
    )
    from mamimo_tpu_torch.parallel.sharded import sharded_ls_pallas_v2
    from mamimo_tpu_torch.pipeline.sounding import pad_signal
    from mamimo_tpu_torch.tools.probe_halo import host_ms, trace_device

    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(f"[cards] {n}: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    for line in smi:
        print(line)
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for a in range(n) for b in range(n) if a != b}
    print(f"[peer] can_device_access_peer: {peer}")
    t0 = time.perf_counter()
    _build.build_all(("halo", "ls_v2"))
    print(f"[build] halo, ls_v2: {time.perf_counter() - t0:.1f} s")

    cfg = SimConfig()
    dev0 = cards[0]
    gch = torch.Generator().manual_seed(5)
    chan = realize_channel(cfg, gch, make_scenario(cfg, gch))
    chan = ChannelRealization(*(t.to(dev0) for t in chan))
    sig = pad_signal(cfg, gen_preamble(cfg)).to(dev0)        # (11200, Nt)
    taps = channel_taps(cfg, chan, n_taps=cfg.fir_taps)
    halo = taps.shape[0] - 1
    ref_conv = apply_channel_taps(sig, taps)
    g = torch.Generator(device=dev0).manual_seed(6)
    xs16 = torch.randn((2, 256, cfg.len_ltf), generator=g,
                       device=dev0).to(torch.bfloat16)
    un2 = ls_planes_v2(cfg, xs16)
    un_c = torch.complex(un2[0], un2[1])

    def exchange_exact(tag, mesh, planes):
        k = halo_exchange_pallas.launches
        outs = halo_exchange_pallas(mesh, planes, halo)
        n_cards = len(set(x.device for x in planes))
        if halo_exchange_pallas.launches - k != n_cards:
            raise AssertionError(f"{tag}: {halo_exchange_pallas.launches - k} "
                                 f"launches, want one per card ({n_cards})")
        for r, (got, x) in enumerate(zip(outs, planes)):
            want = ext_block_plain(x, planes[r - 1] if r else None, halo)
            if got.device != x.device or not torch.equal(got, want):
                raise AssertionError(f"{tag}: rank {r}'s block differs from "
                                     f"the plain exchange")
        if bool((outs[0][:, :halo] != 0).any()):
            raise AssertionError(f"{tag}: rank 0's halo is not zero")

    result = {"cards": n, "card": smi, "peer": peer, "meshes": {}}
    layouts = {"one rank per card": cards,
               "two ranks per card": [c for c in cards for _ in range(2)],
               "interleaved": cards + cards}
    for layout, devs in layouts.items():
        d = len(devs)
        mesh = make_mesh({"seq": d}, devices=devs)
        chunk = sig.shape[0] // d
        tag = f"seq {d}, {layout}"
        planes = [torch.view_as_real(sig[r * chunk:(r + 1) * chunk])
                  .permute(2, 0, 1).contiguous().to(dev)
                  for r, dev in enumerate(devs)]
        exchange_exact(f"{tag}, preamble", mesh, planes)
        gs = [torch.Generator(device=dev).manual_seed(100 + r)
              for r, dev in enumerate(devs)]
        for i in range(REPEATS):
            exchange_exact(f"{tag}, random planes, call {i}", mesh, [
                torch.randn((2, chunk, cfg.num_tx), generator=gr, device=dev)
                for gr, dev in zip(gs, devs)])
        conv = sharded_apply_channel_rdma(cfg, mesh, sig, taps)
        rel = float(torch.linalg.norm(conv - ref_conv)
                    / torch.linalg.norm(ref_conv))
        if not (conv.device == dev0 and rel <= 1e-4):
            raise AssertionError(f"{tag}: sharded_apply_channel_rdma rel err "
                                 f"{rel:.3e} on {conv.device}")
        ls_db = {}
        for mode in ("seq", "data"):
            if mode == "seq" and cfg.num_tx % d:
                continue
            m = make_mesh({mode: d}, devices=devs)
            h = sharded_ls_pallas_v2(cfg, m, xs16, mode=mode)
            ls_db[mode] = float(10 * torch.log10(
                torch.sum(torch.abs(h - un_c) ** 2)
                / torch.sum(torch.abs(un_c) ** 2)))
            if not (h.device == dev0 and ls_db[mode] <= -100.0):
                raise AssertionError(f"{tag}: sharded_ls_pallas_v2 {mode} "
                                     f"{ls_db[mode]:.2f} dB")
        virt = make_mesh({"seq": d}, devices=[dev0] * d)
        planes0 = [x.to(dev0) for x in planes]
        times = {
            "exchange_across_cards_ms": host_ms(
                lambda: halo_exchange_pallas(mesh, planes, halo), devs),
            "exchange_virtual_ranks_cuda0_ms": host_ms(
                lambda: halo_exchange_pallas(virt, planes0, halo), [dev0])
            if d <= MAX_RANKS_PER_CARD else None,
            "plain_exchange_across_cards_ms": host_ms(
                lambda: [ext_block_plain(x, planes[r - 1] if r else None,
                                         halo)
                         for r, x in enumerate(planes)], devs),
            "sharded_apply_channel_rdma_ms": host_ms(
                lambda: sharded_apply_channel_rdma(cfg, mesh, sig, taps),
                devs, iters=10),
            "sharded_apply_channel_plain_ms": host_ms(
                lambda: sharded_apply_channel(cfg, mesh, sig, taps),
                devs, iters=10)}
        traced = {
            "exchange": trace_device(
                lambda: halo_exchange_pallas(mesh, planes, halo)),
            "sharded_apply_channel_rdma": trace_device(
                lambda: sharded_apply_channel_rdma(cfg, mesh, sig, taps))}
        print(f"[{tag}] chunk {chunk}, halo {halo}: exchange exact "
              f"({1 + REPEATS} calls, one launch per card), conv rel err "
              f"{rel:.3e}, LS "
              f"{ {k: round(v, 2) for k, v in ls_db.items()} } dB; host ms "
              f"{ {k: v and round(v, 4) for k, v in times.items()} }  "
              f"[{smi[0]}]")
        for what, tr in traced.items():
            print(f"  {what} traced, device ms per call by card: "
                  + "; ".join(f"cuda:{i} halo kernel {c['match_ms']:.5f}, "
                              f"busy {c['busy_ms']:.4f}"
                              for i, c in sorted(tr["cards"].items()))
                  + f"; halo kernels overlapping another card's "
                  f"{tr['overlap'] * 100:.1f}% of their time  [{smi[0]}]")
        result["meshes"][tag] = {"ranks": d, "cards": [x.index for x in devs],
                                 "chunk": chunk, "halo": halo,
                                 "conv_rel_err": rel, "ls_nmse_db": ls_db,
                                 "host_ms": times, "traced": traced}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
