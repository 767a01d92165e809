"""The port's counterparts of ``__graft_entry__.py``: ``entry``, the
serving step of the flagship model at full BS32 size, and
``dryrun_multichip``, one DP+TP training step and the sharded forms over
a mesh at the same shapes, each a one-call check that it runs.
"""

from __future__ import annotations

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import init_stacked
from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.ops.kernels.fused_factored import (
    fused_factored_planes,
    prepare_factored_weights,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_planes_v2,
    ls_sm90_constants,
)
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def entry(device=None):
    """The fused preamble → (LS, DNN) estimation step of BS32, with
    seeded random weights.

    On the card: the LS kernel ``ls_planes_v2`` with its bf16 store and
    the fused factored DNN kernels, their output cast to bf16 (the JAX
    entry's TPU path: LS v2 with ``out_dtype=bfloat16`` and the bf16
    factored DNN). On the CPU, the kernels' plain versions.

    Args:
      device: where the step runs; None means cuda:0 (raises without a
        CUDA device).

    Returns:
      (fn, (planes,)): planes (2, 16, len_ltf) float32 normal (4 packets),
      and fn(planes) → (h_ls, h_dnn), each (2, S, num_tx, num_carriers)
      bfloat16 planes.
    """
    dev = resolve_device("cuda:0" if device is None else device)
    cfg, tcfg = SimConfig(), TrainConfig()
    params, bn_state = init_stacked(torch.Generator().manual_seed(0), cfg,
                                    tcfg, device=dev)
    consts = ls_sm90_constants(cfg, dev) if dev.type == "cuda" else None
    with full_f32_matmul():
        prepared = prepare_factored_weights(cfg, tcfg, params, bn_state)

    def fn(planes):
        pl16 = planes.to(torch.bfloat16)
        h_ls = ls_planes_v2(cfg, pl16, consts, out_dtype=torch.bfloat16)
        h_dnn = fused_factored_planes(cfg, tcfg, prepared, pl16)
        return h_ls, h_dnn.to(torch.bfloat16)

    g = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn((2, 4 * cfg.num_rx, cfg.len_ltf), generator=g,
                         device=dev)
    return fn, (planes,)


def dryrun_multichip(n_devices: int, devices=None, cfg=None,
                     tcfg=None) -> dict:
    """One full DP+TP training step over an n_devices mesh at the BS32
    shapes (Nt = 32, a 10240-sample preamble, a 1024 x 1024 hidden MLP,
    batch 16), then the sequence-parallel LS, the antenna-sharded
    inference, the overlap-save channel convolution with the plain
    exchange and with the halo kernel (kernel 7), the LS kernel (kernel 1)
    per rank in data and seq modes, and with 8 or more ranks the combined
    data x seq x antenna estimation step; raises on a wrong shape, a
    non-finite loss or a convolution off the unsharded one.

    Args:
      devices: one device per rank (repeats allowed, e.g. 4 virtual ranks
        of one card); None: the first n_devices visible cards (raises
        without them).
      cfg, tcfg: other shapes (the tests' small ones); default BS32.

    Returns {what: shape} of every output, and the step's loss.
    """
    from mamimo_tpu_torch.channel.scattering import (
        make_scenario,
        realize_channel,
    )
    from mamimo_tpu_torch.parallel.halo import (
        apply_channel_taps,
        channel_taps,
        sharded_apply_channel,
    )
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.rdma_halo import sharded_apply_channel_rdma
    from mamimo_tpu_torch.parallel.sharded import (
        make_sharded_train_step,
        sharded_estimate_combined,
        sharded_ls_estimate,
        sharded_ls_pallas_v2,
        sharded_predict_all_pairs,
    )

    if devices is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip: {n_devices} CUDA GPUs "
                               "wanted; pass devices= for other ranks")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devices = [resolve_device(d) for d in list(devices)[:n_devices]]
    cfg = cfg or SimConfig(n_scatterers=8)
    tcfg = tcfg or TrainConfig(batch_size=16)
    nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
    axes = ({"data": n_devices // 2, "model": 2}
            if n_devices % 2 == 0 and n_devices > 1 else {"data": n_devices})
    mesh = make_mesh(axes, devices=devices)
    dev = mesh.first
    out = {}

    def shape_of(what, t, want):
        if tuple(t.shape) != tuple(want):
            raise AssertionError(f"dryrun_multichip: {what} gave "
                                 f"{tuple(t.shape)}, want {tuple(want)}")
        out[what] = tuple(t.shape)

    init_fn, step_fn = make_sharded_train_step(cfg, tcfg, mesh)
    params, bn_state, opt_state = init_fn(torch.Generator().manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    bsz = tcfg.batch_size
    x2 = torch.randn((2, bsz, L), generator=g, device=dev)
    pilot = torch.randn((bsz, nt), generator=g, device=dev)
    y2 = torch.randn((2, bsz, C), generator=g, device=dev)
    *_, loss = step_fn(params, bn_state, opt_state, x2, pilot, y2,
                       torch.Generator(device=dev).manual_seed(0), 1e-4)
    shape_of(f"train step {axes}", loss, (2,))
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"dryrun_multichip: the step's loss is {loss}")
    out["loss"] = loss.tolist()

    seq = max(d for d in (1, 2, 4, 8) if d <= n_devices and nt % d == 0)
    if seq > 1:
        seq_mesh = make_mesh({"seq": seq}, devices=devices[:seq])
        rx = torch.complex(torch.randn((2, L, nr), generator=g, device=dev),
                           torch.randn((2, L, nr), generator=g, device=dev))
        shape_of("sharded_ls_estimate", sharded_ls_estimate(
            cfg, seq_mesh, rx), (2, C, nt, nr))
        p2, b2 = init_stacked(torch.Generator().manual_seed(0), cfg, tcfg,
                              device=dev)
        shape_of("sharded_predict_all_pairs", sharded_predict_all_pairs(
            cfg, tcfg, make_mesh({"antenna": seq}, devices=devices[:seq]),
            p2, b2, rx), (2, C, nt, nr))
        gc = torch.Generator(device=dev).manual_seed(0)
        chan = realize_channel(cfg, gc, make_scenario(cfg, gc))
        n = seq * 640
        sig = torch.complex(torch.randn((n, nt), generator=g, device=dev),
                            torch.randn((n, nt), generator=g, device=dev))
        with full_f32_matmul():
            shape_of("sharded_apply_channel", sharded_apply_channel(
                cfg, seq_mesh, sig, channel_taps(cfg, chan, n_taps=512)),
                (n, nr))
            # the halo kernel at the JAX dry run's moderated shapes
            n_r = seq * 256
            taps_r = channel_taps(cfg, chan, n_taps=128)
            conv = sharded_apply_channel_rdma(cfg, seq_mesh, sig[:n_r],
                                              taps_r)
            ref = apply_channel_taps(sig[:n_r], taps_r)
        shape_of("sharded_apply_channel_rdma", conv, (n_r, nr))
        err = float((conv - ref).abs().max() / ref.abs().max())
        if not err <= 2e-4:
            raise AssertionError(f"dryrun_multichip: the halo kernel's "
                                 f"convolution is {err:.3e} off the "
                                 f"unsharded one (limit 2e-4)")
        out["sharded_apply_channel_rdma_rel_err"] = err
        planes = torch.randn((2, 2 * seq, L), generator=g, device=dev)
        for mode, m in (("data", make_mesh({"data": seq},
                                           devices=devices[:seq])),
                        ("seq", seq_mesh)):
            shape_of(f"sharded_ls_pallas_v2 {mode}", sharded_ls_pallas_v2(
                cfg, m, planes, mode=mode), (2 * seq, nt, C))

    if n_devices >= 8:
        cmesh = make_mesh({"data": n_devices // 4, "seq": 2, "antenna": 2},
                          devices=devices)
        pc, bc = init_stacked(torch.Generator().manual_seed(0), cfg, tcfg,
                              device=dev)
        b = 2 * (n_devices // 4)
        rxc = torch.complex(torch.randn((b, L, nr), generator=g, device=dev),
                            torch.randn((b, L, nr), generator=g, device=dev))
        h_ls, h_dnn = sharded_estimate_combined(cfg, tcfg, cmesh, pc, bc, rxc)
        shape_of("sharded_estimate_combined h_ls", h_ls, (b, C, nt, nr))
        shape_of("sharded_estimate_combined h_dnn", h_dnn, (b, C, nt, nr))
    print(f"[dryrun_multichip] OK on {n_devices} ranks (mesh {axes}, "
          f"seq/antenna={seq}, plain and kernel halo exchange, LS kernel "
          f"data+seq"
          + (", combined data*seq*antenna" if n_devices >= 8 else "")
          + f") at len_ltf={L}, hidden={tuple(tcfg.hidden)}")
    return out
