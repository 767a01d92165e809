"""Sharded inference forms over a mesh (the port of the inference half of
``mamimo_tpu/parallel/sharded.py``).

* ``sharded_ls_estimate`` — the preamble's LTF symbols split over the
  ``seq`` ranks at symbol boundaries; each rank FFT-demodulates its
  symbols and despreads them with its columns of P (a partial), and one
  sum over the ranks completes the estimate;
* ``sharded_ls_pallas_v2`` — the LS kernel (kernel 1) per rank: samples
  split over ``data`` (no collective), or symbols over ``seq`` with the
  kernel's partial-despread mode and a sum over the ranks;
* ``sharded_predict_all_pairs`` — the DNN's pilot heads split over
  ``antenna``; no collective;
* ``sharded_estimate_combined`` — LS and DNN over one data × seq ×
  antenna mesh.

Each rank's work runs on its device from this one process. Where the JAX
package all-reduces (``psum``) the port sums the ranks' partials onto
the first rank's device with PyTorch; FFTs and products are PyTorch in
full float32 (TF32 off), as they are XLA in JAX. Outputs the JAX package
leaves sharded come back gathered on the mesh's first device; outputs it
replicates come back once, on that device. The DP+TP training step
(``param_shardings``, ``make_sharded_train_step``) waits for the
training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import (
    factored_heads_apply,
    factored_plane_apply,
    plane,
    tree_map,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_planes_v2,
    ls_sm90_constants,
    seq_shard_symbols,
)
from mamimo_tpu_torch.ops.ltf import _hadamard_np, _ltf_np
from mamimo_tpu_torch.parallel.mesh import Mesh
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def _divide(total: int, n: int, what: str) -> int:
    if total % n:
        raise ValueError(f"{total} {what} do not divide over {n} ranks")
    return total // n


def sum_onto(parts, device: torch.device) -> torch.Tensor:
    """The all-reduce of the port: the sum of the ranks' partials on
    ``device``, in a new tensor (the partials are left as they were)."""
    if len(parts) == 1:
        return parts[0].to(device, copy=True)
    total = parts[0].to(device) + parts[1].to(device)
    for p in parts[2:]:
        total += p.to(device)
    return total


def _ls_partial_fft(cfg: SimConfig, rx_blk: torch.Tensor,
                    p_cols: torch.Tensor) -> torch.Tensor:
    """A rank's partial LS despread: rx_blk (B, loc·sym_len, R) holds loc
    whole symbols; FFT-demodulate them and contract with their columns
    p_cols (num_tx, loc) of P → (B, C, num_tx, R), not yet divided by
    nsym·ltf."""
    b, _, r = rx_blk.shape
    loc = p_cols.shape[1]
    x = rx_blk.reshape(b, loc, cfg.sym_len, r)[:, :, cfg.cp_length:, :]
    X = torch.fft.fftshift(torch.fft.fft(x, dim=2), dim=2)
    X = X[:, :, list(cfg.carrier_locations), :]              # (B, loc, C, R)
    return torch.einsum("bncr,jn->bcjr", X, p_cols.to(X.dtype))


def _ls_denominator(cfg: SimConfig, device) -> torch.Tensor:
    ltf = _ltf_np(cfg.fft_length)[np.asarray(cfg.carrier_locations)]
    return torch.as_tensor((cfg.num_tx * ltf).astype(np.float32),
                           device=device)


def sharded_ls_estimate(cfg: SimConfig, mesh: Mesh, rx,
                        axis: str = "seq") -> torch.Tensor:
    """LS channel estimation with the preamble split over OFDM symbols.

    Args:
      mesh: a mesh with ``axis`` (num_tx must divide over its size).
      rx: (B, len_ltf, num_rx) complex received preambles.

    Returns:
      (B, C, num_tx, num_rx) complex64 LS estimate (replicated in JAX),
      once, on the mesh's first device.
    """
    devs = mesh.axis_devices(axis)
    loc = _divide(cfg.num_tx, len(devs), "symbols")
    p_full = torch.as_tensor(_hadamard_np(cfg.num_tx))
    rx = torch.as_tensor(rx).to(torch.complex64)
    l_loc = loc * cfg.sym_len
    parts = []
    with full_f32_matmul():
        for i, dev in enumerate(devs):
            parts.append(_ls_partial_fft(
                cfg, rx[:, i * l_loc:(i + 1) * l_loc].to(dev),
                p_full[:, i * loc:(i + 1) * loc].to(dev)))
    total = sum_onto(parts, mesh.first)
    return total / _ls_denominator(cfg, mesh.first)[None, :, None, None]


def sharded_ls_pallas_v2(cfg: SimConfig, mesh: Mesh, planes,
                         mode: str = "data", data_axis: str = "data",
                         seq_axis: str = "seq",
                         consts: torch.Tensor | None = None) -> torch.Tensor:
    """The LS kernel (``ops/kernels/fused_ls.py::ls_planes_v2``, kernel 1)
    run per rank of a mesh.

    Args:
      planes: (2, S, len_ltf) canonical planes (S = B·num_rx), float32
        or bfloat16; a CUDA rank casts its float32 share once to bfloat16,
        the kernel's input (``ls_planes_v2``).
      mode:
        'data' — S splits over ``data_axis``; each rank runs the kernel
          on its samples; no collective;
        'seq'  — the preamble's symbols split over ``seq_axis``; each
          rank runs the kernel's partial-despread mode on its symbols
          (``seq_shard=(i, n)``), and the partials are summed onto the
          first rank's device (the JAX package's psum).
      consts: CUDA ranks only, ``ls_sm90_constants(cfg, device)`` on
        any device, copied to each rank's card; built per call when
        omitted (a host build that costs more than the kernels).

    Returns:
      (S, num_tx, num_carriers) complex64 rx-major, on the mesh's first
      device: 'data' gathered over the ranks (sharded on S in JAX),
      'seq' once (replicated in JAX).
    """
    _, s, _ = planes.shape
    if mode not in ("data", "seq"):
        raise ValueError(f"mode must be 'data' or 'seq', got {mode!r}")
    devs = mesh.axis_devices(data_axis if mode == "data" else seq_axis)
    cards = {dev for dev in devs if dev.type == "cuda"}
    if cards and consts is None:
        consts = ls_sm90_constants(cfg)
    per_card = {dev: consts.to(dev) for dev in cards}
    if mode == "data":
        s_loc = _divide(s, len(devs), "samples")
        hs = [ls_planes_v2(cfg, planes[:, i * s_loc:(i + 1) * s_loc].to(dev),
                           per_card.get(dev)).to(mesh.first)
              for i, dev in enumerate(devs)]
        h = torch.cat(hs, dim=1)
    else:
        n = len(devs)
        l_loc = seq_shard_symbols(cfg, (0, n)) * cfg.sym_len
        parts = [ls_planes_v2(cfg, planes[:, :, i * l_loc:(i + 1) * l_loc]
                              .to(dev), per_card.get(dev), seq_shard=(i, n))
                 for i, dev in enumerate(devs)]
        h = sum_onto(parts, mesh.first)
    return torch.complex(h[0], h[1])


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def sharded_predict_all_pairs(cfg: SimConfig, tcfg: TrainConfig, mesh: Mesh,
                              params, bn_state, rx,
                              axis: str = "antenna") -> torch.Tensor:
    """All-pairs DNN inference with the Tx-pilot heads split over
    ``axis``: rank i computes the pairs of its num_tx / n pilot heads
    (the shared layer-1 signal product is repeated on every rank); no
    collective. Float32 (the bf16 serving form is the kernels').

    Args:
      params, bn_state: the stacked model (``models/mlp.py``).
      rx: (B, len_ltf, num_rx) complex64.

    Returns:
      (B, C, num_tx, num_rx) complex64, gathered over the ranks on the
      mesh's first device (sharded on num_tx in JAX).
    """
    devs = mesh.axis_devices(axis)
    loc = _divide(cfg.num_tx, len(devs), "pilot heads")
    p_full = torch.as_tensor(_hadamard_np(cfg.num_tx))
    rx = torch.as_tensor(rx).to(torch.complex64)
    b, L, nrx = rx.shape
    ys = []
    with full_f32_matmul():
        for i, dev in enumerate(devs):
            p_loc = p_full[i * loc:(i + 1) * loc].to(dev)
            pp, bb = _to(params, dev), _to(bn_state, dev)
            sig2 = rx.to(dev).transpose(1, 2).reshape(b * nrx, L)
            y2 = [factored_plane_apply(tcfg, plane(pp, d), plane(bb, d), x,
                                       p_loc)
                  for d, x in enumerate((sig2.real, sig2.imag))]
            y = torch.complex(y2[0], y2[1]).reshape(b, nrx, loc,
                                                    cfg.num_carriers)
            ys.append(y.permute(0, 3, 2, 1).to(mesh.first))
    return torch.cat(ys, dim=2)


def sharded_estimate_combined(cfg: SimConfig, tcfg: TrainConfig, mesh: Mesh,
                              params, bn_state, rx, data_axis: str = "data",
                              seq_axis: str = "seq",
                              ant_axis: str = "antenna"):
    """The fused estimation step (LS + factored all-pairs DNN) over one
    data × seq × antenna mesh:

    * ``data``: packets, no collective;
    * ``seq``: the preamble split at symbol boundaries; each rank makes
      (a) a partial despread for LS and (b) a partial layer-1 signal
      product ``x_loc @ W1[rows_loc]`` for the DNN, each completed by a
      sum over the seq ranks;
    * ``antenna``: the pilot heads; each rank finishes the MLP for its
      heads.

    Work the JAX package repeats on every rank of an axis (the LS and
    layer-1 partials on every antenna rank) runs once here, on the
    antenna-0 rank. Float32 throughout.

    Args:
      rx: (B, len_ltf, num_rx) complex64; B divisible by the data size.

    Returns:
      (h_ls, h_dnn), each (B, C, num_tx, num_rx) complex64, gathered on
      the mesh's first device (in JAX h_ls is replicated over seq and
      antenna, h_dnn split over antenna, both split over data).
    """
    n_data, n_seq, n_ant = (mesh.shape[a] for a in (data_axis, seq_axis,
                                                    ant_axis))
    loc_sym = _divide(cfg.num_tx, n_seq, "symbols")
    loc_heads = _divide(cfg.num_tx, n_ant, "pilot heads")
    rx = torch.as_tensor(rx).to(torch.complex64)
    b_loc = _divide(rx.shape[0], n_data, "packets")
    r = rx.shape[2]
    l_loc = loc_sym * cfg.sym_len
    p_full = torch.as_tensor(_hadamard_np(cfg.num_tx))
    first = mesh.first
    h_ls, h_dnn = [], []
    with full_f32_matmul():
        for i_d in range(n_data):
            rx_d = rx[i_d * b_loc:(i_d + 1) * b_loc]
            home = mesh.device(**{data_axis: i_d})
            ls_parts, sp_parts = [], []
            for i_s in range(n_seq):
                dev = mesh.device(**{data_axis: i_d, seq_axis: i_s})
                blk = rx_d[:, i_s * l_loc:(i_s + 1) * l_loc].to(dev)
                ls_parts.append(_ls_partial_fft(
                    cfg, blk, p_full[:, i_s * loc_sym:(i_s + 1) * loc_sym]
                    .to(dev)))
                w1 = params["dense"][0]["w"][:, i_s * l_loc:
                                             (i_s + 1) * l_loc].to(dev)
                sig2 = blk.transpose(1, 2).reshape(b_loc * r, l_loc)
                sp_parts.append(torch.stack([sig2.real @ w1[0],
                                             sig2.imag @ w1[1]]))
            ls = sum_onto(ls_parts, home) \
                / _ls_denominator(cfg, home)[None, :, None, None]
            h_ls.append(ls.to(first))
            sig_proj = sum_onto(sp_parts, home)              # (2, S, H)
            ys = []
            for i_a in range(n_ant):
                dev = mesh.device(**{data_axis: i_d, ant_axis: i_a})
                pp, bb = _to(params, dev), _to(bn_state, dev)
                pil = p_full[i_a * loc_heads:(i_a + 1) * loc_heads].to(dev)
                sp = sig_proj.to(dev)
                y2 = [factored_heads_apply(tcfg, plane(pp, d), plane(bb, d),
                                           sp[d], pil, cfg.len_ltf)
                      for d in range(2)]
                y = torch.complex(y2[0], y2[1]).reshape(
                    b_loc, r, loc_heads, cfg.num_carriers)
                ys.append(y.permute(0, 3, 2, 1).to(first))
            h_dnn.append(torch.cat(ys, dim=2))
    return torch.cat(h_ls), torch.cat(h_dnn)
