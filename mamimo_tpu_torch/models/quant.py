"""int8 quantized factored inference (the port's copy of
``mamimo_tpu/models/quant.py``).

Scheme (dynamic-activation / static-weight post-training quantization):

* weights: symmetric per-output-channel int8, folded once by
  :func:`quantize_params_int8` (scales float32);
* activations: symmetric per-row dynamic int8 (raw-signal rows have
  SNR-dependent power, so static scales would clip);
* products: int8 × int8 with int32 accumulation — on the card the
  hand-written kernel ``ops/kernels/int8_mm.py::matmul_int8``, on the CPU
  its exact plain version; dequantisation is one float32 multiply by
  (row scale × column scale) in PyTorch, as it is XLA in the JAX package;
* the eval-mode BN affine, biases, relu and the pilot-head expansion stay
  float32, as in the float32 factored path (``models/mlp.py``).

Parameters keep the stacked layout of ``models/mlp.py``: every leaf has
a leading plane axis of 2; the apply functions loop over the two planes
(the JAX package ``vmap``s them). The codes and scales equal the JAX
package's bit for bit on the same float32 weights (``torch.round`` and
``jnp.round`` both round half to even).
"""

from __future__ import annotations

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import _bn_affine, plane, require_full_input
from mamimo_tpu_torch.ops.kernels.int8_mm import matmul_int8, matmul_pallas
from mamimo_tpu_torch.ops.ltf import pilot_p_matrix


def _quant_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8: w (..., K, N) → (int8 (..., K,
    N), float32 (..., N) scale)."""
    absmax = w.abs().amax(dim=-2)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -127, 127)
    return q.to(torch.int8), scale.float()


def _quant_rows(x: torch.Tensor):
    """Symmetric per-row dynamic int8: x (..., K) → (int8 x, float32
    (..., 1) scale)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale.float()


def _int8_matmul(xq, xs, wq, ws, wq_t=None):
    """(xq (S, K) int8 · xs (S, 1)) @ (wq (K, N) int8 · ws (N,)) with int32
    accumulation. ``wq_t``, the (N, K) copy of wq, is the kernel's
    operand; without it the product transposes wq per call."""
    acc = matmul_int8(xq, wq_t) if wq_t is not None else matmul_pallas(xq, wq)
    return acc.float() * xs * ws[None, :]


def quantize_params_int8(tcfg: TrainConfig, params, bn_state,
                         sig_len: int | None = None):
    """Fold stacked float32 params to the int8 inference tree.

    Every dense/output kernel becomes (int8 weights, f32 per-column
    scales); biases and the folded eval-mode BN affine stay float32.

    sig_len (= cfg.len_ltf) splits layer 1 into signal rows [:sig_len]
    and pilot rows [sig_len:]: the pilot-row weights are much larger than
    the signal-row weights (pilot inputs are ±1), so per-column scales
    shared by both would starve the signal rows of levels. The pilot
    block (num_tx, H) stays float32.
    """
    out = {"dense": [], "bn_a": [], "bn_c": [], "b": [],
           "out_w": None, "out_s": None, "out_b": params["out"]["b"],
           "w1_pil": None}
    for i, lyr in enumerate(params["dense"]):
        w = lyr["w"]
        if i == 0 and sig_len is not None:
            out["w1_pil"] = w[:, sig_len:]
            w = w[:, :sig_len]
        q, s = _quant_weight(w)
        out["dense"].append({"wq": q, "ws": s})
        out["b"].append(lyr["b"])
        if params["bn"]:
            a, c = _bn_affine(tcfg, params, bn_state, i)
            out["bn_a"].append(a)
            out["bn_c"].append(c)
    out["out_w"], out["out_s"] = _quant_weight(params["out"]["w"])
    if out["w1_pil"] is None:
        w1 = params["dense"][0]["w"]
        out["w1_pil"] = torch.zeros((2, 0, w1.shape[-1]), device=w1.device)
    return out


def _pilot_block(qp, sig_len: int) -> torch.Tensor:
    """Layer 1's float32 pilot rows: the unquantized block when
    quantize_params_int8 was given sig_len, else the dequantized int8
    rows past sig_len. Works on one plane or on stacked leaves."""
    if qp["w1_pil"].shape[-2] > 0:
        return qp["w1_pil"].float()
    d = qp["dense"][0]
    return d["wq"][..., sig_len:, :].float() * d["ws"].unsqueeze(-2)


def prepare_int8_serving(cfg: SimConfig, qparams):
    """The int8 tree as the card's path takes it, made once per set of
    weights (call it inside ``full_f32_matmul``): every int8 matrix also
    as its (N, K) transpose for the kernel (``wq_t`` beside each dense
    ``wq``, ``out_w_t``), and the pilot-row product of layer 1 for the
    all-pairs heads, ``pil_proj = P.T @ w1_pil`` (2, num_tx, H). The
    original leaves are kept, so the result is also a valid
    quantize_params_int8 tree."""
    L = cfg.len_ltf
    out = dict(qparams)
    out["dense"] = [
        dict(d, wq_t=(d["wq"][:, :L] if i == 0 else d["wq"])
             .transpose(1, 2).contiguous())
        for i, d in enumerate(qparams["dense"])]
    out["out_w_t"] = qparams["out_w"].transpose(1, 2).contiguous()
    p = pilot_p_matrix(cfg.num_tx, device=qparams["out_w"].device)
    out["pil_proj"] = p.T @ _pilot_block(qparams, L)
    return out


def factored_plane_apply_int8(cfg: SimConfig, qp, x: torch.Tensor,
                              pil_rows: torch.Tensor) -> torch.Tensor:
    """One plane's factored eval-mode MLP with int8 products (the int8
    analogue of ``models/mlp.py::factored_plane_apply``).

    Args:
      qp: one plane's quantized params (a plane of quantize_params_int8
        or of prepare_int8_serving, whose ``pil_proj`` is this product
        for pil_rows = P.T and is then used as it is).
      x: (S, L) float32/bfloat16 signal plane.
      pil_rows: (n_heads, num_tx) pilot rows.

    Returns:
      (S, n_heads, num_carriers) float32.
    """
    L = x.shape[-1]
    s_count = x.shape[0]

    # layer 1, signal half: int8 product over the len_ltf-sample axis
    xq, xs = _quant_rows(x.float())
    d0 = qp["dense"][0]
    sig_proj = _int8_matmul(xq, xs, d0["wq"][:L], d0["ws"], d0.get("wq_t"))

    # layer 1, pilot half: tiny (n_heads × num_tx), float32
    if "pil_proj" in qp:
        pil_proj = qp["pil_proj"]
    else:
        pil_proj = pil_rows.float() @ _pilot_block(qp, L)
    n_heads = pil_proj.shape[0]

    h = torch.relu(sig_proj[:, None, :] + pil_proj[None] + qp["b"][0])
    if qp["bn_a"]:
        h = h * qp["bn_a"][0] + qp["bn_c"][0]

    for i in range(1, len(qp["dense"])):
        d = qp["dense"][i]
        hq, hs = _quant_rows(h.reshape(s_count * n_heads, -1))
        h = torch.relu(_int8_matmul(hq, hs, d["wq"], d["ws"], d.get("wq_t"))
                       + qp["b"][i])
        if qp["bn_a"]:
            h = h * qp["bn_a"][i] + qp["bn_c"][i]
        h = h.reshape(s_count, n_heads, -1)

    hq, hs = _quant_rows(h.reshape(s_count * n_heads, -1))
    y = _int8_matmul(hq, hs, qp["out_w"], qp["out_s"],
                     qp.get("out_w_t")) + qp["out_b"]
    return y.reshape(s_count, n_heads, -1).float()


def predict_all_pairs_planes_flat_int8(cfg: SimConfig, tcfg: TrainConfig,
                                       qparams, planes: torch.Tensor):
    """int8 factored all-pairs inference from flat canonical planes
    (2, S, len_ltf) — the int8 twin of ``models/mlp.py::
    predict_all_pairs_planes_flat``, qparams from quantize_params_int8
    (or prepare_int8_serving).

    Returns:
      (S, num_tx, num_carriers) complex64.
    """
    require_full_input(tcfg)
    pil = pilot_p_matrix(cfg.num_tx, device=planes.device).T
    y2 = [factored_plane_apply_int8(cfg, plane(qparams, d), planes[d], pil)
          for d in range(2)]
    return torch.complex(y2[0], y2[1])


def predict_all_pairs_planes_int8(cfg: SimConfig, tcfg: TrainConfig,
                                  qparams, rx_planes: torch.Tensor):
    """int8 factored all-pairs inference from rx-major planes
    (2, B, num_rx, len_ltf) → (B, num_rx, num_tx, num_carriers)
    complex64."""
    _, b, nrx, L = rx_planes.shape
    y = predict_all_pairs_planes_flat_int8(
        cfg, tcfg, qparams, rx_planes.reshape(2, b * nrx, L))
    return y.reshape(b, nrx, cfg.num_tx, cfg.num_carriers)
