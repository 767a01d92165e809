"""The CSI denoiser MLP (the port's copy of ``mamimo_tpu/models/mlp.py``,
eval mode), the reference's FC model
(``massiveMIMO_CSI_prediction_DNN.py:195-234``):

    [time-domain LTF at one Rx antenna  ⧺  pilot column P[:, iTx]]
        → Dense(h₀, relu) → BN → Dropout
        → Dense(h₁, relu) → BN
        → Dense(num_carriers, linear)

Two real-valued networks (real plane, imaginary plane) are stored as one
stacked model: every parameter has a leading plane axis of size 2.
Parameters are plain dictionaries of tensors with the JAX package's
structure::

    params   = {"dense": [{"w", "b"}, ...], "out": {"w", "b"},
                "bn": [{"scale", "bias"}, ...]}
    bn_state = {"mean": [...], "var": [...]}

so checkpoints move between the two packages leaf for leaf
(``train/ckpt.py``). Keras conventions: glorot-uniform init, BatchNorm
with momentum 0.99 / eps 1e-3 applied after the ReLU; in training mode
batch statistics (biased variance) and the Keras running update
``new = m·old + (1 − m)·batch``, and inverted dropout between hidden
layers only, its masks drawn from an explicit ``torch.Generator``.

``tcfg.matmul_dtype='bf16'`` rounds both operands of every dense product
to bf16 and keeps a float32 result (float32 accumulation), in both modes,
as the JAX module does; its backward rounds each operand's cotangent to
bf16 at JAX's points (``Bf16Dense``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.ops.ltf import pilot_p_matrix

Params = Dict[str, Any]


def model_input_spec(cfg: SimConfig, tcfg: TrainConfig) -> Tuple[int, int]:
    """(signal_len, total_in_dim) after fraction/decimation options."""
    sig_len = cfg.len_ltf // int(tcfg.in_fraction)
    if tcfg.decimate in ("max", "avg"):
        sig_len //= 2
    return sig_len, sig_len + cfg.num_tx


def require_full_input(tcfg: TrainConfig) -> None:
    """The factored forms share layer 1 across heads, which needs the
    whole LTF as the signal input (no fraction, no decimation)."""
    if tcfg.in_fraction != 1 or tcfg.decimate != "none":
        raise ValueError("factored inference requires the default input "
                         f"pipeline, got in_fraction={tcfg.in_fraction}, "
                         f"decimate={tcfg.decimate!r}")


def _glorot(gen: torch.Generator, fan_in: int, fan_out: int) -> torch.Tensor:
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float32)
    return u * (2 * lim) - lim


def init_csi_mlp(gen: torch.Generator, cfg: SimConfig, tcfg: TrainConfig,
                 device=None) -> Tuple[Params, Params]:
    """Initialize one plane's parameters from ``gen`` (a CPU generator).

    Returns (params, bn_state) with unit BN scale, zero biases, zero
    running mean and unit running variance.
    """
    _, in_dim = model_input_spec(cfg, tcfg)
    dims = (in_dim,) + tuple(tcfg.hidden)
    dense, bn, bn_mean, bn_var = [], [], [], []
    for i, h in enumerate(tcfg.hidden):
        dense.append({"w": _glorot(gen, dims[i], h), "b": torch.zeros(h)})
        if tcfg.use_bn:
            bn.append({"scale": torch.ones(h), "bias": torch.zeros(h)})
            bn_mean.append(torch.zeros(h))
            bn_var.append(torch.ones(h))
    out = {"w": _glorot(gen, dims[-1], cfg.num_carriers),
           "b": torch.zeros(cfg.num_carriers)}
    params = {"dense": dense, "out": out, "bn": bn}
    bn_state = {"mean": bn_mean, "var": bn_var}
    return tree_map(lambda t: t.to(device), params), \
        tree_map(lambda t: t.to(device), bn_state)


def init_stacked(gen: torch.Generator, cfg: SimConfig, tcfg: TrainConfig,
                 device=None) -> Tuple[Params, Params]:
    """Init both planes: every leaf gains a leading axis of size 2
    ([0]=real, [1]=imag)."""
    p0, s0 = init_csi_mlp(gen, cfg, tcfg, device)
    p1, s1 = init_csi_mlp(gen, cfg, tcfg, device)
    stack = lambda a, b: torch.stack([a, b])          # noqa: E731
    return tree_map(stack, p0, p1), tree_map(stack, s0, s1)


def _sequence(like, items):
    """A list, tuple or NamedTuple of ``like``'s type holding ``items``."""
    items = list(items)
    return type(like)(*items) if hasattr(like, "_fields") \
        else type(like)(items)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts, lists and tuples
    (NamedTuples too; jax.tree.map for the structures used here)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return _sequence(tree, (tree_map(fn, t, *(r[i] for r in rest))
                                for i, t in enumerate(tree)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts/lists/tuples in jax ``tree_flatten`` order:
    dict keys sorted, sequences (and a NamedTuple's fields) in order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """The structure of ``like`` with the leaves taken in order from the
    iterable ``leaves`` (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return _sequence(t, (rec(x) for x in t))
        return next(it)

    return rec(like)


def params_from_jax(params, bn_state, device=None) -> Tuple[Params, Params]:
    """The JAX package's stacked pytrees (numpy leaves, leading plane axis
    of size 2) as the port's parameters: float32 tensors on ``device``,
    same structure."""
    conv = lambda a: torch.tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=device)
    return tree_map(conv, params), tree_map(conv, bn_state)


def plane(tree, d: int):
    """One plane's slice of stacked parameters."""
    return tree_map(lambda t: t[d], tree)


def preprocess_signal(cfg: SimConfig, tcfg: TrainConfig,
                      sig: torch.Tensor) -> torch.Tensor:
    """The signal part of the model input: fraction and decimation of
    sig (..., len_sig); a view of sig when neither applies."""
    sig = sig[..., : cfg.len_ltf // int(tcfg.in_fraction)]
    if tcfg.decimate == "max":
        sig = sig.reshape(sig.shape[:-1] + (-1, 2)).amax(-1)
    elif tcfg.decimate == "avg":
        sig = sig.reshape(sig.shape[:-1] + (-1, 2)).mean(-1)
    return sig


def preprocess_input(cfg: SimConfig, tcfg: TrainConfig, sig: torch.Tensor,
                     pilot: torch.Tensor) -> torch.Tensor:
    """Apply fraction/decimation and concat the pilot column.

    sig: (..., len_sig) real plane of the received LTF;
    pilot: (..., num_tx).
    """
    sig = preprocess_signal(cfg, tcfg, sig)
    return torch.cat([sig, pilot.to(sig.dtype)], dim=-1)


def _bn_affine(tcfg: TrainConfig, pp, bb, i: int):
    """Eval-mode BN of layer i as (a, c): BN(h) = h·a + c, float32."""
    a = torch.rsqrt(bb["var"][i] + tcfg.bn_eps) * pp["bn"][i]["scale"]
    c = pp["bn"][i]["bias"] - bb["mean"][i] * a
    return a, c


def _bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bfloat16 (or bf16-valued) operands, float32 result with
    float32 accumulation; a and b are 2-d, or 3-d with one batch axis.
    On the card bf16 tensor-core products with a float32 output
    (``torch.mm``/``torch.bmm`` with ``out_dtype``); on the CPU, which has
    no such kernel, the float32 product of the bf16 values (each product
    exact)."""
    if a.is_cuda:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                  out_dtype=torch.float32)
    return a.float() @ b.float()


class Bf16Dense(torch.autograd.Function):
    """x @ w with both operands rounded to bf16 and a float32 result: JAX's
    ``matmul(x.astype(bf16), w.astype(bf16), preferred_element_type=f32)``.

    The backward keeps JAX's rounding points. ``dot_general``'s transpose
    rules convert each operand's cotangent to that operand's dtype (bf16),
    and the transpose of ``astype`` returns it to the input's dtype, so
    dx = bf16(g @ w_bf16ᵀ) and dw = bf16(x_bf16ᵀ @ g), each then widened.
    On the CPU the incoming cotangent g stays float32 (each product exact,
    as XLA's CPU dot of f32 by bf16). On the card g is rounded to bf16
    first, to run the products on the tensor cores: the card's dx and dw
    differ from the CPU's by that rounding (2⁻⁹ relative a value), as the
    TPU's single-pass bf16 products did.
    """

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, w.dtype)
        return _bf16_product(xb, wb)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _bf16_product(g, wb.mT).to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = _bf16_product(xb.mT, g).to(torch.bfloat16).to(ctx.dtypes[1])
        return dx, dw


def csi_mlp_apply(tcfg: TrainConfig, params: Params, bn_state: Params,
                  x: torch.Tensor, *, train: bool = False,
                  gen: torch.Generator | None = None):
    """The MLP on a preprocessed batch x: one plane's parameters with x
    (batch, in_dim), or stacked parameters (leading plane axis) with x
    (2, batch, in_dim), each plane's product then one batched product.

    Returns (y, bn_state). In train mode BN uses the batch statistics and
    returns the updated running statistics (when the model has BN), and
    dropout (masks from ``gen``, a generator on x's device) runs between
    hidden layers, not after the last one."""
    dense = Bf16Dense.apply if tcfg.matmul_dtype == "bf16" else torch.matmul
    row = lambda t: t.unsqueeze(-2)            # noqa: E731  (..., 1, H)
    new_mean, new_var = [], []
    h = x
    n_hidden = len(params["dense"])
    for i, lyr in enumerate(params["dense"]):
        h = torch.relu(dense(h, lyr["w"]) + row(lyr["b"]))
        if params["bn"]:
            if train:
                mu = h.mean(-2)
                var = h.var(-2, correction=0)          # biased, as jnp.var
                m = tcfg.bn_momentum
                new_mean.append(m * bn_state["mean"][i]
                                + (1 - m) * mu.detach())
                new_var.append(m * bn_state["var"][i]
                               + (1 - m) * var.detach())
            else:
                mu, var = bn_state["mean"][i], bn_state["var"][i]
            h = (h - row(mu)) * torch.rsqrt(row(var) + tcfg.bn_eps)
            h = h * row(params["bn"][i]["scale"]) + row(params["bn"][i]["bias"])
        if train and tcfg.dropout > 0.0 and i < n_hidden - 1:
            keep = 1.0 - tcfg.dropout
            mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
            h = torch.where(mask, h / keep, 0.0)
    y = dense(h, params["out"]["w"]) + row(params["out"]["b"])
    if train and params["bn"]:
        bn_state = {"mean": new_mean, "var": new_var}
    return y, bn_state


def stacked_apply(tcfg: TrainConfig, params: Params, bn_state: Params,
                  x2: torch.Tensor, *, train: bool = False,
                  gen: torch.Generator | None = None):
    """Apply both planes: x2 (2, batch, in_dim) → ((2, batch, C), bn);
    ``train`` and ``gen`` as in ``csi_mlp_apply`` (one draw covers both
    planes)."""
    return csi_mlp_apply(tcfg, params, bn_state, x2, train=train, gen=gen)


def _caster(dtype):
    """t → t in ``dtype``, or t itself when dtype is None."""
    if dtype is None:
        return lambda t: t
    return lambda t: t.to(dtype)


def factored_heads_apply(tcfg: TrainConfig, pp, bb, sig_proj: torch.Tensor,
                         pil_rows: torch.Tensor, sig_len: int,
                         dtype=None) -> torch.Tensor:
    """Everything after the shared layer-1 signal matmul of the factored
    eval-mode MLP: per-head pilot projection + bias, relu, BN affine,
    remaining dense layers, output head.

    Args:
      sig_proj: (S, H) precomputed ``signal @ W1[:sig_len]``.
      pil_rows: (n_heads, num_tx) pilot rows.
      dtype: optional compute dtype (e.g. bfloat16): every product and
        bias runs in it; the eval-mode BN affine is folded in float32,
        then cast.

    Returns:
      (S, n_heads, num_carriers) float32.
    """
    cast = _caster(dtype)
    w1 = cast(pp["dense"][0]["w"])
    pil_proj = pil_rows.to(w1) @ w1[sig_len:]          # (n_heads, H)
    h = torch.relu(cast(sig_proj)[:, None, :] + pil_proj[None, :, :]
                   + cast(pp["dense"][0]["b"]))
    if pp["bn"]:
        a, c = _bn_affine(tcfg, pp, bb, 0)
        h = h * cast(a) + cast(c)
    for i in range(1, len(pp["dense"])):
        h = torch.relu(h @ cast(pp["dense"][i]["w"])
                       + cast(pp["dense"][i]["b"]))
        if pp["bn"]:
            a, c = _bn_affine(tcfg, pp, bb, i)
            h = h * cast(a) + cast(c)
    return (h @ cast(pp["out"]["w"]) + cast(pp["out"]["b"])).float()


def factored_plane_apply(tcfg: TrainConfig, pp, bb, x: torch.Tensor,
                         pil_rows: torch.Tensor, dtype=None) -> torch.Tensor:
    """One plane's factored eval-mode MLP: the (L, H) signal matmul runs
    once per sample and is shared by every pilot head (an exact
    restructuring of the concatenated-input forward pass).

    x: (S, L) real signal plane; dtype: optional compute dtype
    (``factored_heads_apply``). Returns (S, n_heads, num_carriers)
    float32."""
    cast = _caster(dtype)
    L = x.shape[-1]
    sig_proj = cast(x) @ cast(pp["dense"][0]["w"])[:L]  # (S, H)
    return factored_heads_apply(tcfg, pp, bb, sig_proj, pil_rows, L,
                                dtype=dtype)


def _factored_all_pairs(cfg: SimConfig, tcfg: TrainConfig, params, bn_state,
                        planes: torch.Tensor, dtype=None) -> torch.Tensor:
    """Factored all-pairs body: planes (2, S, len_ltf) → (2, S, num_tx,
    num_carriers) float32, computed in float32 or, with ``dtype``, in
    that dtype (``factored_heads_apply``). The plain version of the fused
    factored DNN kernels."""
    require_full_input(tcfg)
    pil = pilot_p_matrix(cfg.num_tx, device=planes.device).T
    return torch.stack([
        factored_plane_apply(tcfg, plane(params, d), plane(bn_state, d),
                             planes[d] if dtype is not None
                             else planes[d].float(), pil, dtype=dtype)
        for d in range(2)])


def predict_all_pairs_planes_flat(cfg: SimConfig, tcfg: TrainConfig, params,
                                  bn_state, planes: torch.Tensor, dtype=None):
    """Factored all-pairs inference from flat planes (2, S, len_ltf) →
    (S, num_tx, num_carriers) complex64; ``dtype`` as in
    ``_factored_all_pairs``."""
    y2 = _factored_all_pairs(cfg, tcfg, params, bn_state, planes, dtype)
    return torch.complex(y2[0], y2[1])


def predict_all_pairs_planes(cfg: SimConfig, tcfg: TrainConfig, params,
                             bn_state, rx_planes: torch.Tensor, dtype=None):
    """Factored all-pairs inference from rx-major planes
    (2, B, num_rx, len_ltf) → (B, num_rx, num_tx, num_carriers)
    complex64; ``dtype`` as in ``_factored_all_pairs``."""
    _, b, nrx, L = rx_planes.shape
    y = predict_all_pairs_planes_flat(cfg, tcfg, params, bn_state,
                                      rx_planes.reshape(2, b * nrx, L), dtype)
    return y.reshape(b, nrx, cfg.num_tx, cfg.num_carriers)


def predict_all_pairs(cfg: SimConfig, tcfg: TrainConfig, params, bn_state,
                      rx: torch.Tensor, dtype=None) -> torch.Tensor:
    """Factored all-pairs inference from time-major received preambles.

    Args:
      rx: (B, len_ltf, num_rx) complex64.
      dtype: optional compute dtype of the MLP (e.g. bfloat16; BN folds
        to a float32 affine either way). Output is always complex64.

    Returns:
      (B, num_carriers, num_tx, num_rx) complex64 (a permuted view).
    """
    b, L, nrx = rx.shape
    sig = rx.transpose(1, 2).reshape(b * nrx, L)
    y = predict_all_pairs_planes_flat(cfg, tcfg, params, bn_state,
                                      torch.stack([sig.real, sig.imag]),
                                      dtype)
    return y.reshape(b, nrx, cfg.num_tx, cfg.num_carriers).permute(0, 3, 2, 1)


def predict_all_pairs_rxmajor(cfg: SimConfig, tcfg: TrainConfig, params,
                              bn_state, rx: torch.Tensor,
                              dtype=None) -> torch.Tensor:
    """``predict_all_pairs`` in the rx-major layout: rx arrives
    antenna-major (B, num_rx, len_ltf) complex64, so the (B·num_rx,
    len_ltf) signal matrix of the factored layer-1 product is a free
    reshape, and the output stays antenna-major.

    Returns:
      (B, num_rx, num_tx, num_carriers) complex64; permute(0, 3, 2, 1)
      gives the ``predict_all_pairs`` layout.
    """
    b, nrx, L = rx.shape
    sig = rx.reshape(b * nrx, L)
    y = predict_all_pairs_planes_flat(cfg, tcfg, params, bn_state,
                                      torch.stack([sig.real, sig.imag]),
                                      dtype)
    return y.reshape(b, nrx, cfg.num_tx, cfg.num_carriers)


def predict_complex(cfg: SimConfig, tcfg: TrainConfig, params, bn_state,
                    sig: torch.Tensor, pilot: torch.Tensor) -> torch.Tensor:
    """Deployment-style complex prediction (inference.py:24-32): the real
    plane through model[0], the imaginary plane through model[1].

    sig: (batch, len_ltf) complex; pilot: (batch, num_tx) real.
    Returns (batch, num_carriers) complex64."""
    xr = preprocess_input(cfg, tcfg, sig.real.float(), pilot)
    xi = preprocess_input(cfg, tcfg, sig.imag.float(), pilot)
    y2, _ = stacked_apply(tcfg, params, bn_state, torch.stack([xr, xi]))
    return torch.complex(y2[0], y2[1])
