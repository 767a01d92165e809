"""The training step in array form: the port of
``mamimo_tpu/train/loop.py:69-85,127-363`` (the optimizer, the batch
update, the in-gather step and its multi-step form).

One optimizer step on a materialized ``(x2, pilot, y2)`` batch
(``make_batch_update``): the optional per-sample RMS normalization, the
per-plane AWGN draw at a random SNR level (the reference's
``changeNoisePower`` callback and GaussianNoise layer,
``massiveMIMO_CSI_prediction_DNN.py:86-102,191-193``), the bf16 storage
cast, the gradients of the stacked real+imag MLP's summed per-plane MSE
by autograd, Adam scaling, ``-lr·u``, and the ``--onlyReal/--onlyImag``
plane mask on both the updates and the BN statistics. Parameters, BN
statistics and optimizer state are updated in place (JAX donates them);
the functions return them as JAX's do.

Randomness comes from an explicit ``torch.Generator`` on the data's
device, where JAX takes a key: each step draws, in order, the two
planes' SNR indices, the AWGN and the dropout masks from it. The
``awgn_rng`` choices ``threefry`` and ``rbg`` are both ``torch.randn``
(JAX's two generators cannot be matched bit for bit in torch); ``rbg_clt``
is the Irwin-Hall(4) sum of four uniform bytes, as in JAX
(``draw_awgn``).

With ``matmul_dtype='f32'`` the products run in true float32 (TF32 off,
``full_f32_matmul``), the JAX package's CPU semantics; on the TPU JAX's
default precision ran them as single-pass bf16.

Not ported here: ``fit``, ``_split_indices`` and ``evaluate_dataset``
(they need ``CSIDataset``) and the sharded step (``constrain``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import (
    preprocess_input,
    stacked_apply,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from mamimo_tpu_torch.train.ckpt import bf16_from_numpy, is_bf16_numpy
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

# the Irwin-Hall(4) byte sum: mean 4·127.5, standard deviation
# sqrt(4·(256² − 1)/12)
_CLT_MEAN = 510.0
_CLT_STD = 147.80054


class AdamState(NamedTuple):
    """Adam's state in optax's ``ScaleByAdamState`` order: ``count`` (an
    int32 scalar tensor), then the first and second moments, each a tree
    of the parameters' structure."""
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByAdam:
    """Adam scaling alone (``optax.scale_by_adam`` of optax 0.2.6, without
    Nesterov): ``update`` turns gradients into ``mu_hat / (sqrt(nu_hat +
    eps_root) + eps)``; the learning rate is applied by the caller.

    ``mu_dtype=torch.bfloat16`` stores the first moment in bf16. As in
    optax the new moment is computed in float32 (``b1·mu`` in bf16 with
    ``b1`` rounded to bf16, which is how JAX multiplies a bf16 array by a
    Python float), its bias-corrected form is taken from that float32
    value, and only then is it cast for storage. The second moment stays
    float32.
    """

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, mu_dtype: torch.dtype | None = None):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype = mu_dtype

    def init(self, params) -> AdamState:
        """Zero moments shaped like ``params``, count 0, on their device."""
        leaf = tree_leaves(params)[0]
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype), params),
            nu=tree_map(torch.zeros_like, params))

    def _first_moment(self, g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """(1 − b1)·g + b1·m, in float32."""
        if m.dtype == torch.bfloat16:
            b1 = float(torch.tensor(self.b1, dtype=torch.bfloat16))
            decayed = (m.float() * b1).to(torch.bfloat16).float()
        else:
            decayed = self.b1 * m
        return (1 - self.b1) * g + decayed

    def update(self, grads, state: AdamState):
        """(updates, state): the scaled updates, a new tree, and the state,
        whose moments are written in place (JAX donates them)."""
        count = torch.where(state.count < torch.iinfo(torch.int32).max,
                            state.count + 1, state.count)
        n = count.float()
        bc1 = 1 - self.b1 ** n
        bc2 = 1 - self.b2 ** n
        updates = []
        for g, m, v in zip(tree_leaves(grads), tree_leaves(state.mu),
                           tree_leaves(state.nu)):
            mu = self._first_moment(g, m)
            nu = (1 - self.b2) * (g * g) + self.b2 * v
            updates.append((mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root)
                                         + self.eps))
            m.copy_(mu)
            v.copy_(nu)
        return tree_unflatten(grads, updates), AdamState(count, state.mu,
                                                         state.nu)


def make_optimizer(tcfg: TrainConfig) -> ScaleByAdam:
    """The training optimizer: Adam scaling, the learning rate applied in
    the step. ``tcfg.opt_dtype='bf16'`` stores the first moment in bf16.
    Not ``torch.optim.Adam``: it cannot keep a bf16 first moment, and its
    own ``lr`` would compose with the step's ``-lr``."""
    return ScaleByAdam(mu_dtype=torch.bfloat16 if tcfg.opt_dtype == "bf16"
                       else None)


def opt_state_from_jax(state, device=None) -> AdamState:
    """optax's ``ScaleByAdamState`` with numpy leaves (or the numpy leaves
    ``train.ckpt.load_checkpoint`` returns in an ``AdamState``) as the
    port's state on ``device``; bfloat16 leaves stay bfloat16, bit for
    bit."""
    def conv(a):
        a = np.asarray(a)
        if is_bf16_numpy(a):
            return bf16_from_numpy(a, device)
        return torch.tensor(a, device=device)

    return AdamState(count=conv(state.count).to(torch.int32),
                     mu=tree_map(conv, state.mu), nu=tree_map(conv, state.nu))


def _plane_mask(tcfg: TrainConfig, device=None) -> torch.Tensor:
    """(2,) update mask for ``--onlyReal``/``--onlyImag``: an excluded
    plane keeps its initial weights and BN statistics."""
    return torch.tensor([1.0 if "real" in tcfg.dims else 0.0,
                         1.0 if "imag" in tcfg.dims else 0.0], device=device)


def _plane(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The (2,) mask shaped to broadcast over a stacked leaf t."""
    return mask.reshape((2,) + (1,) * (t.dim() - 1))


def _mask_updates(updates, mask: torch.Tensor):
    return tree_map(lambda u: u * _plane(mask, u), updates)


def _mask_bn(new_bn, old_bn, mask: torch.Tensor):
    """old + (new − old)·mask: excluded planes keep their statistics."""
    return tree_map(lambda n, o: o + (n - o) * _plane(mask, n), new_bn,
                    old_bn)


def draw_awgn(tcfg: TrainConfig, n_levels: int, shape, gen: torch.Generator):
    """One step's AWGN draw from ``gen`` (on the data's device): the two
    planes' SNR-level indices (2,) int64, then unit-variance noise of
    ``shape``. ``rbg_clt``: each value is (s − 510)/147.80054, s the sum
    of four uniform bytes (unit variance, |x| ≤ 3.4506, integer draws
    only); otherwise a ``torch.randn`` draw."""
    dev = gen.device
    idx = torch.randint(n_levels, (2,), generator=gen, device=dev)
    if tcfg.awgn_rng == "rbg_clt":
        b = torch.randint(0, 256, tuple(shape) + (4,), dtype=torch.uint8,
                          generator=gen, device=dev)
        s = b.sum(-1, dtype=torch.int32)
        return idx, (s.float() - _CLT_MEAN) * (1.0 / _CLT_STD)
    return idx, torch.randn(tuple(shape), generator=gen, device=dev)


def make_batch_update(cfg: SimConfig, tcfg: TrainConfig, avg_sig_pow, opt):
    """The one optimizer step on a materialized (x2, pilot, y2) batch,
    shared by the array and the in-gather steps.

    Returns (update, eval_core):
      update(params, bn_state, opt_state, x2, pilot, y2, gen, lr)
        -> (params, bn_state, opt_state, per_plane_loss (2,)); params,
        bn_state and opt_state are updated in place.
      eval_core(params, bn_state, x2, pilot, y2) -> per-plane MSE (2,).
    ``update.loss_and_grads(params, bn_state, x2, pilot, y2, gen)`` is the
    step's forward and backward on a batch already normalized, noised and
    cast: (per_plane_loss, new_bn, grads).

    x2 (2, bs, len_ltf) and y2 (2, bs, C) float32, pilot (bs, num_tx),
    all on the parameters' device; ``avg_sig_pow`` a float or a tensor.
    """
    levels = torch.tensor(tcfg.awgn_snr_levels, dtype=torch.float32)
    on_device = {}

    def _constants(dev):
        """(SNR levels, plane mask) on dev, copied there once: a copy from
        the host in every step would wait for the card's queue."""
        if dev not in on_device:
            on_device[dev] = (levels.to(dev), _plane_mask(tcfg, dev))
        return on_device[dev]

    def _rms_norm(x2, y2):
        """tcfg.input_norm='rms': each sample's signal and label divided by
        the signal's complex RMS, a = sqrt(Σ_planes mean_L x² + 1e-30)."""
        if tcfg.input_norm != "rms":
            return x2, y2
        a = torch.sqrt((x2 * x2).mean(-1).sum(0) + 1e-30)[None, :, None]
        return x2 / a, y2 / a

    def _store_cast(x2, pilot):
        """matmul_dtype='bf16': the batch stored in bf16 at the gather."""
        if tcfg.matmul_dtype == "bf16":
            return x2.to(torch.bfloat16), pilot.to(torch.bfloat16)
        return x2, pilot

    def _model_input(x2, pilot):
        return preprocess_input(cfg, tcfg, x2, torch.stack([pilot, pilot]))

    def loss_and_grads(params, bn_state, x2, pilot, y2, gen):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            pred, new_bn = stacked_apply(tcfg, live, bn_state,
                                         _model_input(x2, pilot), train=True,
                                         gen=gen)
            per_dim = ((pred - y2) ** 2).mean(dim=(1, 2))
            grads = torch.autograd.grad(per_dim.sum(), tree_leaves(live))
        return per_dim.detach(), new_bn, tree_unflatten(params, grads)

    def update(params, bn_state, opt_state, x2, pilot, y2, gen, lr):
        dev_levels, pmask = _constants(x2.device)
        with full_f32_matmul():
            x2, y2 = _rms_norm(x2, y2)
            if tcfg.method == "default_snr":
                # independent per-plane SNR draw (two independent Keras fits)
                lev_idx, noise = draw_awgn(tcfg, len(levels), x2.shape, gen)
                lev = dev_levels[lev_idx]
                npow = avg_sig_pow / (10.0 ** (lev / 10.0))       # (2,)
                std = torch.sqrt(npow) / math.sqrt(2.0)
                x2 = x2 + noise * std[:, None, None]
            x2, pilot = _store_cast(x2, pilot)
            per_dim, new_bn, grads = loss_and_grads(params, bn_state, x2,
                                                    pilot, y2, gen)
            with torch.no_grad():
                updates, opt_state = opt.update(grads, opt_state)
                updates = _mask_updates(tree_map(lambda u: -lr * u, updates),
                                        pmask)
                for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                    p.add_(u)
                for o, n in zip(tree_leaves(bn_state),
                                tree_leaves(_mask_bn(new_bn, bn_state,
                                                     pmask))):
                    o.copy_(n)
        return params, bn_state, opt_state, per_dim

    def eval_core(params, bn_state, x2, pilot, y2):
        with torch.no_grad(), full_f32_matmul():
            x2, y2 = _rms_norm(x2, y2)
            x2, pilot = _store_cast(x2, pilot)
            pred, _ = stacked_apply(tcfg, params, bn_state,
                                    _model_input(x2, pilot))
            return ((pred - y2) ** 2).mean(dim=(1, 2))

    update.loss_and_grads = loss_and_grads
    return update, eval_core


def make_array_train_step(cfg: SimConfig, tcfg: TrainConfig, avg_sig_pow,
                          opt):
    """Train and eval steps on materialized (x2, pilot, y2) batches (the
    host-streaming path of the JAX package): ``make_batch_update``'s
    (update, eval_core)."""
    return make_batch_update(cfg, tcfg, avg_sig_pow, opt)


def _gather_batch(cfg: SimConfig, data, idx: torch.Tensor):
    """Sample indices → ((2, bs, L) planes, (bs, T) pilots, (2, bs, C)
    labels), gathered on the data's device from ``data`` = {"rx": (B, L,
    R) complex64, "h": (B, C, T, R) complex64, "P": (T, T) float32}.

    Ordering contract: idx = p·(R·T) + r·T + t
    (create_massiveMIMO_CSIest_dnn_dataset.py:62).
    """
    per_pkt = cfg.num_tx * cfg.num_rx
    p = idx // per_pkt
    rem = idx % per_pkt
    r = rem // cfg.num_tx
    t = rem % cfg.num_tx
    sig = data["rx"][p, :, r]                        # (bs, L) complex
    pilot = data["P"].T[t]                           # (bs, T)
    y = data["h"][p, :, t, r]                        # (bs, C) complex
    return (torch.stack([sig.real, sig.imag]), pilot,
            torch.stack([y.real, y.imag]))


def make_train_step(cfg: SimConfig, tcfg: TrainConfig, data, avg_sig_pow,
                    opt):
    """Steps that gather their batch on the device from ``data`` (as in
    ``_gather_batch``).

    Returns (train_step, eval_step):
      train_step(params, bn_state, opt_state, idx (bs,), gen, lr)
        -> (params, bn_state, opt_state, per_plane_loss (2,));
      train_step.multi(params, bn_state, opt_state, idx2 (K, bs), gen, lr)
        -> the same after K steps, one a row of idx2, all drawing from
        ``gen`` in turn, with the mean of the K per-plane losses (JAX's
        ``lax.scan`` over K keys);
      eval_step(params, bn_state, idx) -> per-plane MSE (2,);
      eval_step.multi(params, bn_state, idx2) -> the sum over the rows.
    """
    update, eval_core = make_batch_update(cfg, tcfg, avg_sig_pow, opt)

    def train_step(params, bn_state, opt_state, idx, gen, lr):
        x2, pilot, y2 = _gather_batch(cfg, data, idx)
        return update(params, bn_state, opt_state, x2, pilot, y2, gen, lr)

    def train_multi(params, bn_state, opt_state, idx2, gen, lr):
        per = []
        for idx in idx2:
            params, bn_state, opt_state, per_dim = train_step(
                params, bn_state, opt_state, idx, gen, lr)
            per.append(per_dim)
        return params, bn_state, opt_state, torch.stack(per).mean(0)

    def eval_step(params, bn_state, idx):
        return eval_core(params, bn_state, *_gather_batch(cfg, data, idx))

    def eval_multi(params, bn_state, idx2):
        return torch.stack([eval_step(params, bn_state, idx)
                            for idx in idx2]).sum(0)

    train_step.multi = train_multi
    eval_step.multi = eval_multi
    return train_step, eval_step
