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

``fit`` (``mamimo_tpu/train/loop.py:366-1042``) trains on one device in
the JAX package's three single-card modes: the dataset in device memory
(``make_train_step``, ``steps_per_call`` steps a ``.multi`` call), host
streaming (``make_array_train_step`` fed by the native loader's
double-buffered prefetch) and window streaming (whole packets shipped
once a window, batches gathered from the resident window). The batch
order is JAX's (``np.random.default_rng(tcfg.seed)``); the step noise
comes from ``step_generator(seed, step)`` where JAX folds the step into
a key, so a run resumed at an epoch boundary draws what the
uninterrupted run drew. ``evaluate_dataset`` predicts a whole dataset.

``make_batch_update``'s ``constrain`` hook takes a mesh's layout
(``parallel/sharded.py::make_sharded_train_step``), and ``fit(mesh=...)``
runs the three modes on it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import time
from typing import TYPE_CHECKING, Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import (
    init_stacked,
    params_from_jax,
    preprocess_input,
    stacked_apply,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from mamimo_tpu_torch.train.ckpt import (
    bf16_from_numpy,
    is_bf16_numpy,
    load_checkpoint,
    save_checkpoint,
)
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

if TYPE_CHECKING:
    from mamimo_tpu_torch.pipeline.dataset import CSIDataset

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


class _OneDevice:
    """``make_batch_update``'s layout without a mesh: the whole batch on
    the parameters' device, one rank (0). The mesh's layout is
    ``parallel/sharded.py::_MeshLayout``; both give ``split`` (the batch
    as {rank: (x2, pilot, y2, rows)}), ``batch`` (the global batch size of
    split parts), ``view`` (a rank's tree),
    ``with_state`` (a rank's new optimizer state put back),
    ``loss_and_grads`` and ``eval_loss`` on the ranks' model inputs."""

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg

    def split(self, x2, pilot, y2):
        return {0: (x2, pilot, y2, slice(None))}

    def batch(self, parts) -> int:
        return parts[0][0].shape[1]

    def view(self, tree, r):
        return tree

    def with_state(self, opt_state, r, state):
        return state

    def loss_and_grads(self, params, bn_state, inputs, gen):
        (xin, y2), = inputs.values()
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            pred, new_bn = stacked_apply(self.tcfg, live, bn_state, xin,
                                         train=True, gen=gen)
            per_dim = ((pred - y2) ** 2).mean(dim=(1, 2))
            grads = torch.autograd.grad(per_dim.sum(), tree_leaves(live))
        return (per_dim.detach(), {0: new_bn},
                {0: tree_unflatten(params, grads)})

    def eval_loss(self, params, bn_state, inputs):
        (xin, y2), = inputs.values()
        pred, _ = stacked_apply(self.tcfg, params, bn_state, xin)
        return ((pred - y2) ** 2).mean(dim=(1, 2))


def make_batch_update(cfg: SimConfig, tcfg: TrainConfig, avg_sig_pow, opt,
                      constrain=None):
    """The one optimizer step on a materialized (x2, pilot, y2) batch,
    shared by the array, the in-gather and the sharded steps.

    Returns (update, eval_core):
      update(params, bn_state, opt_state, x2, pilot, y2, gen, lr)
        -> (params, bn_state, opt_state, per_plane_loss (2,)); params,
        bn_state and opt_state are updated in place.
      eval_core(params, bn_state, x2, pilot, y2) -> per-plane MSE (2,).
    ``update.loss_and_grads(params, bn_state, x2, pilot, y2, gen)`` is the
    one-device step's forward and backward on a batch already
    normalized, noised and cast: (per_plane_loss, new_bn, grads).
    ``update.parts`` and ``eval_core.parts`` take the batch already split
    ({rank: (x2, pilot, y2, rows)}, the rows of the global batch each rank
    holds) in place of (x2, pilot, y2).

    constrain: the mesh's layout (``parallel/sharded.py::
    make_sharded_train_step``), JAX's hook: the batch is split onto the
    ranks (JAX places sharding constraints there) and the forward and
    backward run over them; None: one device. The draws are the same
    either way: the SNR indices, the AWGN at the global batch's shape and
    the dropout masks at the global hidden shapes, from ``gen``, each rank
    then taking its rows (and columns).

    x2 (2, bs, len_ltf) and y2 (2, bs, C) float32, pilot (bs, num_tx),
    on the parameters' device (with a mesh: any device);
    ``avg_sig_pow`` a float or a tensor.
    """
    levels = torch.tensor(tcfg.awgn_snr_levels, dtype=torch.float32)
    layout = constrain if constrain is not None else _OneDevice(tcfg)
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
        per_dim, new_bn, grads = _OneDevice(tcfg).loss_and_grads(
            params, bn_state, {0: (_model_input(x2, pilot), y2)}, gen)
        return per_dim, new_bn[0], grads[0]

    def _noise(parts, gen):
        """The step's AWGN at the global batch's shape and its per-plane
        std, or (None, None)."""
        if tcfg.method != "default_snr":
            return None, None
        x2 = next(iter(parts.values()))[0]
        shape = (2, layout.batch(parts), x2.shape[-1])
        dev_levels, _ = _constants(gen.device)
        # independent per-plane SNR draw (two independent Keras fits)
        lev_idx, noise = draw_awgn(tcfg, len(levels), shape, gen)
        lev = dev_levels[lev_idx]
        npow = avg_sig_pow / (10.0 ** (lev / 10.0))           # (2,)
        return noise, torch.sqrt(npow) / math.sqrt(2.0)

    def update_parts(params, bn_state, opt_state, parts, gen, lr):
        with full_f32_matmul():
            noise, std = _noise(parts, gen)
            inputs = {}
            for r, (x2, pilot, y2, rows) in parts.items():
                x2, y2 = _rms_norm(x2, y2)
                if noise is not None:
                    dev = x2.device
                    x2 = x2 + noise[:, rows].to(dev) \
                        * std.to(dev)[:, None, None]
                x2, pilot = _store_cast(x2, pilot)
                inputs[r] = (_model_input(x2, pilot), y2)
            per_dim, new_bn, grads = layout.loss_and_grads(
                params, bn_state, inputs, gen)
            with torch.no_grad():
                for r in inputs:
                    p_r, bn_r = layout.view(params, r), \
                        layout.view(bn_state, r)
                    _, pmask = _constants(inputs[r][1].device)
                    updates, state = opt.update(
                        grads[r], layout.view(opt_state, r))
                    opt_state = layout.with_state(opt_state, r, state)
                    updates = _mask_updates(
                        tree_map(lambda u: -lr * u, updates), pmask)
                    for p, u in zip(tree_leaves(p_r), tree_leaves(updates)):
                        p.add_(u)
                    for o, n in zip(tree_leaves(bn_r),
                                    tree_leaves(_mask_bn(new_bn[r], bn_r,
                                                         pmask))):
                        o.copy_(n)
        return params, bn_state, opt_state, per_dim

    def update(params, bn_state, opt_state, x2, pilot, y2, gen, lr):
        return update_parts(params, bn_state, opt_state,
                            layout.split(x2, pilot, y2), gen, lr)

    def eval_parts(params, bn_state, parts):
        with torch.no_grad(), full_f32_matmul():
            inputs = {}
            for r, (x2, pilot, y2, _) in parts.items():
                x2, y2 = _rms_norm(x2, y2)
                x2, pilot = _store_cast(x2, pilot)
                inputs[r] = (_model_input(x2, pilot), y2)
            return layout.eval_loss(params, bn_state, inputs)

    def eval_core(params, bn_state, x2, pilot, y2):
        return eval_parts(params, bn_state, layout.split(x2, pilot, y2))

    update.loss_and_grads = loss_and_grads
    update.parts = update_parts
    eval_core.parts = eval_parts
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


class TrainResult(NamedTuple):
    """What ``fit`` returns: the best weights (per plane, restored), the
    BN statistics that go with them, the per-epoch history, the best
    validation loss per plane and the number of epochs run."""
    params: Any
    bn_state: Any
    history: Dict[str, list]
    best_val: np.ndarray      # (2,) best val loss per plane
    epochs_ran: int


def _resolve(device) -> torch.device:
    """``device``, None meaning the card (raises without one)."""
    from mamimo_tpu_torch.models.predictor import resolve_device

    return resolve_device("cuda" if device is None else device)


def _seeded(device, seed: int, n: int, stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, n) alone through
    numpy's SeedSequence (63 bits), as ``pipeline.dataset.
    packet_generator``; ``stream`` keeps the training steps' and the
    evaluation's streams apart from the packets'."""
    s = np.random.SeedSequence([seed, n], spawn_key=(stream,)) \
        .generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        ((int(s[0]) << 32) | int(s[1])) & ((1 << 63) - 1))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step ``step`` (counted from the run's
    start, epoch·steps_per_epoch + s; a ``.multi`` group draws in turn
    from its first step's), JAX's ``fold_in(k_train, step)``."""
    return _seeded(device, seed, step, 1)


def _device_data(ds: "CSIDataset", device):
    """The training container on ``device``: {"rx": (B, L, R) and "h":
    (B, C, T, R) complex64, "P": (T, T) float32}, as ``_gather_batch``
    reads it."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.complex64)) \
            .to(device)

    return {"rx": put(ds.rx), "h": put(ds.h_ls),
            "P": torch.as_tensor(ds.pilot_matrix(), dtype=torch.float32,
                                 device=device)}


def _split_indices(ds: "CSIDataset", tcfg: TrainConfig):
    """By-packet tail validation split (massiveMIMO_dataGenerator.py:47-55):
    (train sample indices, val sample indices)."""
    per_pkt = ds.cfg.num_tx * ds.cfg.num_rx
    n_pkts = ds.num_packets
    n_val_pkts = int(np.floor(n_pkts * tcfg.val_train_ratio))
    if tcfg.val_train_ratio > 0 and n_val_pkts == 0 and n_pkts >= 2:
        n_val_pkts = 1   # an empty val split would give NaN val losses
    n_train = (n_pkts - n_val_pkts) * per_pkt
    all_idx = np.arange(ds.num_samples)
    if tcfg.val_same_train:
        return all_idx, all_idx
    return all_idx[:n_train], all_idx[n_train:]


def _raw_matches(path: str, ds: "CSIDataset") -> bool:
    """True iff an existing raw container holds exactly this dataset (its
    dimensions and its first and last samples), so that a stale file in
    the workdir is never trained on."""
    from mamimo_tpu_torch.data.native_loader import NativeBatchLoader

    if not os.path.exists(path):
        return False
    try:
        with NativeBatchLoader(path) as ld:
            if ((ld.B, ld.L, ld.R, ld.C, ld.T)
                    != (ds.num_packets, ds.cfg.len_ltf, ds.cfg.num_rx,
                        ds.cfg.num_carriers, ds.cfg.num_tx)):
                return False
            sig, _ = ld.gather(np.asarray([0, ld.num_samples - 1]))
    except (OSError, ValueError, IndexError):
        return False
    return bool(np.array_equal(sig[0, 0], np.real(ds.rx[0, :, 0]))
                and np.array_equal(sig[1, 0], np.real(ds.rx[-1, :, -1])))


def _set_plane(best_leaf: torch.Tensor, new_leaf: torch.Tensor,
               d: int) -> torch.Tensor:
    """A copy of the stacked leaf best_leaf with plane d taken from
    new_leaf."""
    out = best_leaf.clone()
    out[d] = new_leaf[d]
    return out


def _plot_history(workdir: str, history: Dict[str, list]) -> None:
    """Loss-curve PNGs (massiveMIMO_CSI_prediction_DNN.py:321-328); none
    where matplotlib is absent."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    for d in ("real", "imag"):
        plt.figure()
        plt.semilogy(history[f"loss_{d}"], label="train")
        plt.semilogy(history[f"val_loss_{d}"], label="validation")
        plt.title("model loss for CSI mapping")
        plt.ylabel("loss")
        plt.xlabel("epoch")
        plt.legend(loc="upper left")
        plt.savefig(os.path.join(workdir, f"{d}_loss_prediction.png"))
        plt.close()


def _state_on(params, bn_state, device):
    """Parameters and BN statistics as float32 tensors on ``device``, from
    tensors or from the numpy leaves ``load_checkpoint`` gives."""
    if isinstance(tree_leaves(params)[0], torch.Tensor):
        return (tree_map(lambda t: t.to(device), params),
                tree_map(lambda t: t.to(device), bn_state))
    return params_from_jax(params, bn_state, device=device)


class _Stream:
    """Host streaming (``fit(host_stream=True)``): batches gathered from
    the raw container by the native loader and copied to the device, the
    next batch prefetched on a C++ thread while the device runs this one
    (JAX ``loop.py:789-828``)."""

    def __init__(self, cfg, loader, val_loader, pilot_rows, device):
        self.cfg, self.loader, self.val_loader = cfg, loader, val_loader
        self.pilot_rows, self.device = pilot_rows, device
        self.pending = None          # the indices of the prefetch in flight

    def arrays(self, sig, y, idx_np):
        """Loader planes (n, 2, L), (n, 2, C) → the step's (x2 (2, n, L),
        pilot (n, T), y2 (2, n, C)) on the device."""
        dev = self.device
        t = idx_np % self.cfg.num_tx
        return (torch.from_numpy(sig).to(dev).transpose(0, 1).contiguous(),
                torch.from_numpy(self.pilot_rows[t]).to(dev),
                torch.from_numpy(y).to(dev).transpose(0, 1).contiguous())

    def train_batch(self, idx_np, idx_next):
        """The batch of idx_np (the prefetched one if it is that batch),
        and the prefetch of idx_next started."""
        ld = self.loader
        if self.pending is not None:
            sig, y = ld.wait()
            hit = np.array_equal(self.pending, idx_np)
            self.pending = None
            if not hit:
                sig, y = ld.gather(idx_np)
        else:
            sig, y = ld.gather(idx_np)
        if idx_next is not None:
            ld.prefetch(idx_next)
            self.pending = np.asarray(idx_next)
        return self.arrays(sig, y, idx_np)

    def val_batch(self, idx_np):
        return self.arrays(*self.val_loader.gather(idx_np), idx_np)


class _Windows:
    """Window streaming (``fit(stream_window_packets=N)``, JAX
    ``loop.py:500-621``): each epoch shuffles the training packets,
    ships them to the device N at a time (``gather_packets``, one copy of
    each preamble) into ``data``, and the batches are gathered from the
    resident window with the samples shuffled inside it (a two-level
    shuffle); each window's ragged batch tail is dropped. The val pass
    walks windows of the val corpus, or of the packet-level tail split."""

    def __init__(self, cfg, tcfg, train_ds, val_ds, train_idx, loader,
                 val_loader, data, window, rng, device):
        self.cfg, self.data, self.rng, self.device = cfg, data, rng, device
        self.loader, self.val_loader = loader, val_loader
        self.has_val_ds = val_ds is not None
        self.per_pkt = per = cfg.num_tx * cfg.num_rx
        n_pkts = train_ds.num_packets
        self.n_train_pkts = len(train_idx) // per
        if val_ds is None:
            if tcfg.val_same_train or self.n_train_pkts >= n_pkts:
                raise ValueError("window streaming needs a val_ds or a "
                                 "non-empty packet-level tail val split")
            n_val_pkts, self.val_base = n_pkts - self.n_train_pkts, \
                self.n_train_pkts
        else:
            n_val_pkts, self.val_base = val_ds.num_packets, 0
        self.n_val_pkts = n_val_pkts
        self.P = P = min(int(window), self.n_train_pkts)
        self.bs = bs = tcfg.batch_size
        if (P * per) % bs:
            raise ValueError("window samples must be a batch multiple so "
                             f"batches never straddle windows ({P}*{per} % "
                             f"{bs})")
        self.pos = np.full(max(n_pkts, self.val_base + n_val_pkts), -1,
                           np.int64)
        self.src = None
        self.on_load = None          # called with ``data`` after each load
        self.sched = {"train": [], "val": []}
        self.steps = sum((min(P, self.n_train_pkts - k) * per) // bs
                         for k in range(0, self.n_train_pkts, P))
        vparts = []
        for k in range(0, n_val_pkts, P):
            vs = np.arange((self.val_base + k) * per,
                           (self.val_base + min(k + P, n_val_pkts)) * per)
            vparts.append(vs[: (len(vs) // bs) * bs])
        self.val_idx = (np.concatenate(vparts) if vparts
                        else np.empty(0, np.int64))
        if len(self.val_idx) == 0:
            # val smaller than a batch: one short batch of the first window
            self.val_idx = np.arange(
                self.val_base * per,
                (self.val_base + min(P, n_val_pkts)) * per)

    def _load(self, pkts, which):
        ld = self.val_loader if (which == "val" and self.has_val_ds) \
            else self.loader
        sig, y = ld.gather_packets(pkts)
        sig = torch.from_numpy(sig).to(self.device)
        y = torch.from_numpy(y).to(self.device)
        self.data["rx"] = torch.complex(sig[0], sig[1])
        self.data["h"] = torch.complex(y[0], y[1])
        self.src = which if self.has_val_ds else "train"
        self.pos[:] = -1
        self.pos[pkts] = np.arange(len(pkts))
        if self.on_load is not None:
            self.on_load(self.data)

    def local(self, idx_np, which):
        """The window-local sample indices of idx_np on the device, after
        loading the windows of the schedule until they are resident."""
        return torch.as_tensor(self.local_np(idx_np, which),
                               device=self.device)

    def local_np(self, idx_np, which):
        """``local`` as a numpy array."""
        src = which if self.has_val_ds else "train"
        p = idx_np // self.per_pkt
        if not (self.src == src and np.all(self.pos[p] >= 0)):
            dq = self.sched[which]
            if not dq and which == "val":
                vp = np.arange(self.val_base, self.val_base + self.n_val_pkts)
                dq.extend(vp[k:k + self.P] for k in range(0, len(vp), self.P))
            while True:
                if not dq:
                    raise RuntimeError("window schedule out of sync with "
                                       "the batch order")
                self._load(dq.pop(0), which)
                if np.all(self.pos[p] >= 0):
                    break
        return self.pos[p] * self.per_pkt + idx_np % self.per_pkt

    def perm(self):
        """One epoch's sample order: packets shuffled globally, samples
        within each window; each window's ragged batch tail dropped."""
        self.sched["train"].clear()
        per, P, bs = self.per_pkt, self.P, self.bs
        pkt_perm = self.rng.permutation(self.n_train_pkts)
        parts = []
        for k in range(0, self.n_train_pkts, P):
            w = pkt_perm[k:k + P]
            self.sched["train"].append(w)
            s = (w[:, None] * per + np.arange(per)[None, :]).ravel()
            s = s[self.rng.permutation(len(s))]
            parts.append(s[: (len(s) // bs) * bs])
        return np.concatenate(parts)


def _mesh_runtime(cfg, tcfg, mesh, train_ds, val_ds, train_idx, val_idx,
                  avg_sig_pow, loader, val_loader, window, rng_host,
                  host_stream):
    """fit's three modes on a mesh (``make_sharded_train_step``): (run_train,
    run_val, the window scheduler or None, val_idx)."""
    from mamimo_tpu_torch.parallel.sharded import (
        make_sharded_train_step,
        replicate,
    )

    dev = mesh.first
    _, sh_step = make_sharded_train_step(cfg, tcfg, mesh,
                                         avg_sig_pow=avg_sig_pow)
    wins = None
    if window:
        # each window replicated on the ranks' devices as it is loaded,
        # the batches gathered from it rank by rank
        wdata = {"P": torch.as_tensor(train_ds.pilot_matrix(),
                                      dtype=torch.float32, device=dev)}
        wins = _Windows(cfg, tcfg, train_ds, val_ds, train_idx, loader,
                        val_loader, wdata, window, rng_host, dev)
        rep = {}
        wins.on_load = lambda data: rep.update(replicate(mesh, data))
        val_idx = wins.val_idx

        def run_train(params, bn_state, opt_state, idx_np, gen, lr,
                      idx_next=None):
            li = wins.local_np(idx_np, "train")
            return sh_step.gather(params, bn_state, opt_state, rep, li, gen,
                                  lr)

        def run_val(params, bn_state, idx_np):
            return sh_step.gather_eval(params, bn_state, rep,
                                       wins.local_np(idx_np, "val"))
    elif host_stream:
        stream = _Stream(cfg, loader, val_loader,
                         np.ascontiguousarray(train_ds.pilot_matrix().T,
                                              np.float32), dev)

        def run_train(params, bn_state, opt_state, idx_np, gen, lr,
                      idx_next=None):
            x2, pilot, y2 = stream.train_batch(idx_np, idx_next)
            return sh_step(params, bn_state, opt_state, x2, pilot, y2, gen,
                           lr)

        def run_val(params, bn_state, idx_np):
            return sh_step.array_eval(params, bn_state,
                                      *stream.val_batch(idx_np))
    else:
        data = replicate(mesh, _device_data(train_ds, "cpu"))
        val_data = data if val_ds is None else replicate(
            mesh, _device_data(val_ds, "cpu"))

        def run_train(params, bn_state, opt_state, idx_np, gen, lr,
                      idx_next=None):
            return sh_step.gather(params, bn_state, opt_state, data, idx_np,
                                  gen, lr)

        def run_val(params, bn_state, idx_np):
            return sh_step.gather_eval(params, bn_state, val_data, idx_np)
    return run_train, run_val, wins, val_idx


def fit(cfg: SimConfig, tcfg: TrainConfig, train_ds: "CSIDataset",
        val_ds: Optional["CSIDataset"] = None,
        workdir: Optional[str] = None, verbose: bool = True,
        resume: bool = False, host_stream: bool = False,
        stream_window_packets: Optional[int] = None, mesh=None,
        device=None) -> TrainResult:
    """Train the stacked real/imag CSI MLP on one device; returns the best
    weights, restored per plane (Keras's EarlyStopping with
    restore_best_weights, ``massiveMIMO_CSI_prediction_DNN.py:283-328``).

    Each epoch: the training steps (batch order from
    ``np.random.default_rng(tcfg.seed)``, JAX's), the val pass, the
    per-plane best tracking, ReduceLROnPlateau on the summed val loss
    (``plateau_patience``, ``plateau_factor``, floor ``lr·
    min_lr_factor``), and, with ``workdir``, the ``last`` checkpoint with
    the optimizer state, ``history.json`` and, on improvement, ``best``.
    Training stops early once both planes went ``early_stop_patience``
    epochs without improving.

    Args:
      val_ds: the validation corpus; None takes the packet-level tail of
        train_ds (``_split_indices``).
      resume: continue from ``<workdir>/last`` (epoch, optimizer state,
        lr and plateau counters, best weights, history); the shuffle is
        fast-forwarded, so a run resumed at an epoch boundary equals the
        uninterrupted run.
      host_stream: stream batches from the raw container
        (``<workdir or a temporary dir>/train.raw``) through the native
        loader instead of holding the dataset on the device.
      stream_window_packets: with host_stream, window streaming
        (``_Windows``); (window·T·R) % batch_size must be 0.
      mesh: a ``parallel.mesh.Mesh`` with a 'data' and optionally a
        'model' axis: the step runs DP+TP over it
        (``parallel/sharded.py::make_sharded_train_step``) in each of the
        three modes: in-HBM (the dataset replicated on each rank's
        device, batches gathered rank by rank), host_stream (the loader's
        batches split onto the data ranks) and window streaming (each
        window replicated, then gathered rank by rank); resume re-places
        the checkpointed arrays with ``param_shardings``. On a mesh that
        spans processes every process passes the same arguments, and
        only process 0 writes the checkpoints and history.json (from
        gathered host copies). ``device`` is then unused.
      device: where it trains; None means the card, and raises without
        one (the tests pass "cpu").

    The initial weights come from ``init_stacked`` with a CPU generator
    seeded with tcfg.seed; the step noise from ``step_generator`` (on the
    mesh's first device), the same schedule with a mesh or without.
    """
    if mesh is not None:
        from mamimo_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"fit(mesh=...) takes a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if "data" not in mesh.axis_names:
            raise ValueError(f"fit(mesh=...) needs a 'data' axis, got "
                             f"{mesh.axis_names}")
    dev = mesh.first if mesh is not None else _resolve(device)
    with contextlib.ExitStack() as stack:
        return _fit(cfg, tcfg, train_ds, val_ds, workdir, verbose, resume,
                    host_stream, stream_window_packets, dev, stack, mesh)


def _fit(cfg, tcfg, train_ds, val_ds, workdir, verbose, resume, host_stream,
         window, dev, stack, mesh) -> TrainResult:
    from mamimo_tpu_torch.data.native_loader import NativeBatchLoader
    from mamimo_tpu_torch.parallel.sharded import gather_tree, place_state

    windowed = bool(host_stream and window)
    loader = val_loader = None
    shared = mesh is not None and mesh.num_processes > 1
    writer = mesh is None or mesh.process_index == 0
    verbose = verbose and writer
    if host_stream:
        raw_dir = workdir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="mamimo_raw_"))
        os.makedirs(raw_dir, exist_ok=True)

        def open_raw(name, ds):
            path = os.path.join(raw_dir, name)
            if shared and workdir is not None:
                # one writer of the container the processes share
                if writer and not _raw_matches(path, ds):
                    ds.save_raw(path)
                torch.distributed.barrier()
            elif not _raw_matches(path, ds):
                ds.save_raw(path)
            return stack.enter_context(NativeBatchLoader(path))

        loader = open_raw("train.raw", train_ds)
        if verbose:
            print(f"[fit] host-streaming batches via the native C++ loader: "
                  f"{loader.path}")
        if val_ds is not None:
            val_loader = open_raw("val.raw", val_ds)
        else:
            val_loader = loader
    if val_ds is not None:
        train_idx = np.arange(train_ds.num_samples)
        val_idx = np.arange(val_ds.num_samples)
    else:
        train_idx, val_idx = _split_indices(train_ds, tcfg)

    # the average real-plane signal power of the training inputs (the
    # first-batch estimate of massiveMIMO_CSI_prediction_DNN.py:298-302
    # over the whole set); 1/2 by construction under the rms norm
    per_pkt = cfg.num_tx * cfg.num_rx
    train_pkts = max(1, len(train_idx) // per_pkt)
    if tcfg.input_norm == "rms":
        avg_sig_pow = 0.5
    else:
        avg_sig_pow = float(np.mean(np.real(train_ds.rx[:train_pkts]) ** 2))

    # the state is made (or read) where one device would hold it, then
    # placed on the mesh with param_shardings
    home = torch.device("cpu") if mesh is not None else dev
    params, bn_state = init_stacked(torch.Generator().manual_seed(tcfg.seed),
                                    cfg, tcfg, device=home)
    opt = make_optimizer(tcfg)
    opt_state = opt.init(params)

    start_epoch, extra, resumed_best = 0, {}, None
    if resume and workdir is not None and os.path.exists(
            os.path.join(workdir, "last.json")):
        ck = load_checkpoint(os.path.join(workdir, "last"),
                             like_opt_state=opt_state)
        params, bn_state = _state_on(ck["params"], ck["bn_state"], home)
        if "opt_state" in ck:
            opt_state = opt_state_from_jax(ck["opt_state"], home)
        extra = ck.get("extra", {})
        start_epoch = int(extra.get("epoch", 0))
        if verbose:
            print(f"[fit] resuming from epoch {start_epoch}")
        # the true best weights, so the final 'best' cannot regress to the
        # last epoch's
        if os.path.exists(os.path.join(workdir, "best.json")):
            bck = load_checkpoint(os.path.join(workdir, "best"))
            resumed_best = _state_on(bck["params"], bck["bn_state"], home)

    def host(tree):
        """The state as one device holds it (gathered from the mesh)."""
        return tree if mesh is None else gather_tree(tree)

    rng_host = np.random.default_rng(tcfg.seed)
    val_multi = None
    if mesh is not None:
        params, bn_state, opt_state = place_state(mesh, params, bn_state,
                                                  opt_state)
        run_train, run_val, wins, val_idx = _mesh_runtime(
            cfg, tcfg, mesh, train_ds, val_ds, train_idx, val_idx,
            avg_sig_pow, loader, val_loader, window if windowed else None,
            rng_host, host_stream)
    elif windowed:
        wdata = {"P": torch.as_tensor(train_ds.pilot_matrix(),
                                      dtype=torch.float32, device=dev)}
        wins = _Windows(cfg, tcfg, train_ds, val_ds, train_idx, loader,
                        val_loader, wdata, window, rng_host, dev)
        w_step, w_eval = make_train_step(cfg, tcfg, wdata, avg_sig_pow, opt)
        val_idx = wins.val_idx

        def run_train(params, bn_state, opt_state, idx_np, gen, lr,
                      idx_next=None):
            return w_step(params, bn_state, opt_state,
                          wins.local(idx_np, "train"), gen, lr)

        def run_val(params, bn_state, idx_np):
            return w_eval(params, bn_state, wins.local(idx_np, "val"))
    elif host_stream:
        a_step, a_eval = make_array_train_step(cfg, tcfg, avg_sig_pow, opt)
        stream = _Stream(cfg, loader, val_loader,
                         np.ascontiguousarray(train_ds.pilot_matrix().T,
                                              np.float32), dev)

        def run_train(params, bn_state, opt_state, idx_np, gen, lr,
                      idx_next=None):
            x2, pilot, y2 = stream.train_batch(idx_np, idx_next)
            return a_step(params, bn_state, opt_state, x2, pilot, y2, gen, lr)

        def run_val(params, bn_state, idx_np):
            return a_eval(params, bn_state, *stream.val_batch(idx_np))
    else:
        data = _device_data(train_ds, dev)
        train_step, _ = make_train_step(cfg, tcfg, data, avg_sig_pow, opt)
        val_data = data if val_ds is None else _device_data(val_ds, dev)
        _, val_step = make_train_step(cfg, tcfg, val_data, avg_sig_pow, opt)
        val_multi = val_step.multi

        def run_train(params, bn_state, opt_state, idx_np, gen, lr,
                      idx_next=None):
            return train_step(params, bn_state, opt_state,
                              torch.as_tensor(idx_np, device=dev), gen, lr)

        def run_val(params, bn_state, idx_np):
            return val_step(params, bn_state,
                            torch.as_tensor(idx_np, device=dev))

    bs = tcfg.batch_size
    steps_per_epoch = wins.steps if windowed else max(1, len(train_idx) // bs)
    if mesh is not None and bs % mesh.shape["data"]:
        raise ValueError(f"batch {bs} does not divide over "
                         f"{mesh.shape['data']} data ranks")
    val_steps = max(1, len(val_idx) // bs)

    min_lr = tcfg.lr * tcfg.min_lr_factor
    best_val = np.asarray(extra.get("best_val", [np.inf, np.inf]),
                          np.float64)
    lr = float(extra.get("lr", tcfg.lr))
    if resumed_best is not None:
        best_params, best_bn = resumed_best
    else:
        best_params = tree_map(torch.clone, host(params))
        best_bn = tree_map(torch.clone, host(bn_state))
    since_plateau = int(extra.get("since_plateau", 0))
    best_sum = float(extra.get("best_sum", np.inf))
    since_best = np.asarray(extra.get("since_best", [0, 0]))
    history = {"loss_real": [], "loss_imag": [], "val_loss_real": [],
               "val_loss_imag": [], "lr": []}
    if start_epoch > 0 and workdir is not None:
        # the curves before the resume: history.json covers the whole run
        hist_path = os.path.join(workdir, "history.json")
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                prev = json.load(f)
            for k in history:
                history[k] = list(prev.get(k, []))[:start_epoch]

    def next_perm():
        return wins.perm() if windowed else rng_host.permutation(
            len(train_idx))

    # the shuffle fast-forwarded past the epochs already run
    for _ in range(start_epoch):
        next_perm()
    epochs_ran = 0
    kfuse = max(1, int(tcfg.steps_per_call))
    use_multi = kfuse > 1 and not host_stream and mesh is None

    for epoch in range(start_epoch, tcfg.epochs):
        t0 = time.time()
        perm = next_perm()
        acc = torch.zeros(2, dtype=torch.float64, device=dev)
        n_done = s = 0
        if use_multi:
            n_groups = steps_per_epoch // kfuse
            for gi in range(n_groups):
                rows = perm[gi * kfuse * bs:(gi + 1) * kfuse * bs]
                idx2 = torch.as_tensor(train_idx[rows].reshape(kfuse, bs),
                                       device=dev)
                gen = step_generator(tcfg.seed,
                                     epoch * steps_per_epoch + gi * kfuse, dev)
                params, bn_state, opt_state, per_dim = train_step.multi(
                    params, bn_state, opt_state, idx2, gen, lr)
                acc += per_dim.double() * kfuse
                n_done += kfuse
            s = n_groups * kfuse
        for s2 in range(s, steps_per_epoch):
            idx = train_idx[perm[s2 * bs:(s2 + 1) * bs]]
            idx_next = (train_idx[perm[(s2 + 1) * bs:(s2 + 2) * bs]]
                        if s2 + 1 < steps_per_epoch else None)
            if idx_next is not None and len(idx_next) < bs:
                idx_next = None
            gen = step_generator(tcfg.seed, epoch * steps_per_epoch + s2, dev)
            params, bn_state, opt_state, per_dim = run_train(
                params, bn_state, opt_state, idx, gen, lr, idx_next=idx_next)
            acc += per_dim.double()
            n_done += 1
        ep_loss = acc.cpu().numpy() / max(n_done, 1)

        vacc = torch.zeros(2, dtype=torch.float64, device=dev)
        sv = 0
        if use_multi and val_multi is not None:
            vg = val_steps // kfuse
            for gi in range(vg):
                idx2 = torch.as_tensor(
                    val_idx[gi * kfuse * bs:(gi + 1) * kfuse * bs]
                    .reshape(kfuse, bs), device=dev)
                vacc += val_multi(params, bn_state, idx2).double()
            sv = vg * kfuse
        for sv2 in range(sv, val_steps):
            vacc += run_val(params, bn_state,
                            val_idx[sv2 * bs:(sv2 + 1) * bs]).double()
        val_loss = vacc.cpu().numpy() / val_steps

        history["loss_real"].append(float(ep_loss[0]))
        history["loss_imag"].append(float(ep_loss[1]))
        history["val_loss_real"].append(float(val_loss[0]))
        history["val_loss_imag"].append(float(val_loss[1]))
        history["lr"].append(lr)
        epochs_ran = epoch + 1

        # per-plane best tracking (EarlyStopping restore_best_weights)
        improved = val_loss < best_val
        if improved.any():
            host_p, host_b = host(params), host(bn_state)
        for d in range(2):
            if improved[d]:
                best_val[d] = val_loss[d]
                since_best[d] = 0
                best_params = tree_map(
                    lambda bp, p, d=d: _set_plane(bp, p, d), best_params,
                    host_p)
                best_bn = tree_map(lambda bb, b, d=d: _set_plane(bb, b, d),
                                   best_bn, host_b)
            else:
                since_best[d] += 1

        # ReduceLROnPlateau on the summed val loss
        vsum = float(val_loss.sum())
        if vsum < best_sum - 1e-12:
            best_sum = vsum
            since_plateau = 0
        else:
            since_plateau += 1
            if since_plateau >= tcfg.plateau_patience and lr > min_lr:
                lr = max(lr * tcfg.plateau_factor, min_lr)
                since_plateau = 0
                if verbose:
                    print(f"[fit] plateau: reducing lr to {lr:.2e}")

        if verbose:
            print(f"[fit] epoch {epoch + 1}/{tcfg.epochs} "
                  f"loss=({ep_loss[0]:.4e},{ep_loss[1]:.4e}) "
                  f"val=({val_loss[0]:.4e},{val_loss[1]:.4e}) "
                  f"lr={lr:.1e} {time.time() - t0:.1f}s")

        if workdir is not None:
            # on a mesh every process gathers (the pieces may cross
            # processes); process 0 writes
            last = (host(params), host(bn_state), host(opt_state))
        if workdir is not None and writer:
            save_checkpoint(
                os.path.join(workdir, "last"), cfg, tcfg, *last[:2],
                extra={"epoch": epoch + 1, "lr": lr,
                       "best_val": best_val.tolist(),
                       "since_best": since_best.tolist(),
                       "since_plateau": since_plateau,
                       "best_sum": best_sum},
                opt_state=last[2], backend=tcfg.ckpt_backend)
            with open(os.path.join(workdir, "history.json"), "w") as f:
                json.dump(history, f)
            if improved.any():
                # 'best' kept durable, so a cut run still has it
                save_checkpoint(
                    os.path.join(workdir, "best"), cfg, tcfg, best_params,
                    best_bn, extra={"best_val": best_val.tolist(),
                                    "epochs": epoch + 1},
                    backend=tcfg.ckpt_backend)

        if (since_best >= tcfg.early_stop_patience).all():
            if verbose:
                print(f"[fit] early stop at epoch {epoch + 1}")
            break

    if workdir is not None and writer:
        os.makedirs(workdir, exist_ok=True)
        save_checkpoint(
            os.path.join(workdir, "best"), cfg, tcfg, best_params, best_bn,
            extra={"best_val": best_val.tolist(), "epochs": epochs_ran},
            backend=tcfg.ckpt_backend)
        with open(os.path.join(workdir, "history.json"), "w") as f:
            json.dump(history, f)
        _plot_history(workdir, history)
    if mesh is not None:
        # the best weights come back on the mesh's first device
        best_params, best_bn = (tree_map(lambda t: t.to(dev), t)
                                for t in (best_params, best_bn))
    return TrainResult(best_params, best_bn, history, best_val, epochs_ran)


def evaluate_dataset(cfg: SimConfig, tcfg: TrainConfig, params, bn_state,
                     ds: "CSIDataset", batch_packets: int = 4,
                     drop_input: bool = False, drop_seed: int = 0,
                     device=None):
    """Predict complex CSI for every sample of a dataset, in its order,
    batched by whole packets (test batch = nTX·nRX,
    massiveMIMO_CSI_prediction_DNN.py:337-339), in full float32.

    ``input_norm='rms'`` divides each input by its complex RMS (taken
    before any drop mask) and scales the prediction back. ``drop_input``
    zeroes each input value with probability ``tcfg.input_dropout``
    (--testDropInput, :377-398), the batch starting at packet k drawing
    from a generator seeded from (drop_seed, k). params and bn_state:
    tensors, or the numpy leaves of ``load_checkpoint``. device: None
    means the card, and raises without one.

    Returns (pred (B, C, T, R) complex64 numpy, per-plane MSE against
    ds.h_ls (2,))."""
    dev = _resolve(device)
    params, bn_state = _state_on(params, bn_state, dev)
    data = _device_data(ds, dev)
    rms = tcfg.input_norm == "rms"
    per_pkt = cfg.num_tx * cfg.num_rx
    preds, mses = [], []
    with torch.no_grad(), full_f32_matmul():
        for start in range(0, ds.num_packets, batch_packets):
            n = min(batch_packets, ds.num_packets - start)
            idx = torch.arange(start * per_pkt, (start + n) * per_pkt,
                               device=dev)
            x2, pilot, y2 = _gather_batch(cfg, data, idx)
            if rms:
                a = torch.sqrt((x2 * x2).mean(-1).sum(0) + 1e-30)
                x2 = x2 / a[None, :, None]
            if drop_input:
                keep = 1.0 - tcfg.input_dropout
                g = _seeded(dev, drop_seed, start, 2)
                x2 = x2 * (torch.rand(x2.shape, generator=g, device=dev)
                           < keep)
            xin = preprocess_input(cfg, tcfg, x2, torch.stack([pilot, pilot]))
            pred, _ = stacked_apply(tcfg, params, bn_state, xin)
            if rms:
                pred = pred * a[None, :, None]
            preds.append(pred)
            mses.append(((pred - y2) ** 2).mean((1, 2)) * n)
    pred = torch.cat(preds, 1).cpu().numpy()              # (2, B·R·T, C)
    mse = torch.stack(mses).sum(0).cpu().numpy() / ds.num_packets
    cplx = (pred[0] + 1j * pred[1]).astype(np.complex64)
    # sample order (p, r, t) → (B, C, T, R)
    out = cplx.reshape(ds.num_packets, cfg.num_rx, cfg.num_tx,
                       cfg.num_carriers)
    return np.transpose(out, (0, 3, 2, 1)), mse
