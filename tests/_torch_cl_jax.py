"""Shared by the closed-loop tests of the port (tests/test_torch_{datatx,
closed_loop,multiuser}.py): the JAX package's draws of its data legs,
with its keys split as ``mamimo_tpu/pipeline/datatx.py`` splits them,
and its scenarios and channel realizations as the port's tensors."""

import jax
import numpy as np
import torch

from mamimo_tpu_torch.channel.scattering import ChannelRealization, Scenario
from mamimo_tpu_torch.pipeline.datatx import DataTxDraws, data_leg_samples

# tests/test_closed_loop.py's CL_CFG
CL_KW = dict(num_tx=8, num_rx=2, n_scatterers=16, n_rays=64,
             num_data_symbols=4)
# tests/test_multiuser.py's MU
MU_KW = dict(num_users=2, num_tx=8, num_rx=2, n_scatterers=12,
             num_data_symbols=4)


def jax_data_tx_draws(jcfg, key) -> DataTxDraws:
    """The draws of JAX's ``run_data_transmission(cfg, key, ...)``: key
    split 3 ways (rays, bits, noise), the rays' key 2 ways (az, el)."""
    k_rays, k_bits, k_noise = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_rays)
    az = jax.random.uniform(k1, (jcfg.n_rays,), minval=-180.0, maxval=180.0)
    el = jax.random.uniform(k2, (jcfg.n_rays,), minval=-90.0, maxval=90.0)
    bits = jax.random.bernoulli(k_bits, 0.5, (jcfg.num_frm_bits,))
    noise = jax.random.normal(
        k_noise, (data_leg_samples(jcfg, jcfg.num_sts), jcfg.num_rx, 2))
    return DataTxDraws(torch.tensor(np.asarray(az)),
                       torch.tensor(np.asarray(el)),
                       torch.tensor(np.asarray(bits, np.int32)),
                       torch.tensor(np.asarray(noise)))


def jax_data_tx_mu_draws(jcfg, key) -> DataTxDraws:
    """The draws of JAX's ``run_data_transmission_mu(cfg, key, ...)``: key
    split 2 ways (bits, noise), user u folded into each."""
    k_bits, k_noise = jax.random.split(key)
    n = data_leg_samples(jcfg, jcfg.num_users * jcfg.num_sts)
    bits = [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(k_bits, u), 0.5, (jcfg.num_frm_bits,)), np.int32)
        for u in range(jcfg.num_users)]
    noise = [np.asarray(jax.random.normal(jax.random.fold_in(k_noise, u),
                                          (n, jcfg.num_rx, 2)))
             for u in range(jcfg.num_users)]
    return DataTxDraws(None, None, torch.tensor(np.stack(bits)),
                       torch.tensor(np.stack(noise)))


def stack_draws(draws) -> DataTxDraws:
    """Per-packet DataTxDraws stacked on a leading packet axis."""
    return DataTxDraws(*(None if parts[0] is None else torch.stack(parts)
                         for parts in zip(*draws)))


def t(a):
    return torch.tensor(np.asarray(a))


def scenario(jscen) -> Scenario:
    return Scenario(*(t(x) for x in jscen))


def channel(jchan) -> ChannelRealization:
    return ChannelRealization(*(t(x) for x in jchan))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def phase_aligned_rel(a, b, axes):
    """The relative difference of a and b after rotating a by the one
    phase per slice over ``axes`` (the rest) that brings it closest to b:
    singular and eigenvectors carry an arbitrary phase."""
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    inner = np.sum(np.conj(a) * b, axis=axes, keepdims=True)
    ph = inner / np.maximum(np.abs(inner), 1e-300)
    return rel(a * ph, b)


def jax_sounding_draws(jcfg, key):
    """The draws of JAX's ``sound_packet(cfg, key, ...)`` in 'snr' mode on
    the one-ring channel, as the port's SoundingDraws of one packet: key
    split 3 ways (channel, noise, oracle), the channel's 2 ways (u, g)."""
    from mamimo_tpu_torch.pipeline.sounding import SoundingDraws

    k_chan, k_noise, k_perf = jax.random.split(key, 3)
    kp, kg = jax.random.split(k_chan)
    shape = (jcfg.len_ltf + jcfg.num_pad_zeros, jcfg.num_rx, 2)
    u = jax.random.uniform(kp, (3, jcfg.n_scatterers), minval=-1.0,
                           maxval=1.0)
    g = jax.random.normal(kg, (2, jcfg.n_scatterers))
    noise = jax.random.normal(k_noise, shape)
    perf = jax.random.normal(k_perf, shape)
    return SoundingDraws(t(u)[None], t(g)[None], None, t(noise)[None], None,
                         t(perf)[None])
