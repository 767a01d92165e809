"""CDL-style clustered delay line channel (3GPP TR 38.901 §7.7.1
structure; the port's copy of ``mamimo_tpu/channel/cdl.py``).

An alternative to the reference's one-ring scattering model
(``helperApplyMUChannel.m:85-133``): N clusters, each with a normalized
delay, a power, departure and arrival azimuth and zenith angles, and
M = 20 rays whose angles are the cluster angle plus a per-cluster spread
times the ray-offset table (TR 38.901 Table 7.5-3); the LOS profile adds
a deterministic direct ray with a Ricean K-factor. The two built-in
profiles are representative tables made from fixed NumPy seeds by the
JAX package's own ``_make_profile``, copied here with the same seeds and
the same NumPy calls, so the tables are equal (not copies of the spec's
CDL-A..E).

Per packet only the per-ray coupling phases ``phi`` are random; the
cluster structure is fixed, with the mean AoD/AoA along the scenario's
BS→user direction. The absolute delay is the LOS delay plus
``cfg.cdl_delay_spread``-scaled cluster delays, so ``chan_delay =
floor(range/c · Fs)``. Cluster powers are normalized, so the expected
per-link power is the free-space (λ/4πd)².

``cdl_from_draws`` is the realization on given phases (with leading
packet dims, or none), which the tests feed with JAX's draws;
``realize_cdl`` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from mamimo_tpu_torch.channel.scattering import (
    ChannelRealization,
    Scenario,
    _uniform,
    steering_vectors,
)
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.utils.numerics import full_f32_matmul, unit_phasor

# TR 38.901 Table 7.5-3: ray offset angles within a cluster (± pairs),
# in units of the per-cluster rms angular spread.
RAY_OFFSETS = np.array(
    [0.0447, 0.1413, 0.2492, 0.3715, 0.5129,
     0.6797, 0.8844, 1.1481, 1.5195, 2.1551], np.float32)
RAY_OFFSETS = np.concatenate([RAY_OFFSETS, -RAY_OFFSETS])  # (20,)
NUM_RAYS = RAY_OFFSETS.size


@dataclass(frozen=True)
class CDLProfile:
    """One clustered-delay-line table (angles relative to the LOS
    direction, delays in units of the delay spread)."""

    delays: Tuple[float, ...]      # normalized cluster delays, sorted, [0..]
    powers_db: Tuple[float, ...]   # cluster powers (normalized on use)
    aod: Tuple[float, ...]         # departure azimuth offsets [deg]
    aoa: Tuple[float, ...]         # arrival azimuth offsets [deg]
    zod: Tuple[float, ...]         # departure zenith offsets [deg]
    zoa: Tuple[float, ...]         # arrival zenith offsets [deg]
    c_asd: float                   # per-cluster departure azimuth spread
    c_asa: float                   # per-cluster arrival azimuth spread
    c_zsd: float                   # per-cluster departure zenith spread
    c_zsa: float                   # per-cluster arrival zenith spread
    los: bool = False              # prepend a deterministic LOS ray


def _make_profile(n_clusters: int, seed: int, los: bool) -> CDLProfile:
    """Deterministic representative profile: exponential PDP with
    per-cluster lognormal shadowing; angles widen with delay."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.exponential(1.0, n_clusters))
    d -= d[0]
    p_db = -10.0 * d * np.log10(math.e) + rng.normal(0.0, 2.0, n_clusters)
    aod = rng.normal(0.0, 25.0, n_clusters)
    aoa = rng.normal(0.0, 55.0, n_clusters)
    zod = rng.normal(0.0, 4.0, n_clusters)
    zoa = rng.normal(0.0, 8.0, n_clusters)
    return CDLProfile(
        delays=tuple(float(x) for x in d),
        powers_db=tuple(float(x) for x in p_db),
        aod=tuple(float(x) for x in aod),
        aoa=tuple(float(x) for x in aoa),
        zod=tuple(float(x) for x in zod),
        zoa=tuple(float(x) for x in zoa),
        c_asd=5.0, c_asa=11.0, c_zsd=3.0, c_zsa=7.0,
        los=los,
    )


_PROFILES = {
    "cdl_nlos": _make_profile(n_clusters=20, seed=389011, los=False),
    "cdl_los": _make_profile(n_clusters=13, seed=389012, los=True),
}


def get_profile(name: str) -> CDLProfile:
    try:
        return _PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown CDL profile {name!r}; expected one of "
            f"{sorted(_PROFILES)} (or pass a CDLProfile to realize_cdl)"
        ) from None


def num_phases(cfg: SimConfig, profile: CDLProfile | None = None) -> int:
    """The number of per-packet ray phases of the profile: clusters × 20."""
    return len((profile or get_profile(cfg.channel_model)).delays) * NUM_RAYS


def cdl_from_draws(cfg: SimConfig, scen: Scenario, phi,
                   profile: CDLProfile | None = None) -> ChannelRealization:
    """The CDL realization for given ray phases ``phi`` (..., clusters ×
    20), uniform in [0, 2π): cr (..., Nt, Nr, clusters), tau (...,
    clusters) and chan_delay (...), on the scenario's device."""
    prof = profile or get_profile(cfg.channel_model)
    n_cl = len(prof.delays)
    dev = scen.rx_pos.device
    phi = torch.as_tensor(phi, dtype=torch.float32, device=dev)

    # cluster powers normalized so the expected per-link power is the
    # free-space one; LOS splits K/(K+1) : 1/(K+1)
    p = 10.0 ** (np.asarray(prof.powers_db, np.float64) / 10.0)
    p /= p.sum()
    if prof.los:
        k_lin = 10.0 ** (cfg.cdl_k_factor_db / 10.0)
        p = p / (1.0 + k_lin)
        p_los = k_lin / (1.0 + k_lin)

    # ray angles: cluster mean + spread × offset table, the departure fan
    # centred on the BS→user direction, the arrival fan on user→BS
    off = RAY_OFFSETS[None, :]                                # (1, M)
    az_d = np.asarray(prof.aod)[:, None] + prof.c_asd * off  # (C, M)
    az_a = np.asarray(prof.aoa)[:, None] + prof.c_asa * off
    el_d = np.asarray(prof.zod)[:, None] + prof.c_zsd * off
    el_a = np.asarray(prof.zoa)[:, None] + prof.c_zsa * off

    def flat(a):
        return torch.as_tensor(a.reshape(-1), dtype=torch.float32,
                               device=dev)

    tx_w = scen.tx_elem / cfg.lam                             # (3, Nt)
    rx_w = scen.rx_elem / cfg.lam                             # (3, Nr)
    a_tx = steering_vectors(tx_w, scen.mobile_az + flat(az_d),
                            scen.mobile_el + flat(el_d))      # (Nt, C·M)
    a_rx = steering_vectors(rx_w, scen.mobile_az + 180.0 + flat(az_a),
                            -scen.mobile_el + flat(el_a))     # (Nr, C·M)

    amp_ray = torch.as_tensor(
        np.sqrt(np.repeat(p, NUM_RAYS) / NUM_RAYS).astype(np.float32),
        device=dev)
    g = amp_ray * torch.complex(torch.cos(phi), torch.sin(phi))

    fspl_amp = cfg.lam / (4.0 * math.pi * scen.mobile_range)
    with full_f32_matmul():
        cr = torch.einsum("tp,rp,...p->...trp", a_tx, a_rx, g)
    cr = cr.reshape(phi.shape[:-1] + (cfg.num_tx, cfg.num_rx, n_cl,
                                      NUM_RAYS)).sum(-1)
    cr = fspl_amp * cr                                        # (..., Nt, Nr, C)

    tau = (torch.as_tensor(prof.delays, dtype=torch.float32, device=dev)
           * cfg.cdl_delay_spread + scen.mobile_range / cfg.c_light)

    if prof.los:
        # the deterministic direct ray at the LOS angles and delay, with
        # the carrier phase of the true propagation distance
        a_t0 = steering_vectors(tx_w, scen.mobile_az[None],
                                scen.mobile_el[None])[:, 0]
        a_r0 = steering_vectors(rx_w, (scen.mobile_az + 180.0)[None],
                                (-scen.mobile_el)[None])[:, 0]
        # −range/λ as a product with λ's float32 reciprocal, as XLA's
        # compiled code and PyTorch's CUDA division by a scalar compute it
        # (one rounding apart is 0.008 cycles at 1 km)
        ph0 = unit_phasor(-scen.mobile_range * np.float32(1.0 / cfg.lam))
        los_cr = (math.sqrt(p_los) * fspl_amp * ph0
                  * a_t0[:, None] * a_r0[None, :])
        cr = torch.cat([cr[..., :1] + los_cr[:, :, None], cr[..., 1:]], -1)

    chan_delay = torch.floor(torch.min(tau) * cfg.chan_srate).to(torch.int32)
    batch = phi.shape[:-1]
    return ChannelRealization(cr, tau.expand(batch + tau.shape),
                              chan_delay.expand(batch))


def realize_cdl(cfg: SimConfig, gen: torch.Generator, scen: Scenario,
                profile: CDLProfile | None = None) -> ChannelRealization:
    """Draw one packet's CDL channel: its ray phases from ``gen`` (the
    only per-packet randomness), then ``cdl_from_draws``."""
    phi = _uniform(gen, (num_phases(cfg, profile),), 0.0, 2.0 * math.pi)
    return cdl_from_draws(cfg, scen, phi, profile)
