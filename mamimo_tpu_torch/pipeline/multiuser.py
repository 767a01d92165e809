"""Multi-user scenarios and sounding (the port's copy of
``mamimo_tpu/pipeline/multiuser.py``: the numUsers > 1 machinery of
generate_maMIMO_LTF.m:22-26,234-386).

Each user gets its own placement, path loss and per-packet scattering
channel; all users hear the same sounding preamble. A stacked Scenario
carries a leading user axis U. Sounding loops over the users in Python
(U is small), each user's packets as one batch.

Randomness: the users' scenarios are drawn one after another from the
experiment's scenario generator; user u's packet p comes from its own
generator, seeded from (seed, p, 1000 + u) (``user_packet_generator``,
the prm.seed_p{u}(pkt) contract), where JAX folds 1000 + u into the
packet's key.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mamimo_tpu_torch.channel.scattering import (
    ChannelRealization,
    Scenario,
    make_scenario,
)
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.pipeline.sounding import (
    SoundingDraws,
    SoundingResult,
    draw_sounding,
    sound_from_draws,
)
from mamimo_tpu_torch.utils.seeds import seeded_generator


def make_scenarios(cfg: SimConfig, gen: torch.Generator) -> Scenario:
    """The users' scenarios, drawn in turn from ``gen``, stacked on a
    leading axis num_users."""
    scens = [make_scenario(cfg, gen) for _ in range(cfg.num_users)]
    return Scenario(*(torch.stack(parts) for parts in zip(*scens)))


def index_user(scen: Scenario, u: int) -> Scenario:
    """One user's scenario from a stacked Scenario."""
    return Scenario(*[x[u] for x in scen])


def user_packet_generator(seed: int, p: int, u: int,
                          device) -> torch.Generator:
    """User u's generator of packet p: seeded from (seed, p, 1000 + u)
    alone."""
    return seeded_generator(device, seed, p, 1000 + u)


def sound_mu_from_draws(cfg: SimConfig, scens: Scenario,
                        draws: Sequence[SoundingDraws], snr_db,
                        **kw) -> Tuple[SoundingResult, ChannelRealization]:
    """Sound a batch of packets to every user: draws[u] (leading packet
    axis B) through user u's scenario, ``sound_from_draws`` with options
    ``kw``. Returns the result and the realizations, each tensor (B, U,
    ...)."""
    outs = [sound_from_draws(cfg, index_user(scens, u), draws[u], snr_db,
                             **kw) for u in range(cfg.num_users)]
    res = SoundingResult(*(torch.stack(p, dim=1)
                           for p in zip(*(o[0] for o in outs))))
    chan = ChannelRealization(*(torch.stack(p, dim=1)
                                for p in zip(*(o[1] for o in outs))))
    return res, chan


def sound_packet_mu(cfg: SimConfig, gens: Sequence[torch.Generator],
                    scens: Scenario, snr_db, preamble=None,
                    with_mmse: bool = False, noise_mode: str = "snr",
                    fft_size: int = 16384, device=None
                    ) -> Tuple[SoundingResult, ChannelRealization]:
    """Sound one packet to every user, user u's draws from gens[u].
    device: where it runs; None means the card. Returns the result and
    the realizations stacked on a leading user axis."""
    dev = resolve_device("cuda" if device is None else device)
    draws = [draw_sounding(cfg, [g], noise_mode) for g in gens]
    res, chan = sound_mu_from_draws(
        cfg, Scenario(*(t.to(dev) for t in scens)),
        [SoundingDraws(*(None if t is None else t.to(dev) for t in d))
         for d in draws], snr_db, preamble=preamble, with_mmse=with_mmse,
        noise_mode=noise_mode, fft_size=fft_size)
    return (SoundingResult(*(t[0] for t in res)),
            ChannelRealization(*(t[0] for t in chan)))
