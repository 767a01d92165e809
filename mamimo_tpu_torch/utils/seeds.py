"""Seeded ``torch.Generator``s: each random stream of the port (a
packet's sounding, a user's packet, a data leg, a closed-loop
evaluation) comes from its own generator, seeded from a few integers
alone, where the JAX package folds them into a PRNG key."""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(device, *entropy: int,
                     stream: int | None = None) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``
    alone through numpy's SeedSequence (63 bits); ``stream`` (a spawn
    key) keeps streams of the same integers apart."""
    seq = np.random.SeedSequence(
        list(entropy), spawn_key=() if stream is None else (stream,))
    s = seq.generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        ((int(s[0]) << 32) | int(s[1])) & ((1 << 63) - 1))
