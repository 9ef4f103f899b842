"""Streams of random numbers derived from ``--seed`` and a tag, so that
every input the benchmark makes is fixed by the seed alone."""

from __future__ import annotations

import numpy as np
import torch


def _state(seed: int, tag: str) -> int:
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + \
        [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0])


def host_rng(seed: int, tag: str) -> np.random.Generator:
    """A NumPy generator for ``tag`` under ``seed``."""
    return np.random.default_rng(_state(seed, tag))


def device_gen(seed: int, tag: str, device) -> torch.Generator:
    """A torch generator on ``device`` for ``tag`` under ``seed``."""
    return torch.Generator(device=device).manual_seed(_state(seed, tag))
