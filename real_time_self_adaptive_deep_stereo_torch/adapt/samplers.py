"""MAD block samplers — the five strategies of the reference
``Sampler/sampler_factory.py`` (FIXED / RANDOM / ARGMAX / SEQUENTIAL /
PROBABILITY), re-implemented as small host-side policies over a numpy
score distribution.

These run on O(num_blocks) floats between device steps, so host numpy
is the right place for them (the device never waits on more than one
scalar). Each ``sample(distribution)`` returns the indices of the
blocks to train this frame.

A copy of ``real_time_self_adaptive_deep_stereo_tpu/adapt/samplers.py``
(numpy only): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["SAMPLER_FACTORY", "AVAILABLE_SAMPLER", "get_sampler", "softmax"]


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - np.max(x))
    return e / e.sum(axis=0)


class Sampler:
    """Base sampler; ``n`` = how many blocks to pick per call."""

    def __init__(self, n: int, seed: int | None = None):
        self.n = n
        self.rng = np.random.default_rng(seed)

    def sample(self, distribution: np.ndarray) -> List[int]:  # pragma: no cover
        raise NotImplementedError


class FixedSampler(Sampler):
    """Always returns the same configured block id(s)."""

    def __init__(self, n: int, fixed_id, seed: int | None = None):
        super().__init__(n, seed)
        self.fixed_id = fixed_id

    def sample(self, distribution):
        return list(np.atleast_1d(self.fixed_id))


class RandomSampler(Sampler):
    """Uniform choice without replacement."""

    def sample(self, distribution):
        return list(self.rng.choice(len(distribution), size=self.n, replace=False))


class ArgmaxSampler(Sampler):
    """Top-n blocks by score."""

    def sample(self, distribution):
        d = np.squeeze(np.asarray(distribution))
        return list(np.argpartition(d, -self.n)[-self.n :])


class SequentialSampler(Sampler):
    """Round-robin over blocks."""

    def __init__(self, n: int, seed: int | None = None):
        super().__init__(n, seed)
        self._counter = 0

    def sample(self, distribution):
        k = len(distribution)
        base = self._counter % k
        self._counter += 1
        return [(base + i) % k for i in range(self.n)]


class ProbabilitySampler(Sampler):
    """Sample proportionally to the (softmaxed) score distribution."""

    def sample(self, distribution):
        d = np.squeeze(np.asarray(distribution))
        return list(self.rng.choice(len(d), size=self.n, replace=False, p=d))


SAMPLER_FACTORY = {
    "FIXED": FixedSampler,
    "RANDOM": RandomSampler,
    "ARGMAX": ArgmaxSampler,
    "SEQUENTIAL": SequentialSampler,
    "PROBABILITY": ProbabilitySampler,
}

AVAILABLE_SAMPLER = list(SAMPLER_FACTORY)


def get_sampler(name: str, blocks_to_fetch: int, fixed_id=0, seed: int | None = None):
    if name not in SAMPLER_FACTORY:
        raise KeyError(f"Unknown sampler {name!r}; choose from {AVAILABLE_SAMPLER}")
    if name == "FIXED":
        return FixedSampler(blocks_to_fetch, fixed_id, seed)
    return SAMPLER_FACTORY[name](blocks_to_fetch, seed)
