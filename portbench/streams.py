"""The one traffic generator: a cell's pool of streams from its traffic
file, its configuration's feed and the run's seed.

A traffic file (``traffic/<name>.json``) gives:

* ``pool``: how many distinct streams the run makes; the window runs them
  back to back, in pool order, and starts again at the first;
* ``leaves``: each stream's leaf count, ``{"fixed": n}``, so every seed
  has the same sizes.

``gen_rndm.numpy_stream`` makes the bytes at the configuration's
``maxlen``; stream ``i`` of seed ``s`` is seeded with ``[s, i]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import gen_rndm
from .reference import line_bounds


def seed_words(seed: int) -> int:
    """The run's seed as a non-negative int (any whole number is taken)."""
    return seed % (1 << 64)


def leaf_counts(traffic: dict) -> list[int]:
    return [int(traffic["leaves"]["fixed"])] * int(traffic["pool"])


@dataclass
class Pool:
    streams: list[bytes]
    leaves: list[int]

    def lengths(self, i: int) -> np.ndarray:
        """Leaf lengths of stream ``i``."""
        starts, ends = line_bounds(self.streams[i])
        return ends - starts

    def warmup(self) -> list[int]:
        """The streams set-up runs once: the first of each leaf count, so
        every path and size the window takes has run before it."""
        first: dict[int, int] = {}
        for i, n in enumerate(self.leaves):
            first.setdefault(n, i)
        return sorted(first.values())


def make_pool(config: dict, traffic: dict, seed: int) -> Pool:
    counts = leaf_counts(traffic)
    streams = [gen_rndm.numpy_stream([seed_words(seed), i], n, int(config["maxlen"])) for i, n in enumerate(counts)]
    return Pool(streams, counts)
