"""The one traffic generator: a closed loop of gangs (one ``schedule``
call each), drawn from the seed up front out of a traffic mix's
parameters (``traffic/<name>``).

Gang sizes are log-uniform over ``[gang_pods_min, gang_pods_max]``, but
stratified: every block of ``block`` gangs holds the same sizes (the
block's quantiles of the law) in an order the seed shuffles. So every
seed gives any whole number of blocks the same work in another order,
and two seeds differ in a window by less than one block; equal bounds
give every gang one size, and every seed the same gangs. Pods take the
mix's pod types in turn and the fleet's node groups in turn at a
different period (``nhd_tpu_torch/sim/workloads.py`` ``workload_mix``'s
rule), continuing from gang to gang; with ``same_pods_every_gang`` every
gang starts again at the first pod, so gangs of one size are the same
pods (a backlog replayed) and order their buckets alike. Nothing here
imports the program.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


@dataclass
class Gang:
    """One gang: pods ``first .. first + size - 1`` of the stream."""

    index: int
    first: int
    size: int

    def pod_types(self, n_types: int) -> np.ndarray:
        return (self.first + np.arange(self.size)) % n_types

    def pod_groups(self, n_types: int, n_groups: int) -> np.ndarray:
        return ((self.first + np.arange(self.size)) // n_types) % n_groups


def block_sizes(mix: dict) -> np.ndarray:
    """The gang sizes of one block: the log-uniform law's quantiles at
    the block's midpoints."""
    lo, hi, b = mix["gang_pods_min"], mix["gang_pods_max"], mix["block"]
    q = (np.arange(b) + 0.5) / b
    return np.rint(lo * (hi / lo) ** q).astype(np.int64)


def gangs(sizes: np.ndarray, first_pod: int = 0, first_index: int = 0,
          restart: bool = False) -> List[Gang]:
    """The gangs of *sizes*, pods numbered on from *first_pod*, or each
    from *first_pod* again with *restart*."""
    out = []
    at = first_pod
    for j, s in enumerate(sizes.tolist()):
        out.append(Gang(first_index + j, at, int(s)))
        if not restart:
            at += int(s)
    return out


def stream_gangs(mix: dict, seed: int, stream: int,
                 first_index: int = 0) -> Iterator[Gang]:
    """The seed's stream number *stream* (0 = the window's, 1 = the
    warm-up's) of *mix*, without end: shuffled blocks of ``block_sizes``,
    drawn a block at a time, so a loop that takes gangs until its clock
    runs out cannot outrun the draw."""
    rng = np.random.default_rng([seed, stream])
    base = block_sizes(mix)
    restart = bool(mix.get("same_pods_every_gang"))
    index, at = first_index, 0
    while True:
        for s in rng.permutation(base).tolist():
            yield Gang(index, at, int(s))
            index += 1
            if not restart:
                at += int(s)


def mix_gangs(mix: dict, seed: int, n_gangs: int, stream: int,
              first_index: int = 0) -> List[Gang]:
    """The first *n_gangs* gangs of the seed's stream *stream* of *mix*."""
    return list(itertools.islice(stream_gangs(mix, seed, stream, first_index), n_gangs))
