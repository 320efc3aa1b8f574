"""The schedulable essence of a pod: a small fixed-shape numeric request.

The reference matcher re-derives these quantities on every call from the
CfgTopology object graph (CfgTopology.py:199-232). Here they are extracted
once into a flat dataclass that (a) the serial oracle consumes directly and
(b) packs bit-for-bit into the dense pod-batch tensors of the JAX solver
(nhd_tpu/solver/encode.py) — the single source of truth for "what does this
pod ask for" on both paths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any, FrozenSet, List, Tuple

from nhd_tpu_torch.core.topology import MapMode, PodTopology, SmtMode

# canonical instance per PodRequest value (see PodRequest.interned)
_INTERN: dict = {}


def _field_key(self: Any) -> tuple:
    """All dataclass fields, in declaration order — mechanically derived
    so hash and eq can never drift from the field set. Nested request
    dataclasses are replaced by their own (primitive) keys, so the result
    is a tuple tree of primitives that compares at C speed — and it is
    CACHED on the instance: the pod-dedupe dict (encode_pods) runs one
    __eq__ per pod of a 10k gang, and rebuilding the tuple per probe was
    ~60% of the whole encode phase."""
    cached = self.__dict__.get("_keyt")
    if cached is not None:
        return cached
    cls = self.__class__
    names = cls.__dict__.get("_field_names")
    if names is None:
        names = tuple(f.name for f in fields(self))
        cls._field_names = names
    key = tuple(
        tuple(x._key() for x in v)
        if isinstance(v, tuple) and v and hasattr(v[0], "_key")
        else (v._key() if hasattr(v, "_key") else v)
        for v in (getattr(self, n) for n in names)
    )
    object.__setattr__(self, "_keyt", key)
    return key


def _cached_hash(self: Any) -> int:
    """Shared lazy hash-cache for the request dataclasses: the
    dataclass-generated __hash__ rebuilds the field tuple on every call,
    and the pod-dedupe dict (encode_pods) probes it for every pod of a
    10k gang. Each class assigns ``__hash__ = _cached_hash``; the key is
    the mechanical all-fields tuple (_field_key), the same thing the
    generated __eq__ compares."""
    h = self.__dict__.get("_hash")
    if h is None:
        h = hash(self._key())
        object.__setattr__(self, "_hash", h)
    return h


@dataclass(frozen=True)
class CpuRequest:
    """A count of cores plus whether they may ride SMT siblings."""

    count: int
    smt: SmtMode

    _key = _field_key
    __hash__ = _cached_hash

    def physical_cores(self, node_smt: bool) -> int:
        """Physical (sibling-pair) cores consumed on a node.

        Reproduces the reference's load-bearing quirk (Matcher.py:179-201):
        on SMT nodes an SMT-tolerant request packs two logical cores per
        physical core (ceil division); an SMT-averse request burns one full
        physical core per logical core. On non-SMT nodes count==physical.
        """
        if node_smt and self.smt == SmtMode.ON:
            return math.ceil(self.count / 2.0)
        return self.count


@dataclass(frozen=True)
class GroupRequest:
    """Per-processing-group resource ask."""

    proc: CpuRequest  # processing cores incl. GPU feeder cores
    misc: CpuRequest  # helper cores
    gpus: int
    nic_rx_gbps: float
    nic_tx_gbps: float

    _key = _field_key
    __hash__ = _cached_hash

    def cpu_physical(self, node_smt: bool) -> int:
        """Group total physical cores: proc + helper, each under its own SMT
        setting (reference: Matcher.py:179-194 sums both into one count)."""
        return self.proc.physical_cores(node_smt) + self.misc.physical_cores(node_smt)

    @property
    def needs_nic(self) -> bool:
        return self.nic_rx_gbps > 0 or self.nic_tx_gbps > 0


@dataclass(frozen=True, eq=False)
class PodRequest:
    """Flat, hashable pod resource request.

    Hashability is load-bearing: gang batches of identical replicas (e.g. a
    TriadSet scaling out) dedupe to one solver row via this hash — so the
    hash is computed once and cached (a frozen dataclass would otherwise
    re-hash the whole tuple tree on every dict probe; at 10k-pod batches
    that showed up as ~15% of scheduling time).
    """

    groups: Tuple[GroupRequest, ...]
    misc: CpuRequest
    hugepages_gb: int
    map_mode: MapMode
    node_groups: FrozenSet[str] = frozenset({"default"})
    # scheduling priority tier (policy engine, nhd_tpu/policy/): 0 =
    # best-effort; higher tiers may trigger bounded preemption of
    # strictly lower tiers when unplaceable. Part of the dedupe key by
    # construction (mechanical field tuple), so mixed-tier gangs split
    # into per-tier solver rows.
    tier: int = 0

    _key = _field_key
    __hash__ = _cached_hash

    def __eq__(self, other: object) -> bool:
        if self is other:
            return True
        if not isinstance(other, PodRequest):
            return NotImplemented
        return self._key() == other._key()

    def interned(self) -> "PodRequest":
        """The canonical instance for this request VALUE.

        Interning at construction/parse time (from_topology, the sim
        workload factories) makes the gang dedup in encode_pods an
        identity dict hit — CPython dict probes short-circuit on pointer
        equality before calling __eq__ — removing the per-pod key-tuple
        comparison from the schedule() hot path (~6 ms of a 10k-gang
        encode). The table is value-bounded (distinct request shapes,
        not pods) and cleared if a chaotic workload ever grows it past
        64k entries."""
        got = _INTERN.get(self)
        if got is None:
            if len(_INTERN) > (1 << 16):
                _INTERN.clear()
            _INTERN[self] = got = self
        return got

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def needs_gpu(self) -> bool:
        return any(g.gpus > 0 for g in self.groups)

    def gpu_counts(self) -> List[int]:
        return [g.gpus for g in self.groups]

    def cpu_slot_counts(self, node_smt: bool) -> List[int]:
        """Per-slot physical core totals: one slot per group plus the
        top-level misc cores as the final slot — the reference's
        misc-as-last-tuple-element convention (Matcher.py:179-201,345)."""
        counts = [g.cpu_physical(node_smt) for g in self.groups]
        counts.append(self.misc.physical_cores(node_smt))
        return counts

    def nic_bw(self) -> List[Tuple[float, float]]:
        """Per-group (rx, tx) Gbps (reference: CfgTopology.py:219-232)."""
        return [(g.nic_rx_gbps, g.nic_tx_gbps) for g in self.groups]

    @staticmethod
    def from_topology(
        top: PodTopology,
        node_groups: FrozenSet[str] = frozenset({"default"}),
        tier: int = 0,
    ) -> "PodRequest":
        groups = tuple(
            GroupRequest(
                proc=CpuRequest(pg.cpu_proc_request(), pg.proc_smt),
                misc=CpuRequest(len(pg.misc_cores), pg.helper_smt),
                gpus=len(pg.gpus),
                nic_rx_gbps=pg.nic_bw_request()[0],
                nic_tx_gbps=pg.nic_bw_request()[1],
            )
            for pg in top.proc_groups
        )
        return PodRequest(
            groups=groups,
            misc=CpuRequest(len(top.misc_cores), top.misc_cores_smt),
            hugepages_gb=top.hugepages_gb,
            map_mode=top.map_mode,
            node_groups=node_groups,
            tier=tier,
        ).interned()
