"""Host-side node hardware mirror: topology + allocation state.

Functional equivalent of the reference's nhd/Node.py. A HostNode is built
from NFD (node-feature-discovery) labels and tracks which cores/GPUs/NICs/
hugepages are claimed. It stays the *source of truth*: the JAX solver's
device arrays are a projection of this state (packed in
nhd_tpu/solver/encode.py), re-derivable at any time — mirroring the
reference's stance that durable state lives host-side (README.md:85-87).

Label formats are kept reference-compatible (positional dotted labels,
Node.py:327-454) so the same NFD extras feed both systems.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from itertools import chain, count
from typing import Any, Dict, Iterable, List, Optional, Tuple

from nhd_tpu_torch.core.topology import (
    GpuKind,
    MapMode,
    NicDir,
    PodTopology,
    SmtMode,
)
from nhd_tpu_torch.obs.recorder import get_recorder
from nhd_tpu_torch.utils import get_logger

import os as _os

# Tunables — compile-time constants in the reference (Node.py:18-20,107),
# environment-configurable here (SURVEY §5.6). Read once at import.
NIC_BW_AVAIL_PERCENT = float(_os.environ.get("NHD_NIC_BW_AVAIL_PERCENT", "0.9"))
SCHEDULABLE_NIC_SPEED_THRESH_MBPS = int(
    _os.environ.get("NHD_NIC_SPEED_THRESH_MBPS", "11000")
)
ENABLE_NIC_SHARING = _os.environ.get("NHD_NIC_SHARING", "0") == "1"
MIN_BUSY_SECS = float(_os.environ.get("NHD_MIN_BUSY_SECS", "30"))

MAINTENANCE_LABEL = "sigproc.viasat.io/maintenance"

# hardware-generation class label (heterogeneity-aware scoring,
# nhd_tpu/policy/): explicit operator override of the derived class
NODE_CLASS_LABEL = "NHD_NODE_CLASS"

_CPU_CORES_LABEL = "feature.node.kubernetes.io/nfd-extras-cpu.num_cores"
_CPU_SOCKETS_LABEL = "feature.node.kubernetes.io/nfd-extras-cpu.numSockets"
_CPU_SMT_LABEL = "feature.node.kubernetes.io/cpu-hardware_multithreading"
_CPU_ISOL_LABEL = "feature.node.kubernetes.io/nfd-extras-cpu.isolcpus"
_NIC_LABEL_PREFIX = "feature.node.kubernetes.io/nfd-extras-nic"
_SRIOV_LABEL_PREFIX = "feature.node.kubernetes.io/nfd-extras-sriov"
_GPU_LABEL_PREFIX = "feature.node.kubernetes.io/nfd-extras-gpu"


def parse_range_list(text: str) -> List[int]:
    """Parse Linux cpuset-style range lists: ``0-3,8,10-11`` → sorted ints
    (reference: Node.py:298-306)."""

    def one(part: str) -> range:
        ends = part.split("-")
        return range(int(ends[0]), int(ends[-1]) + 1)

    return sorted(set(chain.from_iterable(one(p) for p in text.split(","))))


_PACK_GEN_COUNTER = count(1)


def pack_generation_key(
    node_objs: "Iterable[HostNode]", *extra: object
) -> tuple:
    """Cache key identifying a node list's packed-topology generation.

    _pack_state stamps a process-monotonic generation number on the node
    at every rebuild (label reparse), so (node identity, generation)
    pairs are the tokens — array id()s alone are unsafe because numpy
    can reallocate a new generation's arrays at a freed generation's
    addresses. Single definition — every static cache over a node set
    (EncodeStatic, FastCluster._build_static) must use this, so a future
    _pack_state change invalidates them all in lockstep. Callers must
    PIN node_objs in the cache entry (CPython reuses id()s of dead
    objects)."""
    return (
        *extra,
        tuple((id(n), n._pack_gen) for n in node_objs),
    )


def format_mac(raw: str) -> str:
    """NFD flattens MACs to bare hex; restore colon form, uppercased
    (reference: NodeNic.FormatMac, Node.py:58-59)."""
    return ":".join(a + b for a, b in zip(raw[::2], raw[1::2])).upper()


class NodeCpuCore:
    """One logical CPU (reference: Node.py:23-34).

    ``used`` lives in the owning node's packed array once the node is
    finalized (HostNode._pack_state) so batch encode and write-back are
    single vector ops over the whole node instead of ~100k Python
    attribute accesses per 1000-node batch; a core not yet attached to a
    packed node keeps a local flag."""

    __slots__ = ("core", "socket", "sibling", "_used", "_arr")

    def __init__(self, core: int, socket: int, sibling: int, used: bool = False):
        self.core = core
        self.socket = socket
        self.sibling = sibling  # logical id of the SMT sibling, -1 when SMT off
        self._used = used
        # owning node's packed used[] (indexed by .core)
        self._arr: Any = None

    @property
    def used(self) -> bool:
        a = self._arr
        return self._used if a is None else bool(a[self.core])

    @used.setter
    def used(self, v: bool) -> None:
        a = self._arr
        if a is None:
            self._used = bool(v)
        else:
            a[self.core] = v

    def __repr__(self) -> str:
        return (f"NodeCpuCore(core={self.core}, socket={self.socket}, "
                f"sibling={self.sibling}, used={self.used})")


class NodeNic:
    """One schedulable NIC port (reference: Node.py:37-59).

    ``speed_used``/``pods_used`` live in the owning node's packed arrays
    after HostNode._pack_state (same rationale as NodeCpuCore.used);
    ``speed_used`` is then a live [rx, tx] view supporting item reads,
    writes and ``+=``."""

    __slots__ = (
        "ifname", "mac", "vendor", "speed_gbps", "numa_node", "pciesw",
        "card", "port", "idx", "slot", "_speed_used", "_pods_used",
        "_bw", "_pods",
    )

    def __init__(self, ifname: str, mac: str, vendor: str, speed_gbps: float,
                 numa_node: int, pciesw: int, card: int, port: int):
        self.ifname = ifname
        self.mac = mac
        self.vendor = vendor
        self.speed_gbps = speed_gbps
        self.numa_node = numa_node
        self.pciesw = pciesw
        self.card = card
        self.port = port
        self.idx = -1   # per-NUMA-node ordinal, set after all NICs are read
        self.slot = -1  # position in HostNode.nics, set by _pack_state
        self._speed_used: List[float] = [0.0, 0.0]  # rx, tx (pre-pack fallback)
        self._pods_used = 0
        self._bw: Any = None    # owning node's packed [n_nics, 2] bandwidth
        self._pods: Any = None  # owning node's packed [n_nics] pods_used

    @property
    def speed_used(self):
        b = self._bw
        return self._speed_used if b is None else b[self.slot]

    @speed_used.setter
    def speed_used(self, v: Any) -> None:
        b = self._bw
        if b is None:
            self._speed_used = list(v)
        else:
            b[self.slot, 0] = v[0]
            b[self.slot, 1] = v[1]

    @property
    def pods_used(self) -> int:
        p = self._pods
        return self._pods_used if p is None else int(p[self.slot])

    @pods_used.setter
    def pods_used(self, v: int) -> None:
        p = self._pods
        if p is None:
            self._pods_used = int(v)
        else:
            p[self.slot] = v

    def free_bw(self) -> Tuple[float, float]:
        """Schedulable headroom per direction. With sharing disabled a NIC
        serving any pod has zero headroom (reference: Node.py:283-296)."""
        cap = self.speed_gbps * NIC_BW_AVAIL_PERCENT
        if ENABLE_NIC_SHARING:
            return (cap - self.speed_used[0], cap - self.speed_used[1])
        return (0.0, 0.0) if self.pods_used > 0 else (cap, cap)

    def __repr__(self) -> str:
        return (f"NodeNic({self.ifname!r}, mac={self.mac!r}, "
                f"numa={self.numa_node}, idx={self.idx})")


@dataclass
class NodeMemory:
    """Hugepage accounting (reference: Node.py:62-71).

    ``alloc_hugepages_gb`` keeps the K8s-allocatable figure so resets can
    restore free space correctly (the reference resets to raw capacity,
    Node.py:159, silently granting back the OS reserve)."""

    ttl_hugepages_gb: int = 0
    alloc_hugepages_gb: int = 0
    free_hugepages_gb: int = 0
    res_hugepages_gb: int = 0


class NodeGpu:
    """One GPU device (reference: Node.py:74-97). ``used`` is packed on
    the owning node after _pack_state (see NodeCpuCore)."""

    __slots__ = ("kind", "device_id", "numa_node", "pciesw", "slot",
                 "_used", "_arr")

    def __init__(self, kind: GpuKind, device_id: int, numa_node: int,
                 pciesw: int, used: bool = False):
        self.kind = kind
        self.device_id = device_id
        self.numa_node = numa_node
        self.pciesw = pciesw
        self.slot = -1  # position in HostNode.gpus, set by _pack_state
        self._used = used
        self._arr: Any = None

    @property
    def used(self) -> bool:
        a = self._arr
        return self._used if a is None else bool(a[self.slot])

    @used.setter
    def used(self, v: bool) -> None:
        a = self._arr
        if a is None:
            self._used = bool(v)
        else:
            a[self.slot] = v

    def __repr__(self) -> str:
        return (f"NodeGpu({self.kind}, device_id={self.device_id}, "
                f"numa={self.numa_node}, used={self.used})")


class HostNode:
    """Per-node topology + claim/release bookkeeping (reference: Node.py:100-853)."""

    def __init__(self, name: str, active: bool = True):
        self.logger = get_logger(__name__)
        self.name = name
        self.active = active
        self.addr = ""
        self.maintenance = False
        self.groups: List[str] = ["default"]
        # hardware-generation class (policy/classes.py): set at label
        # parse — explicit NHD_NODE_CLASS label, else GPU-model-derived,
        # else "cpu". Scored by the heterogeneity-aware policy terms;
        # "default" scores as the uniform baseline.
        self.node_class = "default"
        self.cores: List[NodeCpuCore] = []
        self.gpus: List[NodeGpu] = []
        self.nics: List[NodeNic] = []
        self.mem = NodeMemory()
        self.sockets = 0
        self.numa_nodes = 0
        self.smt_enabled = False
        self.cores_per_proc = 0
        self.reserved_cores: List[int] = []
        self.data_vlan = 0
        self.gwip = "0.0.0.0/32"
        self.pod_info: Dict[Tuple[str, str], PodTopology] = {}
        # -inf: a node that never took a placement is never "busy", whatever
        # clock epoch the caller uses (the reference's 0.0 init relies on
        # time.monotonic() being large, Node.py:115)
        self._busy_time = float("-inf")
        # packed dynamic state (built by _pack_state after label parse):
        # the authoritative store of used/bandwidth flags, exposed through
        # the NodeCpuCore/NodeGpu/NodeNic properties, so batch projection
        # (solver/encode.py) and write-back (FastCluster.sync_to_nodes)
        # are vector ops
        self._core_used: Any = None   # [L] bool
        self._core_socket: Any = None  # [L] int8
        self._gpu_used: Any = None    # [n_gpus] bool
        self._gpu_numa: Any = None    # [n_gpus] int32
        self._gpu_sw: Any = None      # [n_gpus] int64 (raw pciesw)
        self._gpu_devid: Any = None   # [n_gpus] int32
        self._nic_bw: Any = None      # [n_nics, 2] float64 (rx, tx used)
        self._nic_pods: Any = None    # [n_nics] int32
        self._nic_u: Any = None       # [n_nics] int32 (numa_node)
        self._nic_k: Any = None       # [n_nics] int32 (per-NUMA ordinal)
        self._nic_cap: Any = None     # [n_nics] float64 (schedulable Gbps)
        self._nic_sw: Any = None      # [n_nics] int64 (raw pciesw)
        self._n_switches = 0     # distinct PCIe switches on this node
        self._gpu_sw_dense: Any = None  # [n_gpus] int64 dense switch ids
        self._nic_sw_dense: Any = None  # [n_nics] int64 dense switch ids
        self._nic_cnt: Any = None     # [max_numa+1] int32 NICs per NUMA

    # packed-topology generation (see pack_generation_key); 0 = never packed
    _pack_gen = 0

    def _pack_state(self) -> None:
        """Move the dynamic allocation flags into packed per-node arrays
        (the component objects become views; see NodeCpuCore). Re-run on
        every label reparse — component lists are rebuilt there.

        Core packing requires the identity layout _init_cores builds
        (cores[i].core == i; SMT sibling of physical core c is c + phys) —
        the vectorized free queries index by position. A hand-assembled
        node with a different layout keeps per-object flags and the loop
        fallbacks."""
        import numpy as np

        # new generation: any static cache keyed on the previous packing
        # must miss, even if numpy reuses freed arrays' addresses
        self._pack_gen = next(_PACK_GEN_COUNTER)

        phys = self.cores_per_proc * self.sockets
        identity = all(c.core == i for i, c in enumerate(self.cores)) and (
            not self.smt_enabled
            or (
                len(self.cores) >= 2 * phys
                and all(
                    self.cores[c].sibling == c + phys for c in range(phys)
                )
            )
        )
        if identity:
            self._core_used = np.array([c.used for c in self.cores], bool)
            self._core_socket = np.array(
                [c.socket for c in self.cores], np.int8
            )
            for c in self.cores:
                c._arr = self._core_used
        else:
            self._core_used = None
            self._core_socket = None
            for c in self.cores:
                if c._arr is not None:
                    c._used = bool(c._arr[c.core])
                    c._arr = None

        self._gpu_used = np.array([g.used for g in self.gpus], bool)
        self._gpu_numa = np.array([g.numa_node for g in self.gpus], np.int32)
        self._gpu_sw = np.array([g.pciesw for g in self.gpus], np.int64)
        self._gpu_devid = np.array([g.device_id for g in self.gpus], np.int32)
        for j, g in enumerate(self.gpus):
            g.slot = j
            g._arr = self._gpu_used

        nb = len(self.nics)
        self._nic_bw = np.zeros((nb, 2), np.float64)
        self._nic_pods = np.zeros(nb, np.int32)
        self._nic_u = np.array([n.numa_node for n in self.nics], np.int32)
        self._nic_k = np.array([n.idx for n in self.nics], np.int32)
        self._nic_cap = np.array(
            [n.speed_gbps * NIC_BW_AVAIL_PERCENT for n in self.nics],
            np.float64,
        )
        self._nic_sw = np.array([n.pciesw for n in self.nics], np.int64)
        for s, n in enumerate(self.nics):
            self._nic_bw[s, 0] = n.speed_used[0]
            self._nic_bw[s, 1] = n.speed_used[1]
            self._nic_pods[s] = n.pods_used
            n.slot = s
            n._bw = self._nic_bw
            n._pods = self._nic_pods

        # dense per-node PCIe switch ids (sorted order for determinism) —
        # static, precomputed so encode_cluster's per-batch re-projection
        # (solver/encode.py refresh_node_row) is pure vector ops
        switches = sorted(set(self._gpu_sw.tolist()) | set(self._nic_sw.tolist()))
        sw_id = {sw: j for j, sw in enumerate(switches)}
        self._n_switches = len(switches)
        self._gpu_sw_dense = np.array(
            [sw_id[s] for s in self._gpu_sw.tolist()], np.int64
        )
        self._nic_sw_dense = np.array(
            [sw_id[s] for s in self._nic_sw.tolist()], np.int64
        )
        # NICs per NUMA node (max ordinal + 1), indexed by numa id
        u_max = int(self._nic_u.max(initial=-1)) + 1
        self._nic_cnt = np.zeros(u_max, np.int32)
        if nb:
            np.maximum.at(self._nic_cnt, self._nic_u, self._nic_k + 1)

    # ------------------------------------------------------------------
    # label parsing
    # ------------------------------------------------------------------

    def parse_labels(self, labels: Dict[str, str]) -> bool:
        """Initialize all hardware state from node labels
        (reference: Node.py:468-487, same stage order)."""
        ok = (
            self._init_groups(labels)
            and self._init_maintenance(labels)
            and self._init_cores(labels)
            and self._init_nics(labels)
            and self._init_gpus(labels)
            and self._init_misc(labels)
        )
        if ok:
            self._init_node_class(labels)
            self._pack_state()
        return ok

    def _init_node_class(self, labels: Dict[str, str]) -> None:
        """Hardware-generation class for heterogeneity-aware scoring
        (policy/classes.py): the explicit NHD_NODE_CLASS label wins;
        otherwise derive from the GPU model inventory (the axis
        generations actually differ on), else "cpu". Runs after
        _init_gpus so the derivation sees the parsed inventory."""
        explicit = labels.get(NODE_CLASS_LABEL)
        if explicit:
            self.node_class = explicit
        elif self.gpus:
            self.node_class = f"gpu-{self.gpus[0].kind.name.lower()}"
        else:
            self.node_class = "cpu"

    def _init_groups(self, labels: Dict[str, str]) -> bool:
        """NHD_GROUP label: dot-separated group list (reference: Node.py:312-321)."""
        self.groups = labels["NHD_GROUP"].split(".") if "NHD_GROUP" in labels else ["default"]
        return True

    @staticmethod
    def maintenance_from_labels(labels: Dict[str, str]) -> bool:
        """Any maintenance label value other than 'not_scheduled' means the
        node is in maintenance (reference: Node.py:134-142)."""
        value = labels.get(MAINTENANCE_LABEL)
        return value is not None and value.lower() != "not_scheduled"

    def _init_maintenance(self, labels: Dict[str, str]) -> bool:
        self.maintenance = HostNode.maintenance_from_labels(labels)
        return True

    def _init_cores(self, labels: Dict[str, str]) -> bool:
        """Core/socket/SMT layout from NFD extras (reference: Node.py:327-374).

        Logical numbering is the Linux convention the reference assumes:
        physical cores 0..N-1, their SMT siblings N..2N-1, socket is the
        row-major block (c % N) // (N / sockets).
        """
        if _CPU_CORES_LABEL not in labels or _CPU_SOCKETS_LABEL not in labels:
            self.logger.error(f"node {self.name}: missing CPU labels")
            return False

        self.sockets = int(labels[_CPU_SOCKETS_LABEL])
        phys_cores = int(labels[_CPU_CORES_LABEL])
        self.smt_enabled = _CPU_SMT_LABEL in labels
        self.numa_nodes = self.sockets  # Intel-style 1 NUMA/socket (Node.py:336)
        self.cores_per_proc = phys_cores // self.sockets

        n_logical = phys_cores * 2 if self.smt_enabled else phys_cores
        self.cores = []
        for c in range(n_logical):
            socket = int((c % phys_cores) // (phys_cores / self.sockets))
            sibling = -1
            if self.smt_enabled:
                sibling = c + phys_cores if c < phys_cores else c - phys_cores
            self.cores.append(NodeCpuCore(c, socket, sibling))

        if _CPU_ISOL_LABEL in labels:
            # '_' separates multiple cpuset ranges inside one label value
            # (reference: Node.py:352-370). Cores NOT isolated belong to the
            # OS and are permanently reserved.
            isolated: List[int] = []
            for rng in labels[_CPU_ISOL_LABEL].split("_"):
                isolated.extend(parse_range_list(rng))
            non_isol = set(range(n_logical)) - set(isolated)
            for c in non_isol:
                self.cores[c].used = True
                self.reserved_cores.append(c)
        return True

    def _init_nics(self, labels: Dict[str, str]) -> bool:
        """NIC inventory from positional dotted labels (reference: Node.py:376-420):
        ``feature.node.kubernetes.io/nfd-extras-nic.<ifname>.<vendor>.<mac>.<speed>Mbs.<numa>.<pcisw:hex>.<card:hex>.<port>``
        (the io/ segment makes ifname the 5th dot-field, Node.py:392).
        SR-IOV physical functions and slow/down links are excluded."""
        pfs = [l.split(".")[5] for l in labels if _SRIOV_LABEL_PREFIX in l]

        for label in labels:
            if _NIC_LABEL_PREFIX not in label:
                continue
            p = label.split(".")
            ifname, vendor, mac, speed = p[4], p[5], p[6], p[7]
            numa_node, pciesw, card, port = int(p[8]), int(p[9], 16), int(p[10], 16), int(p[11])

            if ifname in pfs:
                continue  # PFs carry the VFs; not directly schedulable
            if "Mbs" not in speed:
                continue  # link down / speed unknown (reference: Node.py:399-401)
            speed_mbps = int(speed[: speed.index("Mbs")])
            if speed_mbps < SCHEDULABLE_NIC_SPEED_THRESH_MBPS:
                continue

            self.nics.append(
                NodeNic(ifname, format_mac(mac), vendor, speed_mbps / 1e3,
                        numa_node, pciesw, card, port)
            )

        # Per-NUMA ordinals, in label-encounter order (reference: Node.py:412-418).
        if self.nics:
            counters = [0] * (max(n.numa_node for n in self.nics) + 1)
            for nic in self.nics:
                nic.idx = counters[nic.numa_node]
                counters[nic.numa_node] += 1
        return True

    def _init_gpus(self, labels: Dict[str, str]) -> bool:
        """GPU inventory (reference: Node.py:422-432):
        ``feature.node.kubernetes.io/nfd-extras-gpu.<device_id>.<model>.<numa>.<pcisw:hex>``."""
        for label in labels:
            if _GPU_LABEL_PREFIX not in label:
                continue
            p = label.split(".")
            self.gpus.append(
                NodeGpu(GpuKind.from_model_string(p[5]), int(p[4]), int(p[6]), int(p[7], 16))
            )
        return True

    def _init_misc(self, labels: Dict[str, str]) -> bool:
        """Site labels: data VLAN + default GW mandatory, reserved hugepages
        optional (reference: Node.py:434-454)."""
        if "DATA_PLANE_VLAN" not in labels or "DATA_DEFAULT_GW" not in labels:
            self.logger.error(f"node {self.name}: missing VLAN/GW labels")
            return False
        self.data_vlan = int(labels["DATA_PLANE_VLAN"])
        self.gwip = labels["DATA_DEFAULT_GW"]
        if "RES_HUGEPAGES_GB" in labels:
            self.mem.res_hugepages_gb = int(labels["RES_HUGEPAGES_GB"])
        return True

    def set_hugepages(self, alloc: int, free: int) -> bool:
        """Capacity from the K8s allocatable numbers, minus the node's
        reserved amount (reference: Node.py:489-493)."""
        self.mem.ttl_hugepages_gb = alloc
        self.mem.alloc_hugepages_gb = free
        self.mem.free_hugepages_gb = free - self.mem.res_hugepages_gb
        return True

    def set_groups(self, groups: str) -> None:
        """Reference: Node.py:308-310."""
        self.groups = groups.split(".")

    # ------------------------------------------------------------------
    # free-resource queries (consumed by the matcher)
    # ------------------------------------------------------------------

    def _ensure_packed(self) -> None:
        """Lazily pack nodes built outside parse_labels (hand-assembled in
        tests/sims); re-packs when a component *list* was swapped out
        (detected by length or by the first element not being wired to
        this node's arrays). Replacing individual elements of a packed
        list is NOT detected — mutate the element's fields (e.g.
        ``used``) instead, or call _pack_state() after surgery."""
        if (
            self._gpu_used is None
            or len(self._gpu_used) != len(self.gpus)
            or (self.gpus and self.gpus[0]._arr is not self._gpu_used)
            or len(self._nic_pods) != len(self.nics)
            or (self.nics and self.nics[0]._pods is not self._nic_pods)
            or (
                self._core_used is not None
                and (
                    len(self._core_used) != len(self.cores)
                    or (
                        self.cores
                        and self.cores[0]._arr is not self._core_used
                    )
                )
            )
        ):
            self._pack_state()

    def free_cpu_cores_per_numa(self) -> List[int]:
        """Fully-free *physical* cores per NUMA node. On SMT nodes a physical
        core counts only when both logical siblings are unused — no partial
        multi-tenancy (reference: Node.py:250-264). Vectorized over the
        packed used[] (the sibling of physical core c is c + phys, the
        layout _init_cores builds); loop fallback for non-identity nodes."""
        import numpy as np

        self._ensure_packed()
        phys = self.cores_per_proc * self.sockets
        used = self._core_used
        if used is None:
            free = [0] * self.numa_nodes
            for c in range(phys):
                core = self.cores[c]
                if core.used:
                    continue
                if self.smt_enabled and self.cores[core.sibling].used:
                    continue
                free[core.socket] += 1
            return free
        if self.smt_enabled:
            free_phys = ~used[:phys] & ~used[phys:2 * phys]
        else:
            free_phys = ~used[:phys]
        counts = np.bincount(
            self._core_socket[:phys][free_phys].astype(np.int64),
            minlength=self.numa_nodes,
        )
        return counts[: self.numa_nodes].tolist()

    def free_cpu_core_count(self) -> int:
        """Reference: Node.py:229-236 (logical count with both-siblings-free rule)."""
        self._ensure_packed()
        used = self._core_used
        if used is None:
            if self.smt_enabled:
                return sum(
                    1 for c in self.cores
                    if not c.used and not self.cores[c.sibling].used
                )
            return sum(1 for c in self.cores if not c.used)
        if self.smt_enabled:
            phys = self.cores_per_proc * self.sockets
            pair_free = ~used[:phys] & ~used[phys:2 * phys]
            return int(pair_free.sum()) * 2
        return int((~used).sum())

    def free_gpus_per_numa(self) -> List[int]:
        """Reference: Node.py:456-462."""
        import numpy as np

        self._ensure_packed()
        counts = np.bincount(
            self._gpu_numa[~self._gpu_used].astype(np.int64),
            minlength=self.numa_nodes,
        )
        return counts[: self.numa_nodes].tolist()

    def free_gpu_count(self) -> int:
        self._ensure_packed()
        return int((~self._gpu_used).sum())

    def total_gpus(self) -> int:
        return len(self.gpus)

    def total_cpus(self) -> int:
        return len(self.cores)

    def free_gpus_per_pciesw(self) -> Dict[int, int]:
        """Free GPU count per PCIe switch (reference: Node.py:266-273)."""
        out: Dict[int, int] = {}
        for g in self.gpus:
            if not g.used:
                out[g.pciesw] = out.get(g.pciesw, 0) + 1
        return out

    def nic_pciesw_per_numa(self) -> List[Dict[int, int]]:
        """Per NUMA node: NIC ordinal → PCIe switch (reference: Node.py:275-281)."""
        out: List[Dict[int, int]] = [{} for _ in range(self.numa_nodes)]
        for n in self.nics:
            out[n.numa_node][n.idx] = n.pciesw
        return out

    def free_nic_bw_per_numa(self) -> List[List[List[float]]]:
        """Per NUMA node, per NIC ordinal: [rx, tx] schedulable headroom in
        Gbps (reference: Node.py:283-296)."""
        out: List[List[List[float]]] = [[] for _ in range(self.numa_nodes)]
        for n in self.nics:
            if n.numa_node >= self.numa_nodes:
                self.logger.warning(
                    f"node {self.name}: NIC {n.mac} on unexpected NUMA {n.numa_node}"
                )
                continue
            out[n.numa_node].append(list(n.free_bw()))
        return out

    # ------------------------------------------------------------------
    # lookups
    # ------------------------------------------------------------------

    def nic_by_mac(self, mac: str) -> Optional[NodeNic]:
        return next((n for n in self.nics if n.mac == mac), None)

    def nic_by_ifname(self, ifname: str) -> Optional[NodeNic]:
        return next((n for n in self.nics if n.ifname == ifname), None)

    def nic_by_numa_idx(self, numa: int, idx: int) -> Optional[NodeNic]:
        """Reference: Node.py:657-661."""
        return next(
            (n for n in self.nics if n.idx == idx and n.numa_node == numa), None
        )

    def gpu_by_device_id(self, device_id: int) -> Optional[NodeGpu]:
        return next((g for g in self.gpus if g.device_id == device_id), None)

    def next_free_gpu(self, numa: int) -> Optional[NodeGpu]:
        """Reference: Node.py:495-500."""
        return next(
            (g for g in self.gpus if g.numa_node == numa and not g.used), None
        )

    def free_pci_gpu_for_nic(self, nic: NodeNic) -> Optional[NodeGpu]:
        """First free GPU sharing the NIC's PCIe switch (reference: Node.py:648-655)."""
        return next(
            (g for g in self.gpus if g.pciesw == nic.pciesw and not g.used), None
        )

    def free_cpu_batch(self, numa: int, num: int, smt: SmtMode) -> List[int]:
        """Hand out ``num`` logical cores on ``numa`` in core order. SMT-ON
        requests take sibling pairs together; SMT-OFF requests take one
        logical core of an otherwise-free pair (reference: Node.py:502-519).

        Deviation: cores handed out earlier in the same call are tracked, so
        an over-ask returns a short list instead of duplicates (the
        reference re-issues a pair's cores when demand exceeds free pairs,
        defeating its caller's shortfall check) — and an SMT-OFF request
        never receives both siblings of one physical core.
        """
        out: List[int] = []
        taken: set = set()
        for c in self.cores:
            if num <= 0:
                break
            if c.socket != numa or c.used or c.core in taken:
                continue
            if self.smt_enabled:
                if self.cores[c.sibling].used or c.sibling in taken:
                    continue
                if smt == SmtMode.ON and num >= 2:
                    out.extend([c.core, c.sibling])
                    taken.update((c.core, c.sibling))
                    num -= 2
                else:
                    out.append(c.core)
                    taken.update((c.core, c.sibling))
                    num -= 1
            else:
                out.append(c.core)
                taken.add(c.core)
                num -= 1
        return out

    # ------------------------------------------------------------------
    # claim / release
    # ------------------------------------------------------------------

    def reset_resources(self) -> None:
        """Back to a blank slate, keeping OS-reserved cores claimed
        (reference: Node.py:144-161)."""
        for c in self.cores:
            if c.core not in self.reserved_cores:
                c.used = False
        for g in self.gpus:
            g.used = False
        for n in self.nics:
            n.pods_used = 0
            n.speed_used = [0.0, 0.0]
        # allocatable minus reserve, NOT raw capacity: the reference resets
        # to ttl (Node.py:159), silently re-granting the OS reserve on every
        # drift repair
        self.mem.free_hugepages_gb = (
            self.mem.alloc_hugepages_gb - self.mem.res_hugepages_gb
        )
        self.pod_info.clear()

    def _topology_core_ids(self, top: PodTopology) -> List[int]:
        """Every physical core id a solved topology names."""
        ids: List[int] = []
        for pg in top.proc_groups:
            ids.extend(c.core for c in pg.misc_cores)
            ids.extend(c.core for c in pg.proc_cores)
            for gpu in pg.gpus:
                ids.extend(c.core for c in gpu.cpu_cores)
        ids.extend(c.core for c in top.misc_cores)
        return ids

    def claim_from_topology(self, top: PodTopology) -> bool:
        """Mark every resource named in a (solved) topology as used — the
        restart-replay path (reference: Node.py:530-585).

        Validate-then-apply: a stale annotation naming out-of-range or
        negative core ids (node shrunk/relabeled between restarts) rejects
        the whole claim with no partial mutation, instead of crashing the
        scheduler thread or leaking half-claimed cores.
        """
        core_ids = self._topology_core_ids(top)
        for cid in core_ids:
            if not 0 <= cid < len(self.cores):
                self.logger.error(f"node {self.name}: core {cid} out of range")
                return False
        for cid in core_ids:
            self.cores[cid].used = True
        for pg in top.proc_groups:
            for gpu in pg.gpus:
                dev = self.gpu_by_device_id(gpu.device_id)
                if dev is not None:
                    dev.used = True
        # bandwidth accrues per rx/tx pair; pods_used once per distinct NIC
        # per pod — matching the live claim path (claim_nic_pods), where the
        # reference is asymmetric and can drive pods_used negative
        claimed_macs = set()
        for pair in top.nic_pairs:
            nic = self.nic_by_mac(pair.mac)
            if nic is None:
                self.logger.error(f"node {self.name}: no NIC with MAC {pair.mac}")
                continue
            nic.speed_used[0] += pair.rx_core.nic_speed
            nic.speed_used[1] += pair.tx_core.nic_speed
            if pair.mac not in claimed_macs:
                claimed_macs.add(pair.mac)
                nic.pods_used += 1
        if top.hugepages_gb > 0:
            self.mem.free_hugepages_gb -= top.hugepages_gb
        return True

    def release_from_topology(self, top: PodTopology) -> None:
        """Inverse of claim_from_topology (reference: Node.py:587-636).
        While the flight recorder is on, each call adds to its
        ``release_from_topology`` tally (count and seconds)."""
        rec = get_recorder()
        if rec is None:
            self._release(top)
            return
        t0 = time.perf_counter()
        self._release(top)
        rec.tally("release_from_topology", time.perf_counter() - t0)

    def _release(self, top: PodTopology) -> None:
        for pg in top.proc_groups:
            for core in pg.misc_cores + pg.proc_cores:
                self.cores[core.core].used = False
            for gpu in pg.gpus:
                dev = self.gpu_by_device_id(gpu.device_id)
                if dev is not None:
                    dev.used = False
                for core in gpu.cpu_cores:
                    self.cores[core.core].used = False
        for core in top.misc_cores:
            self.cores[core.core].used = False
        released_macs = set()
        for pair in top.nic_pairs:
            nic = self.nic_by_mac(pair.mac)
            if nic is None:
                self.logger.error(f"node {self.name}: no NIC with MAC {pair.mac}")
                continue
            nic.speed_used[0] -= pair.rx_core.nic_speed
            nic.speed_used[1] -= pair.tx_core.nic_speed
            # one pods_used per distinct NIC, mirroring the claim side —
            # the reference decrements per pair (Node.py:621-631), which
            # underflows for multi-pair-per-NIC pods and later masks an
            # in-use NIC as free
            if pair.mac not in released_macs:
                released_macs.add(pair.mac)
                nic.pods_used -= 1
        if top.hugepages_gb > 0:
            self.mem.free_hugepages_gb += top.hugepages_gb

    def claim_nic_pods(self, nic_indices: List[int]) -> None:
        """Mark NICs as serving one more pod (reference: Node.py:644-646)."""
        for i in nic_indices:
            self.nics[i].pods_used += 1

    def nad_names_from_indices(self, nic_indices: List[int]) -> List[str]:
        """Interface names for the CNI NetworkAttachmentDefinition annotation
        (reference: Node.py:638-642)."""
        return [self.nics[i].ifname for i in nic_indices]

    # ------------------------------------------------------------------
    # physical assignment
    # ------------------------------------------------------------------

    def assign_physical_ids(
        self, mapping: Dict[str, tuple], top: PodTopology
    ) -> List[Tuple[int, float, NicDir]]:
        """Turn a NUMA/NIC mapping from the matcher into concrete core, GPU,
        and NIC assignments, mutating both this node's state and ``top``
        (reference: Node.py:663-841).

        mapping = {'gpu': numa-per-group, 'cpu': numa-per-group + misc numa,
                   'nic': (numa, nic_ordinal) per group}

        Returns the list of (nic_index, speed, dir) tuples consumed; on any
        shortfall raises AssignmentError after unwinding partial claims.
        """
        used_cpus: List[int] = []
        used_gpus: List[int] = []
        used_nics: List[Tuple[int, float, NicDir]] = []
        hugepages_taken = False

        try:
            for pi, pg in enumerate(top.proc_groups):
                if pg.vlan is not None:
                    pg.vlan.vlan = self.data_vlan

                numa = mapping["gpu"][pi]
                want = pg.cpu_proc_request()
                group_cpus = self.free_cpu_batch(numa, want, pg.proc_smt)
                if len(group_cpus) != want:
                    raise AssignmentError(
                        f"wanted {want} proc cores on numa {numa}, got {len(group_cpus)}"
                    )

                nic_numa, nic_ord = mapping["nic"][pi]
                nic = self.nic_by_numa_idx(nic_numa, nic_ord)
                if nic is None and (pg.nic_bw_request() != (0, 0) or pg.gpus):
                    raise AssignmentError(f"no NIC at numa {nic_numa} idx {nic_ord}")

                cursor = 0
                for gpu in pg.gpus:
                    # Prefer a GPU sharing the NIC's PCIe switch even in NUMA
                    # mode, to keep GPUDirect capacity for later pods
                    # (reference: Node.py:688-716).
                    dev = self.free_pci_gpu_for_nic(nic) if nic is not None else None
                    if dev is None:
                        if top.map_mode == MapMode.PCI:
                            raise AssignmentError(
                                f"no free GPU on PCIe switch of NIC {nic and nic.ifname}"
                            )
                        dev = self.next_free_gpu(numa)
                    if dev is None:
                        raise AssignmentError("mapping promised a GPU but none free")

                    gpu.device_id = dev.device_id
                    dev.used = True
                    used_gpus.append(dev.device_id)
                    for feeder in gpu.cpu_cores:
                        feeder.core = group_cpus[cursor]
                        self.cores[feeder.core].used = True
                        used_cpus.append(feeder.core)
                        cursor += 1

                for core in pg.proc_cores:
                    core.core = group_cpus[cursor]
                    self.cores[core.core].used = True
                    used_cpus.append(core.core)
                    cursor += 1

                    if core.nic_dir in (NicDir.RX, NicDir.TX):
                        if nic is None:
                            raise AssignmentError("NIC-serving core without a NIC")
                        nic_index = self.nics.index(nic)
                        dir_idx = 0 if core.nic_dir == NicDir.RX else 1
                        nic.speed_used[dir_idx] += core.nic_speed
                        used_nics.append((nic_index, core.nic_speed, core.nic_dir))

                        pair = top.nic_pair_for_core(core)
                        if pair is None:
                            raise AssignmentError(
                                f"core {core.name} not in any NIC pair"
                            )
                        pair.mac = nic.mac

                if cursor != len(group_cpus):
                    raise AssignmentError("leftover proc cores after assignment")

                helpers = self.free_cpu_batch(numa, len(pg.misc_cores), pg.helper_smt)
                if len(helpers) != len(pg.misc_cores):
                    raise AssignmentError(
                        f"wanted {len(pg.misc_cores)} helper cores, got {len(helpers)}"
                    )
                for helper, core_id in zip(pg.misc_cores, helpers):
                    helper.core = core_id
                    self.cores[core_id].used = True
                    used_cpus.append(core_id)

            top.set_data_default_gw(self.gwip)

            if top.hugepages_gb > 0:
                self.mem.free_hugepages_gb -= top.hugepages_gb
                hugepages_taken = True

            # Top-level misc cores use the final CPU-mapping slot
            # (reference: Node.py:798-815; misc-as-last-element convention).
            misc = self.free_cpu_batch(
                mapping["cpu"][-1], len(top.misc_cores), top.misc_cores_smt
            )
            if len(misc) != len(top.misc_cores):
                raise AssignmentError(
                    f"wanted {len(top.misc_cores)} misc cores, got {len(misc)}"
                )
            for mc, core_id in zip(top.misc_cores, misc):
                mc.core = core_id
                self.cores[core_id].used = True
                used_cpus.append(core_id)

            if top.ctrl_vlan is not None:
                top.ctrl_vlan.vlan = self.data_vlan

        except AssignmentError:
            # Unwind partial claims so the node is exactly as before. The
            # reference's unwind (Node.py:825-837) carries two bookkeeping
            # bugs (GPUs un-marked by device id used as a list index; NIC
            # speed restored from the wrong operand) and leaks the hugepage
            # deduction; this implements the intended semantics.
            for c in used_cpus:
                self.cores[c].used = False
            for g in used_gpus:
                dev = self.gpu_by_device_id(g)
                if dev is not None:
                    dev.used = False
            for nic_index, speed, direction in used_nics:
                dir_idx = 0 if direction == NicDir.RX else 1
                self.nics[nic_index].speed_used[dir_idx] -= speed
            if hugepages_taken:
                self.mem.free_hugepages_gb += top.hugepages_gb
            raise

        return used_nics

    # ------------------------------------------------------------------
    # pod tracking + rate limiting
    # ------------------------------------------------------------------

    def add_scheduled_pod(self, pod: str, ns: str, top: PodTopology) -> None:
        self.pod_info[(pod, ns)] = top

    def remove_scheduled_pod(self, pod: str, ns: str) -> None:
        self.pod_info.pop((pod, ns), None)

    def pod_present(self, pod: str, ns: str) -> bool:
        return (pod, ns) in self.pod_info

    def total_pods(self) -> int:
        return len(self.pod_info)

    def set_busy(self, now: Optional[float] = None) -> None:
        """Stamp a placement for the GPU-pod back-off (reference: Node.py:843-845)."""
        self._busy_time = time.monotonic() if now is None else now

    def is_busy(self, now: Optional[float] = None) -> bool:
        """Reference: Node.py:847-850."""
        return self.busy_seconds(now) < MIN_BUSY_SECS

    def busy_seconds(self, now: Optional[float] = None) -> float:
        t = time.monotonic() if now is None else now
        return t - self._busy_time

    def nic_used_speeds(self) -> List[List[float]]:
        return [list(n.speed_used) for n in self.nics]


class AssignmentError(RuntimeError):
    """Raised when physical assignment cannot satisfy a promised mapping
    (the reference signals this with IndexError, Node.py:687,825)."""
