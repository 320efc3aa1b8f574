"""Vectorized physical-ID assignment for batch scheduling.

HostNode.assign_physical_ids walks Python object graphs per pod (~0.4 ms);
at 10k-pod gang scale that dwarfs the batched solve. FastCluster keeps the
allocation state (core/GPU/NIC/hugepage occupancy) in packed numpy arrays
and reproduces the same policies with a handful of vector ops per winner:

* cores: first-fit in core order; SMT-ON takes sibling pairs interleaved
  [c, c+P, ...], SMT-OFF takes one logical core per fully-free pair
  (HostNode.free_cpu_batch semantics, reference Node.py:502-519);
* GPUs: first free GPU on the chosen NIC's PCIe switch, else first free on
  the group's NUMA node (reference Node.py:648-655,495-500);
* NICs: joint rx/tx bandwidth accounting, pods_used marking.

Gather-then-commit per winner: all picks are resolved against a scratch
overlay first, so a failure (e.g. the PCI quirk, see oracle.py) leaves the
state untouched — no unwind pass.

Equivalence with HostNode.assign_physical_ids is property-tested
(tests/test_fast_assign.py); `sync_to_nodes` writes the final state back to
the HostNode mirror, which stays the durable source of truth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import MapMode, NicDir, PodTopology, SmtMode


class FastAssignError(RuntimeError):
    """Assignment could not satisfy the promised mapping (state untouched)."""


@dataclass
class GroupAssignment:
    numa: int
    group_cpus: List[int]        # proc cores incl. GPU feeders, hand-out order
    helper_cpus: List[int]
    gpu_devids: List[int]
    nic_uk: Tuple[int, int]
    nic_flat: int                # index into HostNode.nics, -1 if none
    nic_mac: str = ""
    gpu_rows: List[int] = field(default_factory=list)  # FastCluster gpu slots


@dataclass
class AssignRecord:
    """Everything needed to materialize a solved PodTopology later."""

    node_index: int
    node_name: str
    groups: List[GroupAssignment] = field(default_factory=list)
    misc_cpus: List[int] = field(default_factory=list)
    data_vlan: int = 0
    gwip: str = ""
    nic_list: List[Tuple[int, float, NicDir]] = field(default_factory=list)


class FastCluster:
    """Packed allocation state for a set of HostNodes."""

    def __init__(self, nodes: Dict[str, HostNode], U: int, K: int, arrays=None,
                 static_cache: Optional[dict] = None):
        self.arrays = arrays  # optional ClusterArrays kept in sync on assign
        self.names = list(nodes.keys())
        self.node_objs = [nodes[n] for n in self.names]
        N = len(self.node_objs)
        self.U, self.K = U, K
        for node in self.node_objs:
            node._ensure_packed()

        # --- static topology matrices (never mutated by assignment) ---
        # Shared across FastCluster builds over the same unchanged node set
        # via ``static_cache`` (one dict per BatchScheduler): a label
        # reparse rebuilds a node's packed arrays, so array identity is the
        # generation token; the cache entry pins node_objs, keeping the
        # id()s valid (see _bucket_arrays for why pinning matters).
        from nhd_tpu_torch.core.node import pack_generation_key

        key = pack_generation_key(self.node_objs, U, K)
        st = None
        if static_cache is not None:
            ent = static_cache.get("entry")
            if ent is not None and ent["key"] == key:
                st = ent
        if st is None:
            st = self._build_static(key)
            if static_cache is not None:
                static_cache["entry"] = st
        self.P = st["P"]
        self.L = st["L"]
        self.smt = st["smt"]
        self.phys = st["phys"]
        self.core_socket = st["core_socket"]
        self.gpu_numa = st["gpu_numa"]
        self.gpu_sw = st["gpu_sw"]
        self.gpu_devid = st["gpu_devid"]
        self.n_gpus = st["n_gpus"]
        self.nic_flat = st["nic_flat"]
        self.nic_cap = st["nic_cap"]
        self.nic_sw = st["nic_sw"]
        self.gpu_sw_dense = st["gpu_sw_dense"]
        self._nic_idx = st["nic_idx"]
        GM = self.gpu_numa.shape[1]
        L = self.L

        # --- dynamic allocation state (fresh per build) ---
        self.core_used = np.ones((N, L), bool)       # pad: used
        self.gpu_used = np.ones((N, GM), bool)
        self.nic_rx_used = np.zeros((N, U, K), np.float64)
        self.nic_tx_used = np.zeros((N, U, K), np.float64)
        self.nic_pods = np.zeros((N, U, K), np.int32)
        self.hp_free = np.zeros(N, np.int64)
        # homogeneous fast path: when every node shares node0's packed
        # layout (the federation/bench norm — one SKU per tile), the
        # whole build collapses to a few np.stack calls; the per-node
        # fancy-index loop below was ~45 µs/node, the dominant cost of
        # an 8192-node streaming-tile context (~0.4 s)
        homog = False
        if N and self.node_objs[0]._core_used is not None:
            n0 = self.node_objs[0]
            uu0, kk0, valid0 = self._nic_idx[0]
            nc0, ng0, nn0 = len(n0.cores), len(n0.gpus), len(n0.nics)
            homog = all(
                n._core_used is not None
                and len(n.cores) == nc0
                and len(n.gpus) == ng0
                and len(n.nics) == nn0
                for n in self.node_objs
            ) and all(
                (u is None and uu0 is None)
                or (
                    u is not None and uu0 is not None
                    and np.array_equal(u, uu0) and np.array_equal(k, kk0)
                    and np.array_equal(v, valid0)
                )
                for u, k, v in self._nic_idx
            )
        self._sync_plan = None
        if homog:
            self.core_used[:, :nc0] = np.stack(
                [n._core_used for n in self.node_objs]
            )
            if ng0:
                self.gpu_used[:, :ng0] = np.stack(
                    [n._gpu_used for n in self.node_objs]
                )
            if nn0 and uu0 is not None:
                bw = np.stack([n._nic_bw for n in self.node_objs])
                pods_m = np.stack([n._nic_pods for n in self.node_objs])
                self.nic_rx_used[:, uu0, kk0] = bw[:, valid0, 0]
                self.nic_tx_used[:, uu0, kk0] = bw[:, valid0, 1]
                self.nic_pods[:, uu0, kk0] = pods_m[:, valid0]
            self.hp_free[:] = [
                n.mem.free_hugepages_gb for n in self.node_objs
            ]
            # prebuilt sync bindings (see sync_to_nodes)
            self._sync_plan = (
                nc0, ng0,
                uu0 if nn0 else None, kk0, valid0,
                [n._core_used for n in self.node_objs],
                [n._gpu_used for n in self.node_objs],
                [n._nic_bw for n in self.node_objs],
                [n._nic_pods for n in self.node_objs],
                [n.mem for n in self.node_objs],
            )
        else:
            for i, node in enumerate(self.node_objs):
                if node._core_used is not None:
                    self.core_used[i, : len(node.cores)] = node._core_used
                else:
                    # non-identity core layout (hand-assembled node)
                    for c in node.cores:
                        self.core_used[i, c.core] = c.used
                m = len(node.gpus)
                if m:
                    self.gpu_used[i, :m] = node._gpu_used
                uu, kk, valid = self._nic_idx[i]
                if uu is not None:
                    self.nic_rx_used[i, uu, kk] = node._nic_bw[valid, 0]
                    self.nic_tx_used[i, uu, kk] = node._nic_bw[valid, 1]
                    self.nic_pods[i, uu, kk] = node._nic_pods[valid]
                self.hp_free[i] = node.mem.free_hugepages_gb

        self._touched: set = set()

        # native assignment core (ctypes; None → pure-numpy path)
        from nhd_tpu_torch import native as _native

        self._lib = _native.LIB
        if self._lib is not None:
            self._req_cache: Dict[PodRequest, tuple] = {}
            self._bucket_cache: Dict[int, tuple] = {}
            self._out_cores = np.zeros(self.L + 8, np.int32)
            self._out_counts = np.zeros(64, np.int32)
            self._out_gpus = np.zeros(max(GM, 1), np.int32)
            # base addresses + row strides for raw-pointer passing
            self._addr = {
                name: (arr.ctypes.data, arr.strides[0])
                for name, arr in (
                    ("core_socket", self.core_socket),
                    ("gpu_numa", self.gpu_numa),
                    ("gpu_sw", self.gpu_sw),
                )
            }

    def _build_static(self, key) -> dict:
        """One pass over the node objects extracting everything assignment
        never mutates; the result is shareable between FastCluster builds."""
        N = len(self.node_objs)
        U, K = self.U, self.K
        P = max((n.cores_per_proc * n.sockets for n in self.node_objs), default=1)
        L = max((len(n.cores) for n in self.node_objs), default=1)
        GM = max((len(n.gpus) for n in self.node_objs), default=1) or 1

        smt = np.zeros(N, bool)
        phys = np.zeros(N, np.int32)
        core_socket = np.full((N, L), -1, np.int8)
        gpu_numa = np.full((N, GM), -1, np.int8)
        gpu_sw = np.full((N, GM), -1, np.int64)
        gpu_devid = np.full((N, GM), -1, np.int32)
        n_gpus = np.zeros(N, np.int32)
        nic_flat = np.full((N, U, K), -1, np.int32)
        nic_cap = np.zeros((N, U, K), np.float64)   # schedulable Gbps
        nic_sw = np.full((N, U, K), -1, np.int64)
        gpu_sw_dense = np.full((N, GM), -1, np.int32)  # encode_cluster ids
        nic_idx: List[Tuple] = []

        for i, node in enumerate(self.node_objs):
            smt[i] = node.smt_enabled
            phys[i] = node.cores_per_proc * node.sockets
            if node._core_socket is not None:
                core_socket[i, : len(node.cores)] = node._core_socket
            else:
                for c in node.cores:
                    core_socket[i, c.core] = c.socket
            m = len(node.gpus)
            n_gpus[i] = m
            if m:
                gpu_numa[i, :m] = node._gpu_numa
                gpu_sw[i, :m] = node._gpu_sw
                gpu_devid[i, :m] = node._gpu_devid
                # dense switch ids precomputed by _pack_state (the single
                # definition of the sorted-switches mapping)
                gpu_sw_dense[i, :m] = node._gpu_sw_dense
            nb = len(node.nics)
            if nb:
                u, k = node._nic_u, node._nic_k
                valid = (u < U) & (k < K)
                uu, kk = u[valid], k[valid]
                nic_flat[i, uu, kk] = np.arange(nb, dtype=np.int32)[valid]
                nic_cap[i, uu, kk] = node._nic_cap[valid]
                nic_sw[i, uu, kk] = node._nic_sw[valid]
                nic_idx.append((uu, kk, valid))
            else:
                nic_idx.append((None, None, None))

        return {
            "key": key, "node_objs": self.node_objs, "P": P, "L": L,
            "smt": smt, "phys": phys, "core_socket": core_socket,
            "gpu_numa": gpu_numa, "gpu_sw": gpu_sw, "gpu_devid": gpu_devid,
            "n_gpus": n_gpus, "nic_flat": nic_flat, "nic_cap": nic_cap,
            "nic_sw": nic_sw, "gpu_sw_dense": gpu_sw_dense,
            "nic_idx": nic_idx,
        }

    def _row_addr(self, name: str, n: int) -> int:
        base, stride = self._addr[name]
        return base + n * stride

    def refresh_node(self, i: int) -> None:
        """Re-read node *i*'s dynamic allocation state from its HostNode
        — the inverse of sync_to_nodes, for one row. The delta layer
        (solver/encode.py ClusterDelta) patches a persistent context's
        FastCluster through this after out-of-band churn (pod release,
        restart replay, watch events) mutated the host mirror between
        batches; everything static is untouched, so the call is a few
        vector writes. Callers must have ruled out a packed-topology
        rebuild (pack generation change) — that invalidates the static
        matrices and demands a full FastCluster rebuild."""
        node = self.node_objs[i]
        self.core_used[i] = True
        if node._core_used is not None:
            self.core_used[i, : len(node.cores)] = node._core_used
        else:
            for c in node.cores:
                self.core_used[i, c.core] = c.used
        self.gpu_used[i] = True
        m = len(node.gpus)
        if m:
            self.gpu_used[i, :m] = node._gpu_used
        self.nic_rx_used[i] = 0.0
        self.nic_tx_used[i] = 0.0
        self.nic_pods[i] = 0
        uu, kk, valid = self._nic_idx[i]
        if uu is not None:
            self.nic_rx_used[i, uu, kk] = node._nic_bw[valid, 0]
            self.nic_tx_used[i, uu, kk] = node._nic_bw[valid, 1]
            self.nic_pods[i, uu, kk] = node._nic_pods[valid]
        self.hp_free[i] = node.mem.free_hugepages_gb

    # ------------------------------------------------------------------
    # round-level native assignment
    # ------------------------------------------------------------------

    def round_supported(self) -> bool:
        return self._lib is not None and self.arrays is not None

    def round_ok_for(self, pods) -> bool:
        """Bucket within the native round call's fixed-buffer limits
        (mirrors the -100 guard in nhd_assign_round); callers fall back to
        the per-pod path otherwise."""
        return (
            self.round_supported()
            and pods.G <= 16
            and self.L <= 4096
            and self.gpu_used.shape[1] <= 512
            and self.U * self.K <= 128
        )

    def _bucket_arrays(self, pods) -> tuple:
        """[T, G] raw demand arrays for a bucket (cached across rounds —
        dataclasses.replace shares the underlying requests list).

        The cache entry PINS the keyed requests list: an id() key is only
        unique while the object lives, and CPython reuses ids aggressively
        — without the pin, a later bucket's fresh list could collide with
        a dead one's id and be served the WRONG demand arrays (this
        happened in practice under the streaming chunk pattern: phantom
        -1/-2 assignment failures and silent accounting drift)."""
        key = id(pods.requests)
        got = self._bucket_cache.get(key)
        if got is not None:
            return got[1]
        T, G = len(pods.requests), pods.G
        t_proc = np.zeros((T, G), np.int32)
        t_proc_smt = np.zeros((T, G), np.int32)
        t_help = np.zeros((T, G), np.int32)
        t_help_smt = np.zeros((T, G), np.int32)
        t_gpus = np.zeros((T, G), np.int32)
        t_misc = np.zeros(T, np.int32)
        t_misc_smt = np.zeros(T, np.int32)
        for t, r in enumerate(pods.requests):
            for g, grp in enumerate(r.groups):
                t_proc[t, g] = grp.proc.count
                t_proc_smt[t, g] = int(grp.proc.smt)
                t_help[t, g] = grp.misc.count
                t_help_smt[t, g] = int(grp.misc.smt)
                t_gpus[t, g] = grp.gpus
            t_misc[t] = r.misc.count
            t_misc_smt[t] = int(r.misc.smt)
        maxc = int((t_proc.sum(1) + t_help.sum(1) + t_misc).max(initial=1)) + 2
        gmx = max(int(t_gpus.sum(1).max(initial=0)), 1)
        got = (t_proc, t_proc_smt, t_help, t_help_smt, t_gpus,
               t_misc, t_misc_smt, maxc, gmx)
        # bound the cache: a persistent-context FastCluster sees a fresh
        # requests list per schedule() call; without eviction the pins
        # accumulate forever. Recompute cost is trivial, so a coarse
        # clear-on-overflow keeps within-call reuse and bounds memory.
        if len(self._bucket_cache) >= 64:
            self._bucket_cache.clear()
        self._bucket_cache[key] = (pods.requests, got)
        return got

    def assign_round(self, pods, w_node, w_type, w_c, w_m, *,
                     set_busy: bool):
        """Place one round's winners in a single native call; returns
        (status[W], cores[W,MAXC], counts[W,2G+1], nic_flat[W,G], gpus[W,GMX]).

        Mutates occupancy AND the attached solver ClusterArrays exactly as
        per-pod assign + _update_arrays would (parity-tested)."""
        from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING

        (t_proc, t_proc_smt, t_help, t_help_smt, t_gpus,
         t_misc, t_misc_smt, maxc, gmx) = self._bucket_arrays(pods)
        G = pods.G
        W = len(w_node)
        a = self.arrays
        d = lambda arr: arr.ctypes.data
        status = np.zeros(W, np.int32)
        out_cores = np.zeros((W, maxc), np.int32)
        out_counts = np.zeros((W, 2 * G + 1), np.int32)
        out_nic = np.zeros((W, max(G, 1)), np.int32)
        out_gpus = np.zeros((W, gmx), np.int32)
        out_pick = np.zeros(W, np.int32)
        t_pci = pods.map_pci.astype(np.uint8)

        rc = self._lib.nhd_assign_round(
            d(self.core_used), d(self.core_socket), d(self.phys),
            d(self.smt), self.L,
            d(self.gpu_used), d(self.gpu_numa), d(self.gpu_sw),
            d(self.gpu_sw_dense), d(self.n_gpus), self.gpu_used.shape[1],
            d(self.nic_flat), d(self.nic_sw), d(self.nic_rx_used),
            d(self.nic_tx_used), d(self.nic_pods), d(self.nic_cap),
            self.U, self.K,
            d(self.hp_free),
            d(a.cpu_free), d(a.gpu_free), d(a.gpu_free_sw), d(a.nic_free),
            d(a.hp_free), d(a.busy), a.gpu_free_sw.shape[1],
            int(set_busy), int(ENABLE_NIC_SHARING),
            G, d(t_proc), d(t_proc_smt), d(t_help), d(t_help_smt),
            d(t_gpus), d(pods.rx), d(pods.tx), d(t_misc), d(t_misc_smt),
            d(pods.hp), d(t_pci),
            W, d(w_node), d(w_type), d(w_c), d(w_m),
            d(status), d(out_cores), d(out_counts), d(out_nic), d(out_gpus),
            d(out_pick), maxc, gmx,
        )
        if rc != 0:
            raise FastAssignError(f"native round call failed: rc={rc}")
        self._touched.update(int(n) for n in w_node)
        return status, out_cores, out_counts, out_nic, out_gpus, out_pick

    def nic_list_from_round(self, pods, w, t, buffers) -> List[Tuple[int, float, NicDir]]:
        """Consumed-NIC list for winner ``w`` (cheap; no record needed)."""
        out_nic = buffers[3]
        out = []
        for g, grp in enumerate(pods.requests[t].groups):
            flat = int(out_nic[w, g])
            if grp.nic_rx_gbps > 0:
                out.append((flat, grp.nic_rx_gbps, NicDir.RX))
            if grp.nic_tx_gbps > 0:
                out.append((flat, grp.nic_tx_gbps, NicDir.TX))
        return out

    def _build_record(
        self, n, req, cores_row, counts_row, gpu_rows_flat, nic_flats
    ) -> AssignRecord:
        """Unpack flat assignment buffers (one pod's worth — identical
        layout for the per-pod and round-level native calls) into an
        AssignRecord. Single definition keeps both paths bit-identical."""
        node = self.node_objs[n]
        rec = AssignRecord(
            node_index=n, node_name=self.names[n],
            data_vlan=node.data_vlan, gwip=node.gwip,
        )
        cores_at = 0
        gpus_at = 0
        for g, grp in enumerate(req.groups):
            n_proc = int(counts_row[2 * g])
            n_help = int(counts_row[2 * g + 1])
            group_cpus = [int(c) for c in cores_row[cores_at : cores_at + n_proc]]
            cores_at += n_proc
            helpers = [int(c) for c in cores_row[cores_at : cores_at + n_help]]
            cores_at += n_help
            gpu_rows = [int(gpu_rows_flat[gpus_at + j]) for j in range(grp.gpus)]
            gpus_at += grp.gpus
            flat = int(nic_flats[g])
            uk = (-1, -1)
            mac = ""
            if flat >= 0:
                nic = node.nics[flat]
                uk = (nic.numa_node, nic.idx)
                mac = nic.mac
            rec.groups.append(
                GroupAssignment(
                    uk[0], group_cpus, helpers,
                    [int(self.gpu_devid[n, j]) for j in gpu_rows],
                    uk, flat, mac, gpu_rows,
                )
            )
            if grp.nic_rx_gbps > 0:
                rec.nic_list.append((flat, grp.nic_rx_gbps, NicDir.RX))
            if grp.nic_tx_gbps > 0:
                rec.nic_list.append((flat, grp.nic_tx_gbps, NicDir.TX))
        n_misc = int(counts_row[2 * req.n_groups])
        rec.misc_cpus = [int(c) for c in cores_row[cores_at : cores_at + n_misc]]
        return rec

    def record_from_round(self, pods, w, n, t, buffers) -> AssignRecord:
        """Materialize an AssignRecord for winner ``w`` from round buffers."""
        out_cores, out_counts, out_nic, out_gpus = buffers[1:5]
        return self._build_record(
            n, pods.requests[t], out_cores[w], out_counts[w],
            out_gpus[w], out_nic[w],
        )

    # ------------------------------------------------------------------

    def _cpu_batch(
        self, used_row: np.ndarray, n: int, numa: int, num: int, smt_req: SmtMode
    ) -> Optional[List[int]]:
        """First-fit cores on ``numa`` against an overlay row; None if short.
        Mirrors HostNode.free_cpu_batch exactly."""
        if num == 0:
            return []
        P = int(self.phys[n])
        socket = self.core_socket[n, :P]
        if self.smt[n]:
            free_pair = (
                (socket == numa) & ~used_row[:P] & ~used_row[P : 2 * P]
            )
            cand = np.flatnonzero(free_pair)
            if smt_req == SmtMode.ON:
                pairs = num // 2
                if len(cand) < pairs + (num % 2):
                    return None
                out: List[int] = []
                for c in cand[:pairs]:
                    out.extend((int(c), int(c) + P))
                if num % 2:
                    out.append(int(cand[pairs]))
                return out
            if len(cand) < num:
                return None
            return [int(c) for c in cand[:num]]
        free = (socket == numa) & ~used_row[:P]
        cand = np.flatnonzero(free)
        if len(cand) < num:
            return None
        return [int(c) for c in cand[:num]]

    def _pick_gpu(
        self, gpu_row: np.ndarray, n: int, sw: int, numa: int, pci_mode: bool
    ) -> Optional[int]:
        """First free GPU on PCIe switch ``sw``; NUMA fallback unless PCI mode."""
        ng = int(self.n_gpus[n])
        if ng == 0:
            return None
        free = ~gpu_row[:ng]
        on_sw = free & (self.gpu_sw[n, :ng] == sw)
        idx = np.flatnonzero(on_sw)
        if len(idx):
            return int(idx[0])
        if pci_mode:
            return None
        on_numa = free & (self.gpu_numa[n, :ng] == numa)
        idx = np.flatnonzero(on_numa)
        return int(idx[0]) if len(idx) else None

    # ------------------------------------------------------------------

    def _reselect_picks(self, n: int, combo, req: PodRequest):
        """First NIC pick (product order) feasible against LIVE state — the
        mapping's pick is a solve-time snapshot that an earlier claim on the
        same node may have consumed (mirrors select_pick in the C core).
        Returns per-group ordinals, or None."""
        from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING
        from nhd_tpu_torch.solver.combos import get_tables

        G = req.n_groups
        if G == 0:
            return ()
        bw = req.nic_bw()
        for pick in get_tables(G, self.U, self.K).pick:
            ok = True
            joint: Dict[Tuple[int, int], List[float]] = {}
            for g in range(G):
                u, k = int(combo[g]), int(pick[g])
                if self.nic_flat[n, u, k] < 0:
                    ok = False
                    break
                acc = joint.setdefault((u, k), [0.0, 0.0])
                acc[0] += bw[g][0]
                acc[1] += bw[g][1]
            if not ok:
                continue
            for (u, k), (rx, tx) in joint.items():
                if rx <= 0 and tx <= 0:
                    continue
                if ENABLE_NIC_SHARING:
                    free_rx = self.nic_cap[n, u, k] - self.nic_rx_used[n, u, k]
                    free_tx = self.nic_cap[n, u, k] - self.nic_tx_used[n, u, k]
                elif self.nic_pods[n, u, k] > 0:
                    free_rx = free_tx = 0.0
                else:
                    free_rx = free_tx = self.nic_cap[n, u, k]
                if rx > free_rx or tx > free_tx:
                    ok = False
                    break
            if ok and req.map_mode == MapMode.PCI:
                # PCI mode: the pick must also admit the GPU assignment
                # (every GPU off the chosen NIC's switch) — simulate it
                gpu_sim = self.gpu_used[n].copy()
                for g in range(G):
                    if not ok:
                        break
                    u, k = int(combo[g]), int(pick[g])
                    for _ in range(req.groups[g].gpus):
                        j = self._pick_gpu(
                            gpu_sim, n, int(self.nic_sw[n, u, k]),
                            int(combo[g]), True,
                        )
                        if j is None:
                            ok = False
                            break
                        gpu_sim[j] = True
            if ok:
                return tuple(int(p) for p in pick)
        return None

    def assign(
        self, n: int, mapping: Dict[str, tuple], req: PodRequest
    ) -> AssignRecord:
        """Resolve and commit one pod's physical assignment on node row n.

        The NIC pick is re-selected against live state (multi-claim rounds
        can consume the solve-time pick); the realized choice is visible in
        the returned record's nic_uk fields. Raises FastAssignError with no
        state change when any pick fails.
        """
        picks = self._reselect_picks(n, mapping["gpu"], req)
        if picks is None:
            raise FastAssignError(
                f"no feasible NIC pick on {self.names[n]} (stale claim)"
            )
        mapping = {
            "gpu": mapping["gpu"],
            "cpu": mapping["cpu"],
            "nic": tuple(zip(mapping["gpu"], picks)),
        }
        node = self.node_objs[n]
        used_row = self.core_used[n].copy()
        gpu_row = self.gpu_used[n].copy()
        rec = AssignRecord(
            node_index=n, node_name=self.names[n],
            data_vlan=node.data_vlan, gwip=node.gwip,
        )
        nic_rx_add: Dict[Tuple[int, int], float] = {}
        nic_tx_add: Dict[Tuple[int, int], float] = {}

        # the native per-pod call shares the round path's fixed-buffer
        # limits (its out_counts scratch holds 2G+1 entries; a >16-group pod
        # is possible on small-lattice clusters) — larger pods take the
        # numpy path below
        if self._lib is not None and req.n_groups <= 16:
            return self._assign_native(
                n, node, mapping, req, used_row, gpu_row, rec,
                nic_rx_add, nic_tx_add,
            )

        for gi, g in enumerate(req.groups):
            numa = int(mapping["gpu"][gi])
            u, k = (int(x) for x in mapping["nic"][gi])
            flat = int(self.nic_flat[n, u, k])
            if flat < 0 and (g.needs_nic or g.gpus):
                raise FastAssignError(f"no NIC at numa {u} idx {k} on {rec.node_name}")

            group_cpus = self._cpu_batch(used_row, n, numa, g.proc.count, g.proc.smt)
            if group_cpus is None:
                raise FastAssignError(
                    f"short of {g.proc.count} proc cores on numa {numa}"
                )
            used_row[group_cpus] = True

            gpu_ids: List[int] = []
            gpu_rows: List[int] = []
            for _ in range(g.gpus):
                sw = int(self.nic_sw[n, u, k]) if flat >= 0 else -1
                j = self._pick_gpu(
                    gpu_row, n, sw, numa, req.map_mode == MapMode.PCI
                )
                if j is None:
                    raise FastAssignError(
                        f"no free GPU for group {gi} (sw={sw}, numa={numa})"
                    )
                gpu_row[j] = True
                gpu_ids.append(int(self.gpu_devid[n, j]))
                gpu_rows.append(j)

            helpers = self._cpu_batch(used_row, n, numa, g.misc.count, g.misc.smt)
            if helpers is None:
                raise FastAssignError(
                    f"short of {g.misc.count} helper cores on numa {numa}"
                )
            used_row[helpers] = True

            if g.nic_rx_gbps > 0:
                nic_rx_add[(u, k)] = nic_rx_add.get((u, k), 0.0) + g.nic_rx_gbps
            if g.nic_tx_gbps > 0:
                nic_tx_add[(u, k)] = nic_tx_add.get((u, k), 0.0) + g.nic_tx_gbps

            mac = node.nics[flat].mac if flat >= 0 else ""
            rec.groups.append(
                GroupAssignment(
                    numa, group_cpus, helpers, gpu_ids, (u, k), flat, mac, gpu_rows
                )
            )

        misc_numa = int(mapping["cpu"][-1])
        misc = self._cpu_batch(used_row, n, misc_numa, req.misc.count, req.misc.smt)
        if misc is None:
            raise FastAssignError(
                f"short of {req.misc.count} misc cores on numa {misc_numa}"
            )
        used_row[misc] = True
        rec.misc_cpus = misc

        return self._commit(
            n, mapping, req, rec, used_row, gpu_row, nic_rx_add, nic_tx_add
        )

    def _commit(
        self, n, mapping, req, rec, used_row, gpu_row, nic_rx_add, nic_tx_add
    ) -> AssignRecord:
        """Apply a fully-resolved assignment (shared by both pick paths)."""
        if req.hugepages_gb > self.hp_free[n]:
            raise FastAssignError("hugepages exhausted")

        self.core_used[n] = used_row
        self.gpu_used[n] = gpu_row
        self.hp_free[n] -= req.hugepages_gb
        for (u, k), add in nic_rx_add.items():
            self.nic_rx_used[n, u, k] += add
        for (u, k), add in nic_tx_add.items():
            self.nic_tx_used[n, u, k] += add
        if not rec.nic_list:  # _build_record-produced records arrive filled
            for ga, g in zip(rec.groups, req.groups):
                if ga.nic_flat < 0:
                    continue
                if g.nic_rx_gbps > 0:
                    rec.nic_list.append((ga.nic_flat, g.nic_rx_gbps, NicDir.RX))
                if g.nic_tx_gbps > 0:
                    rec.nic_list.append((ga.nic_flat, g.nic_tx_gbps, NicDir.TX))
        # only NICs actually serving rx/tx cores are claimed — a zero-
        # bandwidth group's mapped NIC stays free (the reference's nic_list
        # only carries NIC-serving cores, NHDScheduler.py:302-304)
        claimed_uks = {
            ga.nic_uk
            for ga, g in zip(rec.groups, req.groups)
            if ga.nic_flat >= 0 and g.needs_nic
        }
        for uk in claimed_uks:
            self.nic_pods[n, uk[0], uk[1]] += 1
        self._touched.add(n)

        if self.arrays is not None:
            self._update_arrays(n, mapping, req, rec, claimed_uks)
        return rec

    def _req_arrays(self, req: PodRequest) -> tuple:
        """Flattened per-type demand arrays for the native call (cached —
        gang batches share one entry)."""
        got = self._req_cache.get(req)
        if got is None:
            G = req.n_groups
            got = (
                np.asarray([g.proc.count for g in req.groups], np.int32),
                np.asarray([int(g.proc.smt) for g in req.groups], np.int32),
                np.asarray([g.misc.count for g in req.groups], np.int32),
                np.asarray([int(g.misc.smt) for g in req.groups], np.int32),
                np.asarray([g.gpus for g in req.groups], np.int32),
                np.zeros(G, np.int32),   # scratch: g_numa
                np.zeros(G, np.int64),   # scratch: g_nic_sw
            )
            self._req_cache[req] = got
        return got

    def _assign_native(
        self, n, node, mapping, req, used_row, gpu_row, rec,
        nic_rx_add, nic_tx_add,
    ) -> AssignRecord:
        """One C call resolves every core/GPU pick (native/nhd_assign.cc)."""
        g_proc, g_proc_smt, g_help, g_help_smt, g_gpus, g_numa, g_nic_sw = (
            self._req_arrays(req)
        )
        flats = []
        nic_flat_row = self.nic_flat[n]
        nic_sw_row = self.nic_sw[n]
        for gi, g in enumerate(req.groups):
            u, k = mapping["nic"][gi]
            flat = int(nic_flat_row[u, k])
            if flat < 0 and (g.needs_nic or g.gpus):
                raise FastAssignError(
                    f"no NIC at numa {u} idx {k} on {rec.node_name}"
                )
            flats.append((u, k, flat))
            g_numa[gi] = mapping["gpu"][gi]
            g_nic_sw[gi] = int(nic_sw_row[u, k]) if flat >= 0 else -1

        addr = self._row_addr
        rc = self._lib.nhd_assign_pod(
            used_row.ctypes.data, addr("core_socket", n),
            int(self.phys[n]), int(self.smt[n]),
            gpu_row.ctypes.data, addr("gpu_numa", n), addr("gpu_sw", n),
            int(self.n_gpus[n]),
            req.n_groups,
            g_numa.ctypes.data, g_nic_sw.ctypes.data,
            g_proc.ctypes.data, g_proc_smt.ctypes.data,
            g_help.ctypes.data, g_help_smt.ctypes.data, g_gpus.ctypes.data,
            int(mapping["cpu"][-1]), req.misc.count, int(req.misc.smt),
            int(req.map_mode == MapMode.PCI),
            self._out_cores.ctypes.data, self._out_counts.ctypes.data,
            self._out_gpus.ctypes.data,
        )
        if rc < 0:
            stage = {-1: "proc cores", -2: "free GPU", -3: "helper cores",
                     -4: "misc cores"}.get(rc, "resources")
            raise FastAssignError(f"short of {stage} on {rec.node_name}")

        cores_at = 0
        gpus_at = 0
        for gi, g in enumerate(req.groups):
            u, k, flat = flats[gi]
            n_proc = int(self._out_counts[2 * gi])
            n_help = int(self._out_counts[2 * gi + 1])
            group_cpus = self._out_cores[cores_at : cores_at + n_proc].tolist()
            cores_at += n_proc
            helpers = self._out_cores[cores_at : cores_at + n_help].tolist()
            cores_at += n_help
            gpu_rows = [int(self._out_gpus[gpus_at + j]) for j in range(g.gpus)]
            gpus_at += g.gpus
            gpu_ids = [int(self.gpu_devid[n, j]) for j in gpu_rows]
            if g.nic_rx_gbps > 0:
                nic_rx_add[(u, k)] = nic_rx_add.get((u, k), 0.0) + g.nic_rx_gbps
            if g.nic_tx_gbps > 0:
                nic_tx_add[(u, k)] = nic_tx_add.get((u, k), 0.0) + g.nic_tx_gbps
            mac = node.nics[flat].mac if flat >= 0 else ""
            rec.groups.append(
                GroupAssignment(
                    int(g_numa[gi]), group_cpus, helpers, gpu_ids,
                    (u, k), flat, mac, gpu_rows
                )
            )
        n_misc = int(self._out_counts[2 * req.n_groups])
        rec.misc_cpus = self._out_cores[cores_at : cores_at + n_misc].tolist()

        return self._commit(
            n, mapping, req, rec, used_row, gpu_row, nic_rx_add, nic_tx_add
        )

    def _update_arrays(self, n, mapping, req, rec, claimed_uks) -> None:
        """Incrementally maintain the solver-visible ClusterArrays row —
        the O(groups) delta replaces a full node re-projection per round.

        The CPU decrement per slot equals the slot's physical-core demand:
        SMT-ON consumes ceil(count/2) full sibling pairs, SMT-OFF poisons
        one otherwise-free pair per core, non-SMT is 1:1 — exactly the
        feasibility demand, so free-pair counts stay consistent.
        """
        from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING

        arrays = self.arrays
        slots = req.cpu_slot_counts(bool(self.smt[n]))
        for g_i, numa in enumerate(mapping["gpu"]):
            arrays.cpu_free[n, int(numa)] -= slots[g_i]
        arrays.cpu_free[n, int(mapping["cpu"][-1])] -= slots[-1]

        for ga in rec.groups:
            for j in ga.gpu_rows:
                # decrement by the *chosen* GPU's NUMA node: the PCI-switch
                # preference can pick a GPU off the group's NUMA node
                # (reference Node.py:648-655 matches switch only)
                arrays.gpu_free[n, int(self.gpu_numa[n, j])] -= 1
                arrays.gpu_free_sw[n, int(self.gpu_sw_dense[n, j])] -= 1

        for (u, k) in claimed_uks:
            if ENABLE_NIC_SHARING:
                arrays.nic_free[n, u, k, 0] = (
                    self.nic_cap[n, u, k] - self.nic_rx_used[n, u, k]
                )
                arrays.nic_free[n, u, k, 1] = (
                    self.nic_cap[n, u, k] - self.nic_tx_used[n, u, k]
                )
            else:
                arrays.nic_free[n, u, k, :] = 0.0

        arrays.hp_free[n] -= req.hugepages_gb

    # ------------------------------------------------------------------

    def sync_to_nodes(self) -> None:
        """Write allocation changes back to the HostNode mirror — one
        vector write per packed array per touched node (the component
        objects are views over these arrays, core/node.py _pack_state).

        On a homogeneous cluster the per-node bindings (target arrays,
        NIC index maps) are prebuilt at construction (``_sync_plan``), so
        the loop touches only local lists — the attribute walks were the
        dominant cost of a 1k-node gang's final sync. A node whose packed
        arrays were rebuilt since the plan (identity mismatch) falls back
        to the re-reading path."""
        plan = self._sync_plan
        if plan is not None and self._touched:
            nc0, ng0, uu0, kk0, valid0, cores_l, gpus_l, bw_l, pods_l, mem_l = plan
            idx = np.fromiter(
                self._touched, np.int64, len(self._touched)
            )
            # gather every touched row in a handful of big vector ops;
            # the loop below only scatters into the per-node arrays —
            # per-node fancy gathers were ~2 µs apiece × 3 × N
            cu = self.core_used[idx, :nc0]
            gu = self.gpu_used[idx, :ng0] if ng0 else None
            if uu0 is not None:
                bwt = np.stack(
                    [
                        self.nic_rx_used[idx][:, uu0, kk0],
                        self.nic_tx_used[idx][:, uu0, kk0],
                    ],
                    axis=-1,
                )
                pd = self.nic_pods[idx][:, uu0, kk0]
            hp = self.hp_free[idx]
            objs = self.node_objs
            for j, n in enumerate(idx.tolist()):
                dst = cores_l[n]
                if objs[n]._core_used is not dst:
                    self._sync_one(n)
                    continue
                dst[:] = cu[j]
                if ng0:
                    gpus_l[n][:] = gu[j]
                if uu0 is not None:
                    bw_l[n][valid0] = bwt[j]
                    pods_l[n][valid0] = pd[j]
                mem_l[n].free_hugepages_gb = int(hp[j])
            self._touched.clear()
            return
        for n in self._touched:
            self._sync_one(n)
        self._touched.clear()

    def _sync_one(self, n: int) -> None:
        """Sync one node row, re-reading its current packed bindings."""
        node = self.node_objs[n]
        if node._core_used is not None:
            node._core_used[:] = self.core_used[n, : len(node.cores)]
        else:
            for c in node.cores:
                c.used = bool(self.core_used[n, c.core])
        m = len(node.gpus)
        if m:
            node._gpu_used[:] = self.gpu_used[n, :m]
        uu, kk, valid = self._nic_idx[n]
        if uu is not None:
            node._nic_bw[valid, 0] = self.nic_rx_used[n, uu, kk]
            node._nic_bw[valid, 1] = self.nic_tx_used[n, uu, kk]
            node._nic_pods[valid] = self.nic_pods[n, uu, kk]
        node.mem.free_hugepages_gb = int(self.hp_free[n])


def apply_record_to_topology(rec: AssignRecord, top: PodTopology) -> None:
    """Fill a PodTopology with the physical IDs a FastCluster assignment
    chose — the same field-filling assign_physical_ids performs inline
    (reference Node.py:663-841), decoupled from the hot path."""
    for ga, pg in zip(rec.groups, top.proc_groups):
        if pg.vlan is not None:
            pg.vlan.vlan = rec.data_vlan
        cursor = 0
        for gpu, devid in zip(pg.gpus, ga.gpu_devids):
            gpu.device_id = devid
        for gpu in pg.gpus:
            for feeder in gpu.cpu_cores:
                feeder.core = ga.group_cpus[cursor]
                cursor += 1
        for core in pg.proc_cores:
            core.core = ga.group_cpus[cursor]
            cursor += 1
            if core.nic_dir in (NicDir.RX, NicDir.TX):
                pair = top.nic_pair_for_core(core)
                if pair is not None:
                    pair.mac = ga.nic_mac
        for helper, c in zip(pg.misc_cores, ga.helper_cpus):
            helper.core = c
    for mc, c in zip(top.misc_cores, rec.misc_cpus):
        mc.core = c
    if top.ctrl_vlan is not None:
        top.ctrl_vlan.vlan = rec.data_vlan
    top.set_data_default_gw(rec.gwip)
