"""The plain reference that decides ``correct``: NHD's placement
semantics over plain NumPy arrays, built from the fleet specification
the harness hands the program. It imports nothing of the program and
takes nothing the program made.

It replays the run gang by gang. For each gang it judges the program's
answers (``Answers``) against its own node state, then applies them;
for each torn-down gang it releases them. What it holds the program to,
the configuration's guarantees:

- a placed pod's node is active and in one of the pod's node groups;
- each processing group's cores, GPUs and NIC sit on one NUMA node
  (``map_mode`` NUMA), the top-level misc cores on one NUMA node;
- each core set takes exactly the physical cores it asks for: an
  SMT-tolerant set of n cores ``ceil(n / 2)`` whole sibling pairs (the
  last one half used), an SMT-averse set n physical cores; no physical
  core serves two pods, and every one was wholly free;
- each GPU was free; with NIC sharing off each NIC served no pod and
  serves one, and its bandwidth fits its headroom;
- hugepages fit the node's free pages;
- a pod left unplaced fits no node once its gang is placed (resources
  only shrink within a gang, so a pod that fits then fitted when the
  program gave up on it).

A pod type with ``map_mode`` PCI (upstream's PCI map mode, the
PCIe-switch-aware GPU and NIC pairing of GPUDirect, README.md:16,
147-148) is held to every rule above and to upstream's switch rules,
with the switches ``Hardware`` states:

- placements: each GPU of a processing group sits on the PCIe switch of
  that group's NIC (Node.py:648-655, 688-716 take a PCI group's GPUs
  off its NIC's switch, and fail the pod where that switch has none);
- failures: every processing group takes a NIC choice on its NUMA node,
  whatever bandwidth it asks for (Matcher.py:224-276), and upstream
  admits a choice only where each switch holds at least as many free
  GPUs as NICs chosen on it, the NICs of groups that ask for no GPU
  counted too (Matcher.py:313-322, the quirk ``nhd_tpu_torch/solver/
  oracle.py`` keeps). A pod left unplaced is judged by that admission:
  it failed rightly where no node admits it. An admitted choice then
  takes each GPU off the chosen NIC's switch, which a group of one GPU
  always finds;
- pod types refused (``PodType.of``): a PCI group that asks for more
  than one GPU, since admission counts NICs and not GPUs and upstream
  fails the pod at assignment where the two part (NHDScheduler.py:
  296-299), on a node the answers do not name; and a PCI group that
  asks for a GPU but no NIC bandwidth, whose NIC the answers do not
  name.

NUMA map mode's verdicts do not depend on any of this.

After the window ``row_mismatches`` compares the program's resident
device rows with the rows this state gives.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from bench_port.fleet import Hardware

#: core parts of a processing group, and the pod's top-level misc cores
PROC, HELPER, MISC = 0, 1, 2


def phys_of(count: int, smt: bool, node_smt: bool) -> int:
    """Physical cores *count* logical cores take."""
    return math.ceil(count / 2) if (smt and node_smt) else count


@dataclass
class PodType:
    """A pod type of the traffic mix, as plain numbers."""

    groups: List[dict]
    misc: int
    misc_smt: bool
    hugepages: int
    pci: bool = False

    @classmethod
    def of(cls, spec: dict) -> "PodType":
        mode = spec.get("map_mode", "NUMA")
        if mode not in ("NUMA", "PCI"):
            raise ValueError(f"the reference judges NUMA and PCI map modes, not {mode!r}")
        for g, grp in enumerate(spec["groups"] if mode == "PCI" else []):
            if grp["gpus"] > 1:
                raise ValueError(
                    f"PCI group {g} asks for {grp['gpus']} GPUs: upstream admits a NIC "
                    "choice by the free GPUs against the NICs on its switch, not the "
                    "GPUs asked for (Matcher.py:313-322), and fails the pod at "
                    "assignment where the two part (NHDScheduler.py:296-299), on a "
                    "node the answers do not name, so the reference cannot judge it")
            if grp["gpus"] and not (grp["rx_gbps"] > 0 or grp["tx_gbps"] > 0):
                raise ValueError(
                    f"PCI group {g} asks for a GPU and no NIC bandwidth: its GPU "
                    "belongs on its NIC's switch, and the answers name no NIC for a "
                    "group that serves none")
        return cls(spec["groups"], spec["misc"], spec["misc_smt"],
                   spec["hugepages_gb"], mode == "PCI")

    def parts(self, node_smt: bool):
        """(group, part, logical count, physical count) of each core set."""
        out = []
        for g, grp in enumerate(self.groups):
            out.append((g, PROC, grp["proc"],
                        phys_of(grp["proc"], grp["proc_smt"], node_smt)))
            out.append((g, HELPER, grp["helpers"],
                        phys_of(grp["helpers"], grp["helper_smt"], node_smt)))
        out.append((-1, MISC, self.misc, phys_of(self.misc, self.misc_smt, node_smt)))
        return out

    def needs_nic(self, g: int) -> bool:
        grp = self.groups[g]
        return grp["rx_gbps"] > 0 or grp["tx_gbps"] > 0

    def nic_groups(self, switch_ignored: bool = False) -> List[int]:
        """The groups that take a NIC choice: in PCI mode every group
        (each NIC chosen counts against its switch's free GPUs), else
        those that ask for bandwidth. *switch_ignored*: PCI judged as
        NUMA (the second control's broken guarantee)."""
        if self.pci and not switch_ignored:
            return list(range(len(self.groups)))
        return [g for g in range(len(self.groups)) if self.needs_nic(g)]


@dataclass
class Answers:
    """One gang's answers, as plain arrays. Per pod: its node (-1 =
    unplaced), type and node group. Per core, GPU and NIC the program
    named: its pod, processing group (-1 = the pod's misc cores) and,
    for cores, its part (``PROC``, ``HELPER``, ``MISC``)."""

    node: np.ndarray
    ptype: np.ndarray
    pgroup: np.ndarray
    c_pod: np.ndarray
    c_grp: np.ndarray
    c_part: np.ndarray
    c_id: np.ndarray
    g_pod: np.ndarray
    g_grp: np.ndarray
    g_id: np.ndarray
    n_pod: np.ndarray
    n_grp: np.ndarray
    n_id: np.ndarray
    n_rx: np.ndarray
    n_tx: np.ndarray


@dataclass
class Verdict:
    bad_placements: int = 0
    bad_failures: int = 0
    placed: int = 0
    unplaced: int = 0
    notes: List[str] = field(default_factory=list)

    def note(self, text: str) -> None:
        if len(self.notes) < 20:
            self.notes.append(text)


class Reference:
    """NHD's node state and placement rules over plain arrays."""

    def __init__(self, hw: Hardware, types: List[dict], *,
                 nic_sharing: bool = False):
        self.hw = hw
        self.types = [PodType.of(t) for t in types]
        self.sharing = nic_sharing
        N, P = hw.N, hw.P
        self.phys_used = np.zeros((N, P), bool)
        self.phys_used[:, :hw.reserved] = True
        self.gpu_used = np.zeros((N, hw.U * hw.gpn), bool)
        self.nic_pods = np.zeros((N, hw.U * hw.npn), np.int64)
        self.nic_bw = np.zeros((N, hw.U * hw.npn, 2), np.float64)
        self.hp_free = np.full(N, hw.hugepages, np.int64)
        self.node_group = np.array(
            [hw.group_names.index(g) for g in hw.node_groups], np.int64)
        self._expect = self._expected_parts()
        self._pci = np.array([t.pci for t in self.types], bool)
        # the dense switch of each GPU and NIC, and [GPUs, switches]
        self._gsw, self._nsw = hw.gpu_switch(), hw.nic_switch()
        self._gpu_on_sw = np.zeros((len(self._gsw), len(hw.switches())), np.int64)
        self._gpu_on_sw[np.arange(len(self._gsw)), self._gsw] = 1
        self.verdict = Verdict()

    # -- the program's answers against this state --------------------

    def _expected_parts(self) -> np.ndarray:
        """[types, G + 1, 3, 2] logical and physical counts of each core
        set, group slot 0 for the misc cores."""
        G = max(len(t.groups) for t in self.types)
        out = np.zeros((len(self.types), G + 1, 3, 2), np.int64)
        for ti, t in enumerate(self.types):
            for g, part, cnt, ph in t.parts(self.hw.smt):
                out[ti, g + 1, part] = (cnt, ph)
        return out

    def judge(self, a: Answers) -> Verdict:
        """Judge one gang's answers, then apply them. Adds to and
        returns the running verdict."""
        hw = self.hw
        n = len(a.node)
        placed = a.node >= 0
        bad = np.zeros(n, bool)
        v = self.verdict
        v.placed += int(placed.sum())
        v.unplaced += int((~placed).sum())
        G1 = self._expect.shape[1]

        node = np.where(placed, a.node, 0)
        bad |= placed & ((a.node < 0) | (a.node >= hw.N))
        node = np.clip(node, 0, hw.N - 1)
        bad |= placed & (self.node_group[node] != a.pgroup)

        def flag(pods, what):
            pods = np.unique(pods)
            if len(pods):
                bad[pods] = True
                v.note(f"{what}: pods {pods[:4].tolist()}")

        # records of unplaced pods are themselves faults
        for pods, what in ((a.c_pod, "core"), (a.g_pod, "gpu"), (a.n_pod, "nic")):
            stray = pods[~placed[pods]] if len(pods) else pods
            if len(stray):
                v.note(f"{what} named for an unplaced pod")
                v.bad_placements += len(np.unique(stray))

        # -- cores --
        cm = placed[a.c_pod]
        c_pod, c_grp, c_part, c_id = (x[cm] for x in
                                      (a.c_pod, a.c_grp, a.c_part, a.c_id))
        c_node = node[c_pod]
        ok = (c_id >= 0) & (c_id < hw.L)
        flag(c_pod[~ok], "core out of range")
        c_id = np.where(ok, c_id, 0)
        phys = c_id % hw.P
        sock = hw.phys_numa[phys]
        key = c_node * hw.L + c_id
        u, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
        flag(c_pod[cnt[inv] > 1], "logical core named twice")
        flag(c_pod[self.phys_used[c_node, phys]], "core not wholly free")
        pk = c_node * hw.P + phys
        k, kc = np.unique(np.unique(pk * n + c_pod) // n, return_counts=True)
        shared = np.isin(pk, k[kc > 1])
        flag(c_pod[shared], "physical core shared by two pods")
        # logical and physical counts of every core set
        width = G1 * 3
        cell = c_pod * width + (c_grp + 1) * 3 + c_part
        got_l = np.bincount(cell, minlength=n * width)
        got_p = np.bincount(np.unique(cell * hw.P + phys) // hw.P,
                            minlength=n * width)
        want = self._expect[a.ptype].reshape(n, width, 2)
        mism = ((got_l.reshape(n, width) != want[..., 0])
                | (got_p.reshape(n, width) != want[..., 1])).any(1)
        flag(np.nonzero(mism & placed)[0], "core count")
        # one NUMA node per core set's group
        gkey = c_pod * G1 + (c_grp + 1)
        lo = np.full(n * G1, hw.U, np.int64)
        hi = np.full(n * G1, -1, np.int64)
        np.minimum.at(lo, gkey, sock)
        np.maximum.at(hi, gkey, sock)
        flag(c_pod[lo[gkey] != hi[gkey]], "group split over NUMA nodes")
        numa_of = lo  # per (pod, group slot); hw.U where the group has no cores

        # -- GPUs --
        gm = placed[a.g_pod]
        g_pod, g_grp, g_id = (x[gm] for x in (a.g_pod, a.g_grp, a.g_id))
        g_node = node[g_pod]
        ok = (g_id >= 0) & (g_id < hw.U * hw.gpn) & (g_grp >= 0)
        flag(g_pod[~ok], "gpu out of range")
        g_id = np.where(ok, g_id, 0)
        g_grp = np.where(ok, g_grp, 0)
        gk = g_node * (hw.U * hw.gpn) + g_id
        u, inv, cnt = np.unique(gk, return_inverse=True, return_counts=True)
        flag(g_pod[cnt[inv] > 1], "gpu named twice")
        flag(g_pod[self.gpu_used[g_node, g_id]], "gpu not free")
        flag(g_pod[hw.gpu_numa[g_id] != numa_of[g_pod * G1 + g_grp + 1]],
             "gpu off its group's NUMA node")
        want_g = np.zeros((n, G1), np.int64)
        for ti, t in enumerate(self.types):
            sel = a.ptype == ti
            for g, grp in enumerate(t.groups):
                want_g[sel, g + 1] = grp["gpus"]
        got_g = np.bincount(g_pod * G1 + g_grp + 1, minlength=n * G1).reshape(n, G1)
        flag(np.nonzero(placed & (got_g != want_g).any(1))[0], "gpu count")

        # -- NICs --
        nm = placed[a.n_pod]
        n_pod, n_grp, n_id, n_rx, n_tx = (x[nm] for x in
                                          (a.n_pod, a.n_grp, a.n_id, a.n_rx, a.n_tx))
        n_node = node[n_pod]
        K = hw.U * hw.npn
        ok = (n_id >= 0) & (n_id < K) & (n_grp >= 0)
        flag(n_pod[~ok], "nic out of range")
        n_id = np.where(ok, n_id, 0)
        n_grp = np.where(ok, n_grp, 0)
        flag(n_pod[hw.nic_numa[n_id] != numa_of[n_pod * G1 + n_grp + 1]],
             "nic off its group's NUMA node")
        want_n = np.zeros((n, G1), np.int64)
        want_rx = np.zeros((n, G1))
        want_tx = np.zeros((n, G1))
        for ti, t in enumerate(self.types):
            sel = a.ptype == ti
            for g, grp in enumerate(t.groups):
                want_n[sel, g + 1] = int(t.needs_nic(g))
                want_rx[sel, g + 1] = grp["rx_gbps"]
                want_tx[sel, g + 1] = grp["tx_gbps"]
        slot_n = n_pod * G1 + n_grp + 1
        got_n = np.bincount(slot_n, minlength=n * G1).reshape(n, G1)
        flag(np.nonzero(placed & (got_n != want_n).any(1))[0], "nic count")
        flag(n_pod[(np.abs(n_rx - want_rx.ravel()[slot_n]) > 1e-9)
                   | (np.abs(n_tx - want_tx.ravel()[slot_n]) > 1e-9)],
             "nic bandwidth not as asked")
        nk = n_node * K + n_id
        per = np.unique(nk * n + n_pod) // n  # each (NIC, pod) once
        if not self.sharing:
            flag(n_pod[self.nic_pods[n_node, n_id] > 0], "nic already serving a pod")
            k, kc = np.unique(per, return_counts=True)
            flag(n_pod[np.isin(nk, k[kc > 1])], "nic given to two pods")
        rx = np.zeros(hw.N * K)
        tx = np.zeros(hw.N * K)
        np.add.at(rx, nk, n_rx)
        np.add.at(tx, nk, n_tx)
        used = self.nic_bw.reshape(-1, 2)
        base = used if self.sharing else np.zeros_like(used)
        over = ((base[:, 0] + rx > hw.nic_cap + 1e-9)
                | (base[:, 1] + tx > hw.nic_cap + 1e-9))
        flag(n_pod[over[nk]], "nic bandwidth over its headroom")

        # -- PCI map mode: each GPU on its group's NIC's switch --
        pci_gpu = self._pci[a.ptype][g_pod]
        if pci_gpu.any():
            nic_sw = np.full(n * G1, -1, np.int64)
            nic_sw[slot_n] = self._nsw[n_id]
            off = self._gsw[g_id] != nic_sw[g_pod * G1 + g_grp + 1]
            flag(g_pod[pci_gpu & off], "gpu off its NIC's PCIe switch")

        # -- hugepages --
        hp = np.array([t.hugepages for t in self.types], np.int64)[a.ptype]
        need = np.bincount(node[placed], weights=hp[placed],
                           minlength=hw.N).astype(np.int64)
        over_hp = need > self.hp_free
        flag(np.nonzero(placed & over_hp[node])[0], "hugepages over the free pages")

        v.bad_placements += int((bad & placed).sum())

        # -- apply what the program claimed --
        self.phys_used[c_node, phys] = True
        self.gpu_used[g_node, g_id] = True
        np.add.at(self.nic_pods.reshape(-1), per, 1)
        flat = self.nic_bw.reshape(-1, 2)
        np.add.at(flat[:, 0], nk, n_rx)
        np.add.at(flat[:, 1], nk, n_tx)
        self.hp_free -= need

        # -- the pods left unplaced fit nowhere --
        if (~placed).any():
            for ti, gi in set(zip(a.ptype[~placed].tolist(),
                                  a.pgroup[~placed].tolist())):
                if self.fits_anywhere(ti, gi).any():
                    sel = (~placed) & (a.ptype == ti) & (a.pgroup == gi)
                    v.bad_failures += int(sel.sum())
                    v.note(f"type {ti} group {gi} left unplaced but fits")
        return v

    def release(self, a: Answers) -> None:
        """Tear a gang down: free what its placed pods hold."""
        placed = a.node >= 0
        node = np.where(placed, a.node, 0)
        cm = placed[a.c_pod]
        ok = cm & (a.c_id >= 0) & (a.c_id < self.hw.L)
        self.phys_used[node[a.c_pod[ok]], a.c_id[ok] % self.hw.P] = False
        self.phys_used[:, :self.hw.reserved] = True
        gm = placed[a.g_pod] & (a.g_id >= 0) & (a.g_id < self.gpu_used.shape[1])
        self.gpu_used[node[a.g_pod[gm]], a.g_id[gm]] = False
        K = self.nic_pods.shape[1]
        nm = placed[a.n_pod] & (a.n_id >= 0) & (a.n_id < K)
        nk = node[a.n_pod[nm]] * K + a.n_id[nm]
        per = np.unique(nk * len(a.node) + a.n_pod[nm]) // len(a.node)
        np.subtract.at(self.nic_pods.reshape(-1), per, 1)
        flat = self.nic_bw.reshape(-1, 2)
        np.subtract.at(flat[:, 0], nk, a.n_rx[nm])
        np.subtract.at(flat[:, 1], nk, a.n_tx[nm])
        hp = np.array([t.hugepages for t in self.types], np.int64)[a.ptype]
        self.hp_free += np.bincount(node[placed], weights=hp[placed],
                                    minlength=self.hw.N).astype(np.int64)

    # -- feasibility ---------------------------------------------------

    def free_phys(self) -> np.ndarray:
        """[N, U] wholly free physical cores a NUMA node."""
        hw = self.hw
        return (~self.phys_used).reshape(hw.N, hw.U, hw.P // hw.U).sum(2)

    def free_gpus(self) -> np.ndarray:
        hw = self.hw
        return (~self.gpu_used).reshape(hw.N, hw.U, hw.gpn).sum(2)

    def nic_headroom(self) -> np.ndarray:
        """[N, U * npn, 2] rx/tx headroom of each NIC (Gbps)."""
        cap = self.hw.nic_cap
        if self.sharing:
            return cap - self.nic_bw
        free = np.where(self.nic_pods > 0, 0.0, cap)
        return np.stack([free, free], axis=2)

    def fits_anywhere(self, ti: int, gi: int, rows=None,
                      nic_pods_ignored: bool = False,
                      switch_ignored: bool = False) -> np.ndarray:
        """Whether a pod of type *ti* in node group *gi* fits each node
        (each of *rows*) as the state stands: some NUMA node for each
        group and for the misc cores, and some NIC for each group that
        needs one, such that every NUMA node's cores and GPUs and every
        NIC's headroom hold what lands there (the matcher's rule).
        In PCI mode every switch must also hold as many free GPUs as
        NICs chosen on it (upstream's admission, the module docstring).
        *nic_pods_ignored*: judge NICs by bandwidth alone, as if NIC
        sharing were on (the first control's broken guarantee).
        *switch_ignored*: judge PCI as NUMA map mode (the second's)."""
        rows = np.arange(self.hw.N) if rows is None else np.asarray(rows)
        fits = np.zeros(len(rows), bool)
        for _choice, ok in self._choices(ti, rows, nic_pods_ignored, switch_ignored):
            fits |= ok
            if fits.all():
                break
        ok_node = ((self.node_group[rows] == gi)
                   & (self.hp_free[rows] >= self.types[ti].hugepages))
        return fits & ok_node

    def _choices(self, ti: int, rows: np.ndarray, nic_pods_ignored: bool,
                 switch_ignored: bool = False):
        """Each (NUMA node per group, misc NUMA node, NIC per NIC group)
        choice in the matcher's product order, with whether it fits each
        of *rows*."""
        hw = self.hw
        t = self.types[ti]
        r = len(rows)
        fp = (~self.phys_used[rows]).reshape(r, hw.U, hw.P // hw.U).sum(2)
        fg = (~self.gpu_used[rows]).reshape(r, hw.U, hw.gpn).sum(2)
        if nic_pods_ignored:
            head = hw.nic_cap - self.nic_bw[rows]
        else:
            head = self.nic_headroom()[rows]
        G = len(t.groups)
        cpu_g = [phys_of(g["proc"], g["proc_smt"], hw.smt)
                 + phys_of(g["helpers"], g["helper_smt"], hw.smt) for g in t.groups]
        misc = phys_of(t.misc, t.misc_smt, hw.smt)
        nic_groups = t.nic_groups(switch_ignored)
        pci = t.pci and not switch_ignored
        if pci:
            fsw = (~self.gpu_used[rows]).astype(np.int64) @ self._gpu_on_sw
        for numas in itertools.product(range(hw.U), repeat=G):
            d_cpu = np.zeros(hw.U, np.int64)
            d_gpu = np.zeros(hw.U, np.int64)
            for g, u in enumerate(numas):
                d_cpu[u] += cpu_g[g]
                d_gpu[u] += t.groups[g]["gpus"]
            gpu_ok = (fg >= d_gpu).all(1)
            for m in range(hw.U):
                d = d_cpu.copy()
                d[m] += misc
                base = gpu_ok & (fp >= d).all(1)
                for picks in itertools.product(range(hw.npn), repeat=len(nic_groups)):
                    use: Dict[int, List[float]] = {}
                    for g, s in zip(nic_groups, picks):
                        k = numas[g] * hw.npn + s
                        acc = use.setdefault(k, [0.0, 0.0])
                        acc[0] += t.groups[g]["rx_gbps"]
                        acc[1] += t.groups[g]["tx_gbps"]
                    good = base.copy()
                    for k, (rx, tx) in use.items():
                        good &= (head[:, k, 0] >= rx - 1e-9) & (head[:, k, 1] >= tx - 1e-9)
                    if pci:
                        for s, c in self._switch_share(numas, nic_groups, picks):
                            good &= fsw[:, s] >= c
                    yield (numas, m, dict(zip(nic_groups, picks))), good

    def _switch_share(self, numas, nic_groups, picks):
        """(dense switch, NICs chosen on it) of one NIC choice."""
        npn = self.hw.npn
        share: Dict[int, int] = {}
        for g, s in zip(nic_groups, picks):
            sw = int(self._nsw[numas[g] * npn + s])
            share[sw] = share.get(sw, 0) + 1
        return share.items()

    def first_choice(self, ti: int, gi: int, n: int, nic_pods_ignored: bool = False,
                     switch_ignored: bool = False):
        """The first choice in ``_choices``' order by which a pod of type
        *ti* in node group *gi* fits node *n*, or None: the same rule,
        one node at a time in plain Python."""
        hw = self.hw
        t = self.types[ti]
        if self.node_group[n] != gi or self.hp_free[n] < t.hugepages:
            return None
        per = hw.P // hw.U
        used = self.phys_used[n]
        fp = [int((~used[u * per:(u + 1) * per]).sum()) for u in range(hw.U)]
        fg = [int((~self.gpu_used[n, u * hw.gpn:(u + 1) * hw.gpn]).sum())
              for u in range(hw.U)]
        if nic_pods_ignored or self.sharing:
            head = (hw.nic_cap - self.nic_bw[n]).tolist()
        else:
            head = [[hw.nic_cap, hw.nic_cap] if c == 0 else [0.0, 0.0]
                    for c in self.nic_pods[n].tolist()]
        G = len(t.groups)
        cpu_g = [phys_of(g["proc"], g["proc_smt"], hw.smt)
                 + phys_of(g["helpers"], g["helper_smt"], hw.smt) for g in t.groups]
        misc = phys_of(t.misc, t.misc_smt, hw.smt)
        nic_groups = t.nic_groups(switch_ignored)
        pci = t.pci and not switch_ignored
        if pci:
            fsw = ((~self.gpu_used[n]).astype(np.int64) @ self._gpu_on_sw).tolist()
        for numas in itertools.product(range(hw.U), repeat=G):
            d_cpu = [0] * hw.U
            d_gpu = [0] * hw.U
            for g, u in enumerate(numas):
                d_cpu[u] += cpu_g[g]
                d_gpu[u] += t.groups[g]["gpus"]
            if any(d_gpu[u] > fg[u] for u in range(hw.U)):
                continue
            for m in range(hw.U):
                d_cpu[m] += misc
                cpu_ok = all(d_cpu[u] <= fp[u] for u in range(hw.U))
                d_cpu[m] -= misc
                if not cpu_ok:
                    continue
                for picks in itertools.product(range(hw.npn), repeat=len(nic_groups)):
                    use: Dict[int, List[float]] = {}
                    for g, s in zip(nic_groups, picks):
                        acc = use.setdefault(numas[g] * hw.npn + s, [0.0, 0.0])
                        acc[0] += t.groups[g]["rx_gbps"]
                        acc[1] += t.groups[g]["tx_gbps"]
                    if not all(head[k][0] >= rx - 1e-9 and head[k][1] >= tx - 1e-9
                               for k, (rx, tx) in use.items()):
                        continue
                    if pci and not all(
                            fsw[s] >= c for s, c in
                            self._switch_share(numas, nic_groups, picks)):
                        continue
                    return numas, m, dict(zip(nic_groups, picks))
        return None

    def place(self, ti: int, gi: int, n: int, pod: int, nic_pods_ignored: bool = False,
              switch_ignored: bool = False):
        """Place a pod of type *ti* in node group *gi* on node *n* by the
        first choice that fits, lowest free cores and GPUs first (in PCI
        mode the lowest free GPUs on the group's NIC's switch), and
        claim it in this state. Returns its (cores, gpus, nics) records,
        or None where it does not fit: cores as (pod, group, part,
        logical id), gpus as (pod, group, id), nics as (pod, group, id,
        rx, tx)."""
        hw = self.hw
        t = self.types[ti]
        choice = self.first_choice(ti, gi, n, nic_pods_ignored, switch_ignored)
        if choice is None:
            return None
        numas, m, picks = choice
        pci = t.pci and not switch_ignored
        per = hw.P // hw.U
        cores, gpus, nics = [], [], []

        def take(u, count, smt, g, part):
            free = [p for p in range(u * per, (u + 1) * per) if not self.phys_used[n, p]]
            left = count
            for p in free:
                if left <= 0:
                    break
                self.phys_used[n, p] = True
                cores.append((pod, g, part, p))
                left -= 1
                if smt and hw.smt and left > 0:
                    cores.append((pod, g, part, p + hw.P))
                    left -= 1

        for g, grp in enumerate(t.groups):
            u = numas[g]
            take(u, grp["proc"], grp["proc_smt"], g, PROC)
            take(u, grp["helpers"], grp["helper_smt"], g, HELPER)
            free_g = [j for j in range(u * hw.gpn, (u + 1) * hw.gpn)
                      if not self.gpu_used[n, j]
                      and (not pci or self._gsw[j] == self._nsw[u * hw.npn + picks[g]])]
            for j in free_g[:grp["gpus"]]:
                self.gpu_used[n, j] = True
                gpus.append((pod, g, j))
            if g in picks and t.needs_nic(g):
                k = u * hw.npn + picks[g]
                nics.append((pod, g, k, grp["rx_gbps"], grp["tx_gbps"]))
                self.nic_bw[n, k] += (grp["rx_gbps"], grp["tx_gbps"])
        for k in {r[2] for r in nics}:
            self.nic_pods[n, k] += 1
        take(m, t.misc, t.misc_smt, -1, MISC)
        self.hp_free[n] -= t.hugepages
        return cores, gpus, nics

    # -- the device rows this state gives ------------------------------

    def rows(self) -> Dict[str, np.ndarray]:
        """The node rows the program keeps resident, worked out from this
        state: every field whose encoding is plain numbers (the group
        masks and class indices are the program's own interned codes)."""
        hw = self.hw
        N, U = hw.N, hw.U
        nic_free = self.nic_headroom().astype(np.float32).reshape(N, U, hw.npn, 2)
        gsw = hw.gpu_switch()
        S = len(hw.switches())
        gpu_free_sw = np.zeros((N, S), np.int64)
        for j in range(len(gsw)):
            gpu_free_sw[:, gsw[j]] += ~self.gpu_used[:, j]
        return {
            "numa_nodes": np.full(N, U),
            "smt": np.full(N, hw.smt),
            "active": np.ones(N, bool),
            "maintenance": np.zeros(N, bool),
            "busy": np.zeros(N, bool),
            "gpuless": np.full(N, hw.U * hw.gpn == 0),
            "hp_free": self.hp_free,
            "cpu_free": self.free_phys(),
            "gpu_free": self.free_gpus(),
            "nic_count": np.full((N, U), hw.npn),
            "nic_free": nic_free,
            "nic_sw": np.broadcast_to(hw.nic_switch().reshape(U, hw.npn), (N, U, hw.npn)),
            "gpu_free_sw": gpu_free_sw,
        }

    def row_mismatches(self, program_rows: Dict[str, np.ndarray]) -> int:
        """Rows in which any compared field of *program_rows* (the
        program's resident tensors as host arrays, padded rows and all)
        differs from ``rows()``."""
        want = self.rows()
        N = self.hw.N
        bad = np.zeros(N, bool)
        for name, w in want.items():
            got = program_rows.get(name)
            if got is None or got.shape[1:] != w.shape[1:] or got.shape[0] < N:
                self.verdict.note(f"resident {name}: shape "
                                  f"{None if got is None else got.shape}")
                return N
            diff = (np.asarray(got[:N]).astype(np.float64)
                    != np.asarray(w).astype(np.float64))
            diff = diff.reshape(N, -1).any(1)
            if diff.any():
                self.verdict.note(f"resident {name}: rows "
                                  f"{np.nonzero(diff)[0][:4].tolist()}")
            bad |= diff
        return int(bad.sum())


def empty_answers(ptype, pgroup) -> Answers:
    """A gang's answers when it placed no pod."""
    e = np.zeros(0, np.int64)
    return Answers(np.full(len(ptype), -1, np.int64), np.asarray(ptype, np.int64),
                   np.asarray(pgroup, np.int64), e, e, e, e, e, e, e, e, e, e,
                   np.zeros(0), np.zeros(0))

