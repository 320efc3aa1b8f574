"""The system under test, as the harness drives it: the port's
``BatchScheduler.schedule`` against a delta-built ``ScheduleContext``
that persists across the run, the daemon's own teardown route
(``HostNode.release_from_topology``, ``remove_scheduled_pod``, a note to
the ``ClusterDelta`` as ``scheduler/core.py`` ``_note_node`` makes it,
then ``BatchScheduler.refresh_context`` before the next gang), and the
reading of each gang's answers into plain arrays for the reference.

Only this module and ``run.py`` import the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from bench_port import fleet as fleet_mod
from bench_port.reference import HELPER, MISC, PROC, Answers


class Program:
    """The port, set up for one configuration on one device."""

    def __init__(self, cfg: dict, mix: dict, device: str):
        from nhd_tpu_torch.core.node import HostNode
        from nhd_tpu_torch.core.request import CpuRequest, GroupRequest, PodRequest
        from nhd_tpu_torch.core.topology import MapMode, SmtMode
        from nhd_tpu_torch.solver.batch import BatchItem, BatchScheduler
        from nhd_tpu_torch.solver.encode import ClusterDelta

        self.BatchItem = BatchItem
        fl = cfg["fleet"]
        self.nodes: Dict[str, HostNode] = {}
        for i in range(fl["nodes"]):
            node = HostNode(fleet_mod.node_name(fl, i))
            if not node.parse_labels(fleet_mod.node_labels(fl, i)):
                raise RuntimeError(f"label parse failed for {node.name}")
            node.set_hugepages(fl["hugepages_gb"], fl["hugepages_gb"])
            self.nodes[node.name] = node
        self.index = {name: i for i, name in enumerate(self.nodes)}
        respect_busy = cfg["guarantees"]["respect_busy"]
        self.sched = BatchScheduler(device=device, respect_busy=respect_busy)
        self.delta = ClusterDelta(self.nodes, respect_busy=respect_busy)
        self.ctx = self.sched.make_context(self.nodes, delta=self.delta)

        def smt(on: bool):
            return SmtMode.ON if on else SmtMode.OFF

        self.groups = list(fl["groups"])
        self.requests: List[List[object]] = []
        for t in mix["pod_types"]:
            grps = tuple(
                GroupRequest(proc=CpuRequest(g["proc"], smt(g["proc_smt"])),
                             misc=CpuRequest(g["helpers"], smt(g["helper_smt"])),
                             gpus=g["gpus"], nic_rx_gbps=g["rx_gbps"],
                             nic_tx_gbps=g["tx_gbps"])
                for g in t["groups"])
            self.requests.append([
                PodRequest(groups=grps, misc=CpuRequest(t["misc"], smt(t["misc_smt"])),
                           hugepages_gb=t["hugepages_gb"],
                           map_mode=MapMode[t["map_mode"]],
                           node_groups=frozenset({grp})).interned()
                for grp in self.groups])
        self.n_types = len(self.requests)
        self.mac_index = fleet_mod.Hardware.of(
            fl, cfg["guarantees"]["nic_bw_avail"]).mac_index()

    # -- one gang ------------------------------------------------------

    def items(self, gang) -> Tuple[list, np.ndarray, np.ndarray]:
        ptype = gang.pod_types(self.n_types)
        pgroup = gang.pod_groups(self.n_types, len(self.groups))
        reqs = self.requests
        make = self.BatchItem
        items = [make(("bench", f"g{gang.index}-{j}"), reqs[t][g])
                 for j, (t, g) in enumerate(zip(ptype.tolist(), pgroup.tolist()))]
        return items, ptype, pgroup

    def schedule(self, items):
        return self.sched.schedule(self.ctx.nodes, items, context=self.ctx)

    def held(self, results) -> list:
        """(node name, topology) of each placed pod, as the node mirror
        registered it; None for a pod left unplaced."""
        nodes = self.ctx.nodes
        out = []
        for r in results:
            if r.node is None:
                out.append(None)
                continue
            ns, pod = r.key
            out.append((r.node, nodes[r.node].pod_info.get((pod, ns))))
        return out

    def teardown(self, gang_items, held) -> None:
        """Release a gang's pods the daemon's way, and note their nodes."""
        nodes = self.ctx.nodes
        note = self.delta.note
        for item, h in zip(gang_items, held):
            if h is None:
                continue
            name, top = h
            node = nodes[name]
            ns, pod = item.key
            if top is not None:
                node.release_from_topology(top)
            node.remove_scheduled_pod(pod, ns)
            note(name)

    def refresh(self) -> None:
        self.sched.refresh_context(self.ctx)

    def answers(self, held, ptype, pgroup) -> Answers:
        """The gang's answers as plain arrays: each placed pod's node and
        the cores, GPUs and NICs its topology names."""
        index = self.index
        macs = self.mac_index
        n = len(held)
        node = np.full(n, -1, np.int64)
        cp, cg, cpart, cid = [], [], [], []
        gp, gg, gid = [], [], []
        np_, ng, nid, nrx, ntx = [], [], [], [], []
        for p, h in enumerate(held):
            if h is None:
                continue
            name, top = h
            node[p] = index[name]
            if top is None:
                continue
            for g, pg in enumerate(top.proc_groups):
                for c in pg.proc_cores:
                    cp.append(p); cg.append(g); cpart.append(PROC); cid.append(c.core)
                for gpu in pg.gpus:
                    gp.append(p); gg.append(g); gid.append(gpu.device_id)
                    for c in gpu.cpu_cores:
                        cp.append(p); cg.append(g); cpart.append(PROC); cid.append(c.core)
                for c in pg.misc_cores:
                    cp.append(p); cg.append(g); cpart.append(HELPER); cid.append(c.core)
                rx_ids = {id(c) for c in pg.proc_cores}
                for pair in top.nic_pairs:
                    if id(pair.rx_core) in rx_ids:
                        np_.append(p); ng.append(g); nid.append(macs.get(pair.mac, -1))
                        nrx.append(pair.rx_core.nic_speed)
                        ntx.append(pair.tx_core.nic_speed)
            for c in top.misc_cores:
                cp.append(p); cg.append(-1); cpart.append(MISC); cid.append(c.core)

        def i64(x):
            return np.asarray(x, np.int64)

        return Answers(node, i64(ptype), i64(pgroup), i64(cp), i64(cg), i64(cpart),
                       i64(cid), i64(gp), i64(gg), i64(gid), i64(np_), i64(ng),
                       i64(nid), np.asarray(nrx, float), np.asarray(ntx, float))

    # -- after the window ----------------------------------------------

    def resident_rows(self) -> Dict[str, np.ndarray]:
        """The resident device rows as host arrays, once every staged row
        has reached the device (the flush the guard's audit makes)."""
        dev = self.ctx.dev
        if dev is None:
            return {}
        dev._flush_staged()
        from nhd_tpu_torch.solver.kernel import _ARG_ORDER

        return {name: dev.resident(name).cpu().numpy() for name in _ARG_ORDER}
