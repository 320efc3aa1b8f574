"""Placed pods' topologies, filled in one pass from the native round's rows.

The batch round path places a round's winners in one native call
(``FastCluster.assign_round``) and gets back flat int32 buffers. Each
placed pod then needs its ``PodTopology`` filled with those numbers:
synthesized from its request when the caller gave none, or the caller's
own object otherwise. Both read the same per-pod row lists (one
``tolist()`` a buffer a round) and build no ``AssignRecord``.

* ``plan_for(req)``: a ``TopologyPlan`` per request VALUE, cached. It is
  read off one ``request_to_topology(req)`` (so the shape is that
  function's, never restated here): every name, speed, direction and
  hint as shared constants, each core's position in the pod's cores row,
  each GPU's position in its GPU row, and the group whose NIC gives each
  rx/tx pair its MAC. ``build`` makes a pod's filled topology with every
  number passed to the constructors: equal, field for field, to
  ``request_to_topology`` + ``apply_record_to_topology`` of the record
  the same rows give.
* ``fill_given``: the caller's topology filled in place, the walk
  ``apply_record_to_topology`` makes, straight from the rows.

Row layout (native/nhd_assign.cc): cores are group 0's proc cores (GPU
feeders first, then rx, tx and workers, as the fill consumes them), its
helpers, group 1's ..., misc last; counts ``[proc, helpers]`` a group then
``[misc]``; one NIC index a group (-1: none); the GPUs' device ids in
group order (``gpu_ids``: the round's GPU rows mapped through
``FastCluster.gpu_devid``). A placed pod's counts are its request's: a
core batch either hands out every core asked for or fails.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import (
    Core,
    Gpu,
    NicDir,
    NicPair,
    PodTopology,
    ProcGroup,
    VlanInfo,
)

_PLANS: Dict[PodRequest, "TopologyPlan"] = {}
#: cleared past this many entries, as PodRequest's intern table is
_PLANS_MAX = 1 << 16


def _core_spec(c: Core, pos: int) -> tuple:
    return (c.name, c.nic_speed, c.nic_dir, c.numa, pos)


class TopologyPlan:
    """How to build one request value's filled topology from a pod's rows.

    ``error`` is the ``ValueError`` text ``request_to_topology`` gave for
    the request (``build`` then raises it again), else None."""

    def __init__(self, req: PodRequest):
        from nhd_tpu_torch.sim.requests import request_to_topology

        self.error: Optional[str] = None
        self.has_gpus = False
        try:
            top = request_to_topology(req)
        except ValueError as exc:
            self.error = str(exc)
            return
        cores_at = 0
        gpus_at = 0
        groups = []
        where: Dict[int, Tuple[int, int]] = {}   # id(proc core) → (g, i)
        mac_group: Dict[int, int] = {}           # id(pair) → group of its MAC
        for g, (grp, pg) in enumerate(zip(req.groups, top.proc_groups)):
            pos = cores_at
            gpus = []
            for k, gpu in enumerate(pg.gpus):
                feeders = []
                for c in gpu.cpu_cores:
                    feeders.append(_core_spec(c, pos))
                    pos += 1
                gpus.append((tuple(feeders), tuple(gpu.dev_id_names),
                             gpu.kind, gpus_at + k))
            proc = []
            for i, c in enumerate(pg.proc_cores):
                proc.append(_core_spec(c, pos))
                pos += 1
                where[id(c)] = (g, i)
                if c.nic_dir in (NicDir.RX, NicDir.TX):
                    pair = top.nic_pair_for_core(c)
                    if pair is not None:
                        mac_group[id(pair)] = g
            helpers = [
                _core_spec(c, cores_at + grp.proc.count + j)
                for j, c in enumerate(pg.misc_cores)
            ]
            groups.append((
                tuple(gpus), tuple(proc), tuple(helpers), pg.proc_smt,
                pg.helper_smt, None if pg.vlan is None else pg.vlan.name,
            ))
            cores_at += grp.proc.count + grp.misc.count
            gpus_at += grp.gpus
        self.has_gpus = gpus_at > 0
        self.groups = tuple(groups)
        self.misc = tuple(
            _core_spec(c, cores_at + j) for j, c in enumerate(top.misc_cores)
        )
        self.pairs = tuple(
            (*where[id(p.rx_core)], *where[id(p.tx_core)],
             mac_group.get(id(p), -1), p.mac, p.rx_ring_size)
            for p in top.nic_pairs
        )
        self.top = (top.arch, top.misc_cores_smt, top.map_mode,
                    None if top.ctrl_vlan is None else top.ctrl_vlan.name,
                    top.hugepages_gb)

    def build(self, cores: List[int], nics: List[int], gpu_ids: List[int],
              node) -> PodTopology:
        """The pod's filled topology, from its row lists and the
        ``HostNode`` it was placed on."""
        if self.error is not None:
            raise ValueError(self.error)
        vlan = node.data_vlan
        groups = []
        procs = []
        for gpus, proc, helpers, proc_smt, helper_smt, vname in self.groups:
            pc = [Core(n, s, d, h, cores[p]) for n, s, d, h, p in proc]
            procs.append(pc)
            groups.append(ProcGroup(
                pc,
                [Core(n, s, d, h, cores[p]) for n, s, d, h, p in helpers],
                [
                    Gpu([Core(n, s, d, h, cores[p]) for n, s, d, h, p in feeders],
                        list(names), kind, gpu_ids[at])
                    for feeders, names, kind, at in gpus
                ],
                proc_smt, helper_smt,
                None if vname is None else VlanInfo(vname, vlan),
            ))
        pairs = []
        if self.pairs:
            node_nics = node.nics
            for g_rx, i_rx, g_tx, i_tx, g_mac, mac, ring in self.pairs:
                if g_mac >= 0:
                    flat = nics[g_mac]
                    mac = node_nics[flat].mac if flat >= 0 else ""
                pairs.append(NicPair(procs[g_rx][i_rx], procs[g_tx][i_tx],
                                     mac, ring))
        arch, misc_smt, map_mode, ctrl, hp = self.top
        return PodTopology(
            arch,
            [Core(n, s, d, h, cores[p]) for n, s, d, h, p in self.misc],
            misc_smt, groups, pairs, map_mode,
            None if ctrl is None else VlanInfo(ctrl, vlan),
            node.gwip, hp,
        )


def plan_for(req: PodRequest) -> Tuple[TopologyPlan, bool]:
    """(the plan of *req*'s value, whether this call built it)."""
    plan = _PLANS.get(req)
    if plan is not None:
        return plan, False
    if len(_PLANS) >= _PLANS_MAX:
        _PLANS.clear()
    plan = _PLANS[req] = TopologyPlan(req)
    return plan, True


def fill_given(top: PodTopology, req: PodRequest, cores: List[int],
               counts: List[int], nics: List[int], gpu_ids: List[int],
               node) -> None:
    """Fill the caller's *top* in place from a pod's rows: the walk of
    ``apply_record_to_topology`` (fast_assign.py), each group's cores cut
    from the row by its counts."""
    vlan = node.data_vlan
    at = 0
    gat = 0
    parts = []
    for g, grp in enumerate(req.groups):
        n_proc, n_help = counts[2 * g], counts[2 * g + 1]
        flat = nics[g]
        parts.append((
            cores[at:at + n_proc], cores[at + n_proc:at + n_proc + n_help],
            gpu_ids[gat:gat + grp.gpus],
            node.nics[flat].mac if flat >= 0 else "",
        ))
        at += n_proc + n_help
        gat += grp.gpus
    misc = cores[at:at + counts[2 * len(req.groups)]]
    for (group_cpus, helper_cpus, devids, mac), pg in zip(parts, top.proc_groups):
        if pg.vlan is not None:
            pg.vlan.vlan = vlan
        for gpu, devid in zip(pg.gpus, devids):
            gpu.device_id = devid
        cursor = 0
        for gpu in pg.gpus:
            for feeder in gpu.cpu_cores:
                feeder.core = group_cpus[cursor]
                cursor += 1
        for core in pg.proc_cores:
            core.core = group_cpus[cursor]
            cursor += 1
            if core.nic_dir in (NicDir.RX, NicDir.TX):
                pair = top.nic_pair_for_core(core)
                if pair is not None:
                    pair.mac = mac
        for helper, c in zip(pg.misc_cores, helper_cpus):
            helper.core = c
    for mc, c in zip(top.misc_cores, misc):
        mc.core = c
    if top.ctrl_vlan is not None:
        top.ctrl_vlan.vlan = vlan
    top.set_data_default_gw(node.gwip)
