"""JSON workload-config format — the second parser behind the plugin seam.

The reference declares a parser ABC and a factory but ships exactly one
format (CfgParser.py:9-33; NHDScheduler.py:228-233 notes the missing
plugin registry). This module proves the rebuilt registry is a real
extension point: a complete second format — parse, solved write-back,
GPU-map annotation, restart-replay reload — that the scheduler picks via
the pod's ``cfg_type: json`` annotation, with zero scheduler changes.

Request document shape (everything but ``groups`` optional)::

    {
      "map_mode": "NUMA" | "PCI",
      "hugepages_gb": 4,
      "misc_cores": {"count": 1, "smt": true},
      "groups": [
        {"proc_cores":   {"count": 4, "smt": true},
         "helper_cores": {"count": 1, "smt": true},
         "gpus": 1,
         "nic": {"rx_gbps": 10.0, "tx_gbps": 5.0, "rx_ring_size": 4096}}
      ]
    }

The solved document is the same request plus an ``assigned`` object per
group (numa, proc/helper core ids, gpu device ids, nic mac) and top-level
``assigned_misc_cores`` — unlike the Triad format there is no path
indirection to write through (TriadCfgParser.py:382-395's magicattr
gymnastics); the solved overlay is regenerated from the topology objects.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from nhd_tpu_torch.config.parser import CfgParser, register_cfg_parser
from nhd_tpu_torch.core.topology import (
    Core,
    Gpu,
    MapMode,
    NicDir,
    NicPair,
    NumaHint,
    PodTopology,
    ProcGroup,
    SmtMode,
    VlanInfo,
)
from nhd_tpu_torch.utils import get_logger


def _smt(block: Optional[dict]) -> SmtMode:
    if not block:
        return SmtMode.OFF
    return SmtMode.ON if block.get("smt", True) else SmtMode.OFF


def _handout_order(pg: ProcGroup) -> List[Core]:
    """Canonical serialization order for a group's cores: NIC rx/tx pair,
    GPU feeders, then plain workers. This is this FORMAT's positional
    contract — to_config writes and to_topology(parse_net=True) reloads
    through this same function, so the round trip is order-consistent by
    construction. (It is NOT the order assign_physical_ids hands cores
    out — that fills feeders before rx/tx — so never correlate these
    positions with allocation order.)"""
    nic_cores = [c for c in pg.proc_cores if c.nic_dir in (NicDir.RX, NicDir.TX)]
    feeders = [c for gpu in pg.gpus for c in gpu.cpu_cores]
    workers = [c for c in pg.proc_cores if c.nic_dir == NicDir.NONE]
    return nic_cores + feeders + workers


class JsonCfgParser(CfgParser):
    """text ⇄ PodTopology for the JSON format (cfg_type ``json``)."""

    def __init__(self, cfg_text: str):
        self.logger = get_logger(__name__)
        self.raw = cfg_text
        self.doc: Optional[dict] = None
        self.top: Optional[PodTopology] = None

    # ------------------------------------------------------------------

    def to_topology(self, parse_net: bool = False) -> Optional[PodTopology]:
        try:
            doc = json.loads(self.raw)
            if not isinstance(doc, dict) or not isinstance(
                doc.get("groups"), list
            ) or not doc["groups"]:
                raise ValueError("document needs a non-empty 'groups' list")
        except ValueError as exc:
            self.logger.error(f"json config parse failed: {exc}")
            return None
        self.doc = doc

        top = PodTopology(
            map_mode=MapMode.from_config_name(doc.get("map_mode", "NUMA")),
            hugepages_gb=int(doc.get("hugepages_gb", 0)),
            misc_cores_smt=_smt(doc.get("misc_cores")),
            ctrl_vlan=VlanInfo("ctrl", int(doc.get("ctrl_vlan", 0))),
        )
        top.set_data_default_gw(doc.get("data_default_gw", ""))
        misc = doc.get("misc_cores") or {}
        assigned_misc = doc.get("assigned_misc_cores") or []
        for i in range(int(misc.get("count", 0))):
            core = Core(f"misc[{i}]")
            if parse_net and i < len(assigned_misc):
                core.core = int(assigned_misc[i])
            top.misc_cores.append(core)

        for gi, g in enumerate(doc["groups"]):
            pg = ProcGroup(
                proc_smt=_smt(g.get("proc_cores")),
                helper_smt=_smt(g.get("helper_cores")),
                vlan=VlanInfo(f"groups[{gi}].vlan", int(g.get("vlan", 0))),
            )
            asg = g.get("assigned") or {}
            proc_ids = asg.get("proc_core_ids") or []
            nic = g.get("nic") or {}
            rx_bw = float(nic.get("rx_gbps", 0.0))
            tx_bw = float(nic.get("tx_gbps", 0.0))
            n_proc = int((g.get("proc_cores") or {}).get("count", 0))
            cursor = 0

            if (rx_bw or tx_bw) and n_proc < 2:
                # an rx/tx pair needs two proc cores; dropping the NIC
                # silently would bind the pod with no network resources
                self.logger.error(
                    f"json config parse failed: groups[{gi}] requests NIC "
                    f"bandwidth but has {n_proc} proc core(s); >= 2 needed"
                )
                return None
            if rx_bw or tx_bw:
                rx = Core(f"groups[{gi}].proc[0]", rx_bw, NicDir.RX,
                          NumaHint.GROUP)
                tx = Core(f"groups[{gi}].proc[1]", tx_bw, NicDir.TX,
                          NumaHint.GROUP)
                pair = NicPair(rx, tx,
                               rx_ring_size=int(nic.get("rx_ring_size", 4096)))
                if parse_net:
                    pair.mac = asg.get("nic_mac", "")
                pg.proc_cores.extend([rx, tx])
                top.nic_pairs.append(pair)
                cursor = 2

            gpu_ids = asg.get("gpu_device_ids") or []
            n_gpus = int(g.get("gpus", 0))
            feeders = min(n_gpus, max(n_proc - cursor, 0))
            for j in range(n_gpus):
                cores = []
                if j < feeders:
                    cores.append(Core(f"groups[{gi}].proc[{cursor}]", 0,
                                      NicDir.NONE, NumaHint.GROUP))
                    cursor += 1
                gpu = Gpu(cores, [f"groups[{gi}].gpu[{j}]"])
                if parse_net and j < len(gpu_ids):
                    gpu.device_id = int(gpu_ids[j])
                pg.gpus.append(gpu)

            for j in range(cursor, n_proc):
                pg.proc_cores.append(
                    Core(f"groups[{gi}].proc[{j}]", 0, NicDir.NONE,
                         NumaHint.GROUP)
                )
            for j in range(int((g.get("helper_cores") or {}).get("count", 0))):
                pg.misc_cores.append(
                    Core(f"groups[{gi}].helper[{j}]", 0, NicDir.NONE,
                         NumaHint.GROUP)
                )

            if parse_net:
                for c, cid in zip(_handout_order(pg), proc_ids):
                    c.core = int(cid)
                for c, cid in zip(pg.misc_cores,
                                  asg.get("helper_core_ids") or []):
                    c.core = int(cid)
            top.proc_groups.append(pg)

        self.top = top
        return top

    # ------------------------------------------------------------------

    def to_config(self) -> str:
        """Regenerate the document with the solved ``assigned`` overlay."""
        doc = dict(self.doc or {})
        top = self.top
        assert top is not None, "to_config before a successful to_topology"
        groups_out = []
        for gi, (g, pg) in enumerate(zip(doc.get("groups", []),
                                         top.proc_groups)):
            g = dict(g)
            asg: Dict[str, Any] = {
                "proc_core_ids": [c.core for c in _handout_order(pg)],
                "helper_core_ids": [c.core for c in pg.misc_cores],
                "gpu_device_ids": [gpu.device_id for gpu in pg.gpus],
            }
            # identity, not ==: equal-valued Core objects exist across groups
            pairs = [
                p for p in top.nic_pairs
                if any(p.rx_core is c for c in pg.proc_cores)
            ]
            if pairs:
                asg["nic_mac"] = pairs[0].mac
            if pg.vlan is not None:
                # solved data-plane VLAN lands in the group's own 'vlan'
                # field, which the parse path already reads back
                g["vlan"] = pg.vlan.vlan
            g["assigned"] = asg
            groups_out.append(g)
        doc["groups"] = groups_out
        doc["assigned_misc_cores"] = [c.core for c in top.misc_cores]
        if top.ctrl_vlan is not None:
            doc["ctrl_vlan"] = top.ctrl_vlan.vlan
        if top.data_default_gw:
            doc["data_default_gw"] = top.data_default_gw
        return json.dumps(doc, indent=2)

    # ------------------------------------------------------------------

    def to_gpu_map(self) -> Dict[str, int]:
        """nvidia<i> → physical device id, indexed across groups (the
        reference restarts per group and overwrites, TriadCfgParser.py:403;
        kept fixed here like the Triad rebuild)."""
        top = self.top
        assert top is not None, "to_gpu_map before a successful to_topology"
        out: Dict[str, int] = {}
        i = 0
        for pg in top.proc_groups:
            for gpu in pg.gpus:
                out[f"nvidia{i}"] = gpu.device_id
                i += 1
        return out


register_cfg_parser("json", JsonCfgParser)
