"""Triad libconfig format: config text ⇄ PodTopology round trip.

Functional equivalent of the reference's nhd/TriadCfgParser.py. The Triad
format's defining trick is *indirection*: the TopologyCfg section does not
hold core numbers itself, it names the config fields (by path) that do
(TriadCfgParser.py:122-127,158-181). The scheduler later rewrites those very
fields with the chosen physical IDs, so the pod boots from its own solved
config (TriadCfgParser.py:413-459).

Expected config shape (all reference-format compatible):

    TopologyCfg: {
      cpu_arch = "SKYLAKE";             // mandatory (TriadCfgParser.py:62)
      ext_cores = ["CtrlCores[0]"];     // mandatory: paths of top-level misc cores
      ext_cores_smt = true;
      kni_vlan = "KniVlan";             // mandatory: path of the ctrl VLAN field
      map_type = "NUMA";                // or "PCI"
      mod_defs = ( { module = "mods";   // one entry per module *type*
                     helper_cores = ["helpers"]; helper_cores_smt = true;
                     data_vlan = "vlan";
                     dp_group = { name = "dp"; proc_cores_smt = true;
                                  gpu_type = "V100"; };
                     nic_cores = ["rx", "rx_speeds", "tx", "tx_speeds", true];
                   } );
    }
    mods = ( { module = "demod0"; helpers = [-1,-1]; vlan = 0;
               dp = ( { rx_cores=[-1]; rx_speeds=[10.0]; tx_cores=[-1];
                        tx_speeds=[10.0]; cpu_workers=[-1];
                        gpu_map=((-1,0),(-1,0)); } ); } );
    Hugepages_GB = 16;
    CtrlCores = [-1]; KniVlan = 0;
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

from nhd_tpu_torch.config import libconfig
from nhd_tpu_torch.config.paths import PathError, path_get, path_set
from nhd_tpu_torch.config.parser import CfgParser, register_cfg_parser
from nhd_tpu_torch.core.topology import (
    Core,
    CpuArch,
    Gpu,
    GpuKind,
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

_MANDATORY_TOPOLOGY_FIELDS = ("cpu_arch", "ext_cores", "kni_vlan")


class TriadCfgParser(CfgParser):
    """Parses Triad libconfig text and writes solved assignments back."""

    def __init__(self, data: str, is_file: bool = False):
        self.logger = get_logger(__name__)
        text = open(data).read() if is_file else data
        self.cfg = libconfig.loads(text)
        self.top = PodTopology()

    # ------------------------------------------------------------------
    # config → topology
    # ------------------------------------------------------------------

    def to_topology(self, parse_net: bool = False) -> Optional[PodTopology]:
        """Reference: TriadCfgParser.py:337-380 (same stage order/failure modes)."""
        if "TopologyCfg" not in self.cfg:
            self.logger.error("no TopologyCfg section in Triad config")
            return None
        if not self._check_mandatory_fields():
            return None

        arch = CpuArch.from_config_name(self.cfg.TopologyCfg.cpu_arch)
        if arch is None:
            self.logger.error(f"unknown cpu_arch {self.cfg.TopologyCfg.cpu_arch!r}")
            return None
        self.top.arch = arch

        if not self._parse_misc_cores():
            return None
        if not self._parse_kni_vlan():
            return None
        if not self._parse_mod_groups():
            return None
        if not self._parse_hugepages():
            return None
        if parse_net and not self._parse_net():
            return None
        return self.top

    def _check_mandatory_fields(self) -> bool:
        """Reference: TriadCfgParser.py:49-71."""
        for fld in _MANDATORY_TOPOLOGY_FIELDS:
            if fld not in self.cfg.TopologyCfg:
                self.logger.error(f"mandatory field {fld!r} missing from TopologyCfg")
                return False
        return True

    def _parse_misc_cores(self) -> bool:
        """Top-level management cores named by path in ext_cores
        (reference: TriadCfgParser.py:107-132)."""
        tcfg = self.cfg.TopologyCfg
        if "ext_cores" not in tcfg or "ext_cores_smt" not in tcfg:
            self.logger.error("ext_cores/ext_cores_smt missing from TopologyCfg")
            return False
        self.top.misc_cores_smt = SmtMode.ON if tcfg.ext_cores_smt else SmtMode.OFF
        for path in tcfg.ext_cores:
            try:
                value = int(path_get(self.cfg, path))
            except (PathError, TypeError, ValueError) as exc:
                self.logger.error(f"cannot resolve ext_core path {path!r}: {exc}")
                return False
            self.top.misc_cores.append(
                Core(path, 0, NicDir.NONE, NumaHint.DONT_CARE, value)
            )
        return True

    def _parse_kni_vlan(self) -> bool:
        """Reference: TriadCfgParser.py:81-92 — records the *path* of the
        control VLAN field; the value is assigned at schedule time."""
        self.top.ctrl_vlan = VlanInfo(self.cfg.TopologyCfg.kni_vlan, 0)
        return True

    def _parse_hugepages(self) -> bool:
        """Reference: TriadCfgParser.py:94-105."""
        if "Hugepages_GB" not in self.cfg:
            self.logger.error("Hugepages_GB missing from config")
            return False
        self.top.hugepages_gb = int(self.cfg.Hugepages_GB)
        return True

    def _parse_mod_groups(self) -> bool:
        """Walk mod_defs, building one ProcGroup per module instance
        (reference: TriadCfgParser.py:134-309)."""
        tcfg = self.cfg.TopologyCfg
        if "mod_defs" not in tcfg:
            self.logger.error("mod_defs missing from TopologyCfg")
            return False
        if "map_type" not in tcfg:
            self.logger.error("map_type missing from TopologyCfg")
            return False
        self.top.map_mode = MapMode.from_config_name(tcfg.map_type)

        for md in tcfg.mod_defs:
            if md.module not in self.cfg:
                self.logger.error(f"module {md.module!r} not found at config top level")
                return False
            for idx in range(len(self.cfg[md.module])):
                group = self._parse_module_instance(md, f"{md.module}[{idx}]")
                if group is None:
                    return False
                self.top.proc_groups.append(group)
        return True

    def _parse_module_instance(self, md: Any, mattr: str) -> Optional[ProcGroup]:
        pg = ProcGroup()

        if "helper_cores" in md:
            if "helper_cores_smt" not in md:
                self.logger.error(f"helper_cores_smt missing in mod_def {md.module!r}")
                return None
            pg.helper_smt = SmtMode.ON if md.helper_cores_smt else SmtMode.OFF
            for member in md.helper_cores:
                base = f"{mattr}.{member}"
                try:
                    attr = path_get(self.cfg, base)
                except PathError as exc:
                    self.logger.error(f"cannot resolve helper path {base!r}: {exc}")
                    return None
                # A helper member may be a scalar field or an array of cores
                # (reference: TriadCfgParser.py:167-179).
                names = (
                    [f"{base}[{i}]" for i in range(len(attr))]
                    if isinstance(attr, (list, tuple))
                    else [base]
                )
                for name in names:
                    value = int(path_get(self.cfg, name))
                    pg.misc_cores.append(
                        Core(name, 0, NicDir.NONE, NumaHint.GROUP, value)
                    )

        if "data_vlan" in md:
            pg.vlan = VlanInfo(f"{mattr}.{md.data_vlan}", 0)

        if "dp_group" in md and not self._parse_dp_group(md, mattr, pg):
            return None

        if "nic_cores" in md and not self._parse_nic_cores(md, mattr, pg):
            return None

        return pg

    def _add_nic_core_pair(
        self, pg: ProcGroup, rx_name: str, rx_speed: float, tx_name: str, tx_speed: float
    ) -> None:
        rx = Core(rx_name, rx_speed, NicDir.RX, NumaHint.GROUP, int(path_get(self.cfg, rx_name)))
        tx = Core(tx_name, tx_speed, NicDir.TX, NumaHint.GROUP, int(path_get(self.cfg, tx_name)))
        pg.proc_cores.extend([rx, tx])
        self.top.nic_pairs.append(NicPair(rx, tx))

    def _parse_dp_group(self, md: Any, mattr: str, pg: ProcGroup) -> bool:
        """Data-path group: rx/tx NIC cores, CPU workers, and the GPU map
        (reference: TriadCfgParser.py:189-264)."""
        base = f"{mattr}.{md.dp_group.name}"
        try:
            attr = path_get(self.cfg, base)
        except PathError:
            self.logger.error(f"cannot resolve dp_group {base!r}")
            return False
        if len(attr) != 1:
            self.logger.error("multi-NUMA dp_groups are not supported")
            return False
        dp = attr[0]

        lens = {len(dp.rx_cores), len(dp.tx_cores), len(dp.rx_speeds), len(dp.tx_speeds)}
        if len(lens) != 1:
            self.logger.error(f"rx/tx core and speed list lengths differ in {base!r}")
            return False

        pg.proc_smt = SmtMode.ON if md.dp_group.proc_cores_smt else SmtMode.OFF

        for i in range(len(dp.rx_cores)):
            self._add_nic_core_pair(
                pg,
                f"{base}[0].rx_cores[{i}]",
                dp.rx_speeds[i],
                f"{base}[0].tx_cores[{i}]",
                dp.tx_speeds[i],
            )

        if "cpu_workers" in dp:
            for i in range(len(dp.cpu_workers)):
                name = f"{base}[0].cpu_workers[{i}]"
                pg.proc_cores.append(
                    Core(name, 0, NicDir.NONE, NumaHint.GROUP, int(path_get(self.cfg, name)))
                )

        # gpu_map entries are (cpu_core_field, gpu_id) pairs; entries sharing a
        # placeholder gpu_id form one GPU with several feeder cores
        # (reference: TriadCfgParser.py:240-264).
        by_gpu: Dict[Any, List[tuple]] = defaultdict(list)
        if "gpu_map" in dp:
            for i, entry in enumerate(dp.gpu_map):
                if len(entry) != 2:
                    self.logger.error(f"gpu_map entry {i} in {base!r} is not a pair")
                    continue
                by_gpu[entry[1]].append(
                    (f"{base}[0].gpu_map[{i}][1]", f"{base}[0].gpu_map[{i}][0]")
                )

        kind = GpuKind.from_config_name(md.dp_group.gpu_type) if "gpu_type" in md.dp_group else GpuKind.ANY
        if kind is None:
            self.logger.error(f"unknown gpu_type {md.dp_group.gpu_type!r}")
            return False

        for gpu_key, members in by_gpu.items():
            cores = [
                Core(cpu_name, 0, NicDir.NONE, NumaHint.GROUP, int(path_get(self.cfg, cpu_name)))
                for _, cpu_name in members
            ]
            # The grouping key doubles as the device id: a placeholder in a
            # fresh config, the physical id when re-parsing a deployed one —
            # the restart-replay path depends on it (reference:
            # TriadCfgParser.py:264, NHDScheduler.py:107-144).
            pg.gpus.append(
                Gpu(cores, [dev_name for dev_name, _ in members], kind, int(gpu_key))
            )
        return True

    def _parse_nic_cores(self, md: Any, mattr: str, pg: ProcGroup) -> bool:
        """Non-data-path NIC cores: a 5-tuple of member names
        [rx, rx_speeds, tx, tx_speeds, smt] (reference: TriadCfgParser.py:266-302)."""
        if len(md.nic_cores) != 5:
            self.logger.error(f"nic_cores in {md.module!r} must have 5 entries")
            return False
        try:
            rx_cores = path_get(self.cfg, f"{mattr}.{md.nic_cores[0]}")
            rx_speeds = path_get(self.cfg, f"{mattr}.{md.nic_cores[1]}")
            tx_cores = path_get(self.cfg, f"{mattr}.{md.nic_cores[2]}")
            tx_speeds = path_get(self.cfg, f"{mattr}.{md.nic_cores[3]}")
        except PathError as exc:
            self.logger.error(f"cannot resolve nic_cores members in {mattr!r}: {exc}")
            return False
        if len({len(rx_cores), len(rx_speeds), len(tx_cores), len(tx_speeds)}) != 1:
            self.logger.error(f"nic_cores list lengths differ in {mattr!r}")
            return False

        pg.proc_smt = SmtMode.ON if md.nic_cores[4] else SmtMode.OFF
        for i in range(len(rx_cores)):
            self._add_nic_core_pair(
                pg,
                f"{mattr}.{md.nic_cores[0]}[{i}]",
                rx_speeds[i],
                f"{mattr}.{md.nic_cores[2]}[{i}]",
                tx_speeds[i],
            )
        return True

    def _parse_net(self) -> bool:
        """Reload MAC/ring assignments from a *deployed* config's
        Network_Config section (reference: TriadCfgParser.py:311-335)."""
        if "Network_Config" not in self.cfg:
            self.logger.error("no Network_Config section in deployed config")
            return False
        for net in self.cfg.Network_Config:
            for i in range(len(net.rxCores)):
                pair = self.top.nic_pair_for_core_numbers(
                    int(net.rxCores[i]), int(net.txCores[i])
                )
                if pair is None:
                    self.logger.error(
                        f"no NIC pair for cores {net.rxCores[i]}/{net.txCores[i]}"
                    )
                    return False
                pair.mac = net.mac
                if "rx_mbufs" in net:
                    pair.rx_ring_size = int(net.rx_mbufs[i])
        return True

    # ------------------------------------------------------------------
    # topology → config (write-back of the solved assignment)
    # ------------------------------------------------------------------

    def to_config(self) -> str:
        """Write solved physical IDs into the original config text
        (reference: TriadCfgParser.py:413-459)."""
        for c in self.top.misc_cores:
            path_set(self.cfg, c.name, c.core)

        if self.top.ctrl_vlan is not None:
            path_set(
                self.cfg, self.top.ctrl_vlan.name, self.top.ctrl_vlan.vlan
            )

        for pg in self.top.proc_groups:
            if pg.vlan is not None:
                path_set(self.cfg, pg.vlan.name, pg.vlan.vlan)
            for core in pg.proc_cores:
                path_set(self.cfg, core.name, core.core)
            for core in pg.misc_cores:
                path_set(self.cfg, core.name, core.core)

            if pg.gpus:
                # Rebuild the whole gpu_map tuple at once: libconfig lists are
                # immutable, so element-wise patching is not possible
                # (reference: TriadCfgParser.py:436-452).
                gpu_map = tuple(
                    (core.core, gpu.device_id)
                    for gpu in pg.gpus
                    for core in gpu.cpu_cores
                )
                first = pg.gpus[0].dev_id_names[0]
                parent_path = first[: first.rfind(".")]
                path_set(self.cfg, f"{parent_path}.gpu_map", gpu_map)

        path_set(self.cfg, "Network_Config", self._populate_net_cfg())
        return libconfig.dumps(self.cfg)

    def _populate_net_cfg(self) -> tuple:
        """Synthesize the Network_Config section from assigned NIC pairs
        (reference: TriadCfgParser.py:462-496, including the fake module/if
        naming and 10.0.0.x address scheme)."""
        by_mac: Dict[str, List[tuple]] = defaultdict(list)
        for pair in self.top.nic_pairs:
            by_mac[pair.mac].append(
                (pair.rx_core.core, pair.tx_core.core, pair.rx_ring_size)
            )

        sections = []
        if_count = 0
        for mac, entries in by_mac.items():
            rx, tx, rings = zip(*entries)
            ips = [f"10.0.0.{i + if_count}" for i in range(len(rx))]
            sections.append(
                {
                    "module": f"fake_{if_count}",
                    "ifname": f"fake_if_{if_count}",
                    "mac": mac,
                    "rxCores": list(rx),
                    "txCores": list(tx),
                    "rx_mbufs": list(rings),
                    "gwIps": [self.top.data_default_gw] * len(rx),
                    "txIps": ips,
                    "rxIps": ips,
                    "ts_group": True,
                }
            )
            if_count += len(rx)
        return tuple(sections)

    def to_gpu_map(self) -> Dict[str, int]:
        """Pod GPU-device annotation: nvidia<i> → physical device id
        (reference: TriadCfgParser.py:397-410).

        Deviation: the reference restarts the nvidia<i> index at 0 for every
        proc group (TriadCfgParser.py:403), so later groups overwrite earlier
        groups' annotations on multi-group GPU pods. Here the index runs
        across groups — every assigned GPU appears exactly once.
        """
        annotations: Dict[str, int] = {}
        index = 0
        for pg in self.top.proc_groups:
            for gpu in pg.gpus:
                for _ in gpu.dev_id_names:
                    annotations[f"nvidia{index}"] = gpu.device_id
                    index += 1
        return annotations


register_cfg_parser("triad", TriadCfgParser)
