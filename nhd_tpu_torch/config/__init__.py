from nhd_tpu_torch.config.libconfig import ConfigDict, dumps, loads
from nhd_tpu_torch.config.paths import path_get, path_parent_and_key, path_set
from nhd_tpu_torch.config.parser import CfgParser, get_cfg_parser, register_cfg_parser
from nhd_tpu_torch.config.triad import TriadCfgParser
from nhd_tpu_torch.config.jsoncfg import JsonCfgParser

__all__ = [
    "CfgParser",
    "ConfigDict",
    "JsonCfgParser",
    "TriadCfgParser",
    "dumps",
    "get_cfg_parser",
    "loads",
    "path_get",
    "path_parent_and_key",
    "path_set",
    "register_cfg_parser",
]
