"""Scene loading: ``transforms.json`` parsing, the image cache and the
seed point cloud (port of ``gaussctrl_exp_tpu/data/``)."""

from .datamanager import DataManager, DataManagerConfig
from .dataparser import DataParserConfig, DataparserOutputs, load_scene
from .ply import read_ply_points

__all__ = [
    "DataParserConfig",
    "DataparserOutputs",
    "load_scene",
    "DataManager",
    "DataManagerConfig",
    "read_ply_points",
]
