from .node import CfgNode
from .defaults import get_default_cfg

__all__ = ["CfgNode", "get_default_cfg", "load_config"]


def load_config(config_file: str | None = None) -> CfgNode:
    """Defaults, then the experiment YAML merged over them."""
    c = get_default_cfg()
    if config_file:
        c.merge_from_file(config_file)
    return c
