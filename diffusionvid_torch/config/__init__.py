from .node import CfgNode
from .defaults import get_default_cfg

__all__ = ["CfgNode", "get_default_cfg", "load_config"]


def load_config(config_file: str | None = None, opts: list | None = None) -> CfgNode:
    """Defaults, then the experiment YAML, then the CLI's ``KEY VALUE``
    overrides (the reference's merge order, ``tools/train_net.py:202-207``)."""
    c = get_default_cfg()
    if config_file:
        c.merge_from_file(config_file)
    if opts:
        c.merge_from_list(list(opts))
    return c
