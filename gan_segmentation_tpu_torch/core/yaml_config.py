"""Dict-merging yaml config (`deeplabv3plus/lib/config/config.py`).

A copy of ``gan_segmentation_tpu/core/yaml_config.py`` (the port imports
nothing of that package), with ``yaml`` imported by ``load_config`` alone;
``tests/test_torch_seg_data.py`` pins the two together.  A mutable global
config that yaml files merge into, kept for the reference's edict-based
loader (which the hair experiments do not use); prefer the dataclasses of
``core.config``.
"""

from typing import Any, Dict


class AttrDict(dict):
    """edict-like: attribute access over dict entries."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


cfg = AttrDict()


def load_config(config_path: str) -> AttrDict:
    import yaml

    with open(config_path, "r") as f:
        loaded: Dict[str, Any] = yaml.safe_load(f) or {}
    for k, v in loaded.items():
        if k in cfg and isinstance(v, dict):
            for vk, vv in v.items():
                cfg[k][vk] = vv
        elif isinstance(v, dict):
            cfg[k] = AttrDict(v)
        else:
            cfg[k] = v
    return cfg
