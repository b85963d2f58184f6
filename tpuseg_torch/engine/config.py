"""Config facade (the port's copy of ``ConfigNode`` from
``tpuseg/engine/config.py``): a yacs-style YAML tree with
``merge_from_file(yaml)`` and dotted overrides
(``MODEL.RPN.PRE_NMS_TOP_N_TEST`` ...), and YOLACT's ``Config.copy({...})``
inheritance: attribute access, deep copy with overrides, YAML merge,
dotted-key list merge, freeze. PyYAML is imported only by
:meth:`ConfigNode.merge_from_file`, :meth:`ConfigNode.merge_from_list` and
:meth:`ConfigNode.dump`. The registry of named presets
(:func:`register_config`, :func:`get_config`) holds the ViT presets of
``tpuseg_torch/configs/presets.py``; its YOLACT presets are plain dicts.
"""
from __future__ import annotations

import copy
from typing import Any


class ConfigNode(dict):
    """Nested attribute dict with yacs-style merging and freezing."""

    __frozen_key = "__frozen__"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = ConfigNode(value) if isinstance(value, dict) and not isinstance(
            value, ConfigNode
        ) else value

    def __setitem__(self, name: str, value: Any) -> None:
        # Attribute sets, merges, and item assignment funnel through here;
        # the remaining dict mutators are guarded individually below.
        if getattr(self, "_frozen", False):
            raise AttributeError(f"config is frozen; cannot set {name}")
        super().__setitem__(name, value)

    def _guard_frozen(self) -> None:
        if getattr(self, "_frozen", False):
            raise AttributeError("config is frozen; cannot mutate")

    def __delitem__(self, name: str) -> None:
        self._guard_frozen()
        super().__delitem__(name)

    def update(self, *args, **kwargs) -> None:  # type: ignore[override]
        self._guard_frozen()
        super().update(*args, **kwargs)

    def pop(self, *args):  # type: ignore[override]
        # pop(missing_key, default) mutates nothing — guard only when the
        # pop would actually remove an entry (mirrors setdefault's
        # read-path exemption)
        if not args or args[0] in self or len(args) < 2:
            self._guard_frozen()
        return super().pop(*args)

    def popitem(self):  # type: ignore[override]
        self._guard_frozen()
        return super().popitem()

    def clear(self) -> None:  # type: ignore[override]
        self._guard_frozen()
        super().clear()

    def setdefault(self, key, default=None):  # type: ignore[override]
        if key not in self:
            self._guard_frozen()
        return super().setdefault(key, default)

    def __ior__(self, other):  # type: ignore[override]
        # ``cfg |= {...}``: dict.__ior__ is C-level and would bypass the
        # guards above
        self._guard_frozen()
        super().update(other)
        return self

    # -- copy/pickle protocol -------------------------------------------------
    # deepcopy/pickle must bypass the frozen guard: copy._reconstruct restores
    # the _frozen state before re-inserting dict items, which would raise.
    def __deepcopy__(self, memo: dict) -> "ConfigNode":
        new = ConfigNode()
        memo[id(self)] = new
        for k, v in self.items():
            dict.__setitem__(new, k, copy.deepcopy(v, memo))
        object.__setattr__(new, "_frozen", self._frozen)
        return new

    def __reduce__(self):
        return (_reconstruct_config_node, (dict(self), self._frozen))

    # -- yacs surface --------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def clone(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self._to_dict()))

    def _to_dict(self) -> dict:
        return {
            k: v._to_dict() if isinstance(v, ConfigNode) else v
            for k, v in self.items()
        }

    def merge_from_other(self, other: dict) -> "ConfigNode":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_other(v)
            else:
                self[k] = ConfigNode(v) if isinstance(v, dict) else v
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        return self.merge_from_other(data)

    def merge_from_list(self, opts: list) -> "ConfigNode":
        """yacs-style: ["MODEL.RPN.PRE_NMS_TOP_N_TEST", 6000, ...]."""
        import yaml

        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], ConfigNode):
                    node[p] = ConfigNode()
                node = node[p]
            if isinstance(value, str):
                try:
                    value = yaml.safe_load(value)
                except yaml.YAMLError:
                    pass
            node[parts[-1]] = value
        return self

    # -- yolact Config surface -------------------------------------------------
    def copy(self, overrides: dict | None = None) -> "ConfigNode":
        """YOLACT data/config.py Config.copy({...}) inheritance."""
        new = self.clone()
        if overrides:
            new.merge_from_other(overrides)
        return new

    def replace(self, overrides: dict) -> None:
        """YOLACT Config.replace: in-place override."""
        self.merge_from_other(overrides)

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self._to_dict(), sort_keys=False)


def _reconstruct_config_node(items: dict, frozen: bool) -> ConfigNode:
    node = ConfigNode()
    for k, v in items.items():
        dict.__setitem__(node, k, v)
    object.__setattr__(node, "_frozen", frozen)
    return node


_REGISTRY: dict = {}


def register_config(name: str, cfg: ConfigNode) -> ConfigNode:
    _REGISTRY[name] = cfg
    return cfg


def get_config(name: str) -> ConfigNode:
    """A copy of the preset registered as ``name`` (the reference's
    ``--config=<name>``)."""
    import tpuseg_torch.configs.presets  # noqa: F401  (registers them)

    if name not in _REGISTRY:
        raise KeyError(
            f"unknown config '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name].clone()


def available_configs() -> list:
    import tpuseg_torch.configs.presets  # noqa: F401

    return sorted(_REGISTRY)
