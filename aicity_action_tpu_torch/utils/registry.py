"""Minimal name -> object registry (port of
``aicity_action_tpu/utils/registry.py``; replaces
fvcore.common.registry.Registry). Used for the datasets
(reference: datasets/build.py:15-31)."""


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict = {}

    def register(self, obj=None, name: str | None = None):
        if obj is None:  # used as decorator factory: @REG.register()
            def deco(fn_or_class):
                self._do_register(name or fn_or_class.__name__, fn_or_class)
                return fn_or_class
            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj) -> None:
        if name in self._obj_map:
            raise ValueError(
                f"'{name}' already registered in {self._name} registry"
            )
        self._obj_map[name] = obj

    def get(self, name: str):
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in {self._name} registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()
