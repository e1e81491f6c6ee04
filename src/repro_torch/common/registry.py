"""Architecture registry: configs/<id>.py files register themselves here."""
from __future__ import annotations

from typing import Callable, Dict

_ARCHS: Dict[str, Callable] = {}


def register_arch(name: str):
    def deco(fn: Callable):
        _ARCHS[name] = fn
        return fn
    return deco


def get_arch(name: str):
    if name not in _ARCHS:
        # import configs lazily so `import repro_torch` stays cheap
        import repro_torch.configs  # noqa: F401
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[name]()


def list_archs():
    import repro_torch.configs  # noqa: F401
    return sorted(_ARCHS)
