"""Config registry of the port (counterpart of ``repro.configs``): the
archs ported so far, by name."""
from typing import Dict

from repro_torch.configs import fm
from repro_torch.configs.base import ArchDef

REGISTRY: Dict[str, ArchDef] = {m.ARCH.name: m.ARCH for m in (fm,)}


def get_arch(name: str) -> ArchDef:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
