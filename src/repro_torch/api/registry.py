"""Architecture registry of the port.

Resolves an architecture id to its config module with the reference's
name normalisation ("llama3.2-1b" -> ``llama3p2_1b``), holding only the
architectures whose blocks the port has. The others of
``repro/api/registry.py`` arrive with their blocks (``ROADMAP.md``
queue 1).
"""

from __future__ import annotations

import difflib
import importlib


class RegistryError(ValueError):
    """Unknown architecture (message is actionable)."""


ARCHS = {"llama3p2_1b": "repro_torch.configs.llama3p2_1b"}


def get_arch(name: str):
    """The config module of an architecture id (canonical or alias)."""
    key = str(name).replace("-", "_").replace(".", "p")
    if key not in ARCHS:
        close = difflib.get_close_matches(key, list(ARCHS), n=1)
        hint = f" (did you mean {close[0]!r}?)" if close else ""
        raise RegistryError(
            f"unknown architecture {name!r}{hint}; the port knows: "
            f"{', '.join(list_archs())}. The other architectures of repro "
            "arrive with their blocks (ROADMAP.md queue 1).")
    return importlib.import_module(ARCHS[key])


def list_archs() -> list[str]:
    return sorted(ARCHS)
