"""Architecture and schedule registries of the port.

Resolves an architecture id to its config module with the reference's
name normalisation ("llama3.2-1b" -> ``llama3p2_1b``) and aliases
("phi-3-vision-4.2b" -> ``phi3_vision_4p2b``), holding only the
architectures whose blocks the port has. The others of
``repro/api/registry.py`` (whisper-large-v3, deepseek-v3-671b) arrive
with their blocks (``ROADMAP.md`` queue 1).
Schedules register their ``(SchedParams) -> TickTable`` builders with
:func:`register_schedule`; the built-ins live in ``core/generators.py``,
imported on first lookup.
"""

from __future__ import annotations

import difflib
import importlib


class RegistryError(ValueError):
    """Unknown architecture (message is actionable)."""


ARCHS = {"llama3p2_1b": "repro_torch.configs.llama3p2_1b",
         "jamba_v0p1_52b": "repro_torch.configs.jamba_v0p1_52b",
         "gpt_paper": "repro_torch.configs.gpt_paper",
         "yi_9b": "repro_torch.configs.yi_9b",
         "minitron_4b": "repro_torch.configs.minitron_4b",
         "phi4_mini_3p8b": "repro_torch.configs.phi4_mini_3p8b",
         "qwen2_moe_a2p7b": "repro_torch.configs.qwen2_moe_a2p7b",
         "phi3_vision_4p2b": "repro_torch.configs.phi3_vision_4p2b",
         "xlstm_1p3b": "repro_torch.configs.xlstm_1p3b"}
# the reference's aliases of the registered architectures that the
# normalisation does not already turn into their canonical names
ALIASES = {"phi_3_vision_4p2b": "phi3_vision_4p2b"}


def get_arch(name: str):
    """The config module of an architecture id (canonical or alias)."""
    key = str(name).replace("-", "_").replace(".", "p")
    key = ALIASES.get(key, key)
    if key not in ARCHS:
        close = difflib.get_close_matches(key, list(ARCHS), n=1)
        hint = f" (did you mean {close[0]!r}?)" if close else ""
        raise RegistryError(
            f"unknown architecture {name!r}{hint}; the port knows: "
            f"{', '.join(list_archs())}. whisper-large-v3 and "
            "deepseek-v3-671b arrive with their blocks (ROADMAP.md queue 1 "
            "items 6d-6e).")
    return importlib.import_module(ARCHS[key])


def list_archs() -> list[str]:
    return sorted(ARCHS)


class _ScheduleRegistry:
    """Schedule name -> builder, loading the built-ins on first lookup."""

    def __init__(self, preload: str):
        self._preload: str | None = preload
        self._entries: dict = {}

    def _ensure_builtins(self) -> None:
        if self._preload is not None:
            mod, self._preload = self._preload, None
            importlib.import_module(mod)

    def register(self, name: str, obj=None, *, overwrite: bool = False):
        def put(fn):
            if name in self._entries and not overwrite:
                raise RegistryError(
                    f"schedule {name!r} is already registered; pass "
                    "overwrite=True to replace it")
            self._entries[name] = fn
            return fn
        return put if obj is None else put(obj)

    def get(self, name: str):
        self._ensure_builtins()
        if name not in self._entries:
            raise RegistryError(
                f"unknown schedule {name!r}; the port knows: "
                f"{', '.join(self.names())}")
        return self._entries[name]

    def names(self) -> list[str]:
        self._ensure_builtins()
        return sorted(self._entries)


SCHEDULE_REGISTRY = _ScheduleRegistry("repro_torch.core.generators")


def register_schedule(name: str, obj=None, *, overwrite: bool = False):
    """Register a schedule generator ``(SchedParams) -> TickTable``
    (decorator-friendly)."""
    return SCHEDULE_REGISTRY.register(name, obj, overwrite=overwrite)


def list_schedules() -> list[str]:
    return SCHEDULE_REGISTRY.names()
