"""Public API of the port: the train and serve Session and the
architecture and schedule registries."""

from repro_torch.api.registry import get_arch, list_archs, list_schedules
from repro_torch.api.session import Session, session
from repro_torch.api.spec import SessionError, SessionSpec

__all__ = ["Session", "SessionError", "SessionSpec", "get_arch",
           "list_archs", "list_schedules", "session"]
