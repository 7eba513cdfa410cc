"""Public API of the port: the serve Session and the architecture registry."""

from repro_torch.api.registry import get_arch, list_archs
from repro_torch.api.session import Session, session
from repro_torch.api.spec import SessionError, SessionSpec

__all__ = ["Session", "SessionError", "SessionSpec", "get_arch",
           "list_archs", "session"]
