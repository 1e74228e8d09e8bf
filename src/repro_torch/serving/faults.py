"""Serving failures the engine raises (the port's own copy of the
reference's ``serving/faults.py`` exception types; fault injection is not
ported yet)."""
from __future__ import annotations

from typing import Optional


class EngineFailure(RuntimeError):
    """An inference engine crashed, refused, or is unavailable.

    ``point`` names where it fired (``"submit"`` for down/draining
    engines); ``kind`` is ``"crash"``, ``"down"``, ``"draining"``,
    ``"timeout"`` or the reason a request was refused."""

    def __init__(self, msg: str, point: str = "", kind: str = "crash"):
        super().__init__(msg)
        self.point = point
        self.kind = kind


class EngineTimeout(EngineFailure):
    """``run_until_idle(deadline=...)`` ran out of wall budget; the
    in-flight requests were evacuated and ride on ``.requests``."""

    def __init__(self, msg: str, requests: Optional[list] = None):
        super().__init__(msg, point="run", kind="timeout")
        self.requests = requests or []
