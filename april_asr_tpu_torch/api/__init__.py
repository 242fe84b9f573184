"""Public API: Model, Session (sync, asynchronous, speaker), Result, Token."""

from .model import Model
from .session import Session
from .types import Result, Token

__all__ = ["Model", "Session", "Result", "Token"]
