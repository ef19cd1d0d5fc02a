"""Action and Plugin interfaces (reference framework/interface.go:19-40)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from .session import Session


class Action(ABC):
    """reference interface.go:19-31"""

    @abstractmethod
    def name(self) -> str: ...

    def initialize(self) -> None:
        return None

    @abstractmethod
    def execute(self, ssn: "Session") -> None: ...

    def un_initialize(self) -> None:
        return None


class Plugin(ABC):
    """reference interface.go:34-40. Plugins never act; they install
    callbacks into the Session during on_session_open."""

    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def on_session_open(self, ssn: "Session") -> None: ...

    def on_session_close(self, ssn: "Session") -> None:
        return None
