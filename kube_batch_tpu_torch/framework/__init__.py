"""Framework kernel (mirrors reference pkg/scheduler/framework)."""

from .arguments import Arguments
from .event import Event, EventHandler, JobBatchEvent
from .framework import close_session, open_session
from .interface import Action, Plugin
from .plugins import (
    cleanup_plugin_builders,
    get_action,
    get_plugin_builder,
    register_action,
    register_plugin_builder,
)
from .session import Session
from .statement import Statement
