"""Plugin-builder and action registries.

Mirrors reference framework/plugins.go (:30 RegisterPluginBuilder,
:45 GetPluginBuilder, :58 RegisterAction, :66 GetAction). Thread-safe global
maps; plugins/actions self-register at import time (the reference uses
package init(), triggered by blank imports in cmd/kube-batch/main.go:33-35 —
here the ``plugins`` package import does the same).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ..utils.lockdebug import wrap_lock
from .arguments import Arguments
from .interface import Action, Plugin

PluginBuilder = Callable[[Arguments], Plugin]

_lock = wrap_lock("framework.registry")
_plugin_builders: Dict[str, PluginBuilder] = {}
_actions: Dict[str, Action] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    with _lock:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    with _lock:
        return _plugin_builders.get(name)


def register_action(action: Action) -> None:
    with _lock:
        _actions[action.name()] = action


def get_action(name: str) -> Tuple[Optional[Action], bool]:
    with _lock:
        act = _actions.get(name)
        return act, act is not None


def cleanup_plugin_builders() -> None:
    with _lock:
        _plugin_builders.clear()
