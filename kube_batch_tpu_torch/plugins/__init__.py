"""Plugins (mirrors reference pkg/scheduler/plugins).

Importing this package registers every builtin plugin with the framework
registry (the reference's factory.go:31-41 / init() pattern)."""

from . import (  # noqa: F401
    conformance,
    drf,
    gang,
    nodeorder,
    predicates,
    priority,
    proportion,
    serving,
)
from .util import PredicateError, SessionPodLister
