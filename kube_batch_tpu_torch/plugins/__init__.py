"""Plugins (mirrors reference pkg/scheduler/plugins).

Importing this package registers every builtin plugin with the framework
registry (the reference's factory.go:31-41 / init() pattern). The
``serving`` plugin is not ported yet."""

from . import (  # noqa: F401
    conformance,
    drf,
    gang,
    nodeorder,
    predicates,
    priority,
    proportion,
)
from .util import PredicateError, SessionPodLister
