"""The cluster API seam the cache watches (in-process cluster only; the
reference's real-cluster adapter is not part of the port)."""

from .api import ADDED, DELETED, MODIFIED, ClusterAPI, InProcessCluster
from .errors import (
    ClusterAPIError,
    ClusterUnavailableError,
    ObjectGoneError,
    TerminalClusterError,
    TransientClusterError,
    retry_transient,
)

__all__ = [
    "ADDED", "DELETED", "MODIFIED", "ClusterAPI", "InProcessCluster",
    "ClusterAPIError", "TransientClusterError", "ClusterUnavailableError",
    "TerminalClusterError", "ObjectGoneError", "retry_transient",
]
