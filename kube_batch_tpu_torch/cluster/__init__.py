"""The cluster API seam the cache watches: the in-process cluster, and
the real-cluster adapter (``kube.KubeCluster``, a stdlib REST client of
a Kubernetes API server) behind lazy exports."""

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
    "KubeCluster", "KubeConfig",
    "ClusterAPIError", "TransientClusterError", "ClusterUnavailableError",
    "TerminalClusterError", "ObjectGoneError", "retry_transient",
]


def __getattr__(name):
    # Lazy: the real-cluster adapter pulls in ssl and urllib; embedders
    # of the decision core alone must not pay that import (PEP 562).
    if name in ("KubeCluster", "KubeConfig"):
        from . import kube

        return getattr(kube, name)
    raise AttributeError(name)
