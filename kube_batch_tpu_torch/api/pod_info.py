"""Pod → resource-request extraction.

Mirrors reference pkg/scheduler/api/pod_info.go:
- GetPodResourceRequest (:56): sum of container requests, then per-dimension
  max with each init container (init containers run serially, so a pod needs
  max(init) vs sum(main)).
- GetPodResourceWithoutInitContainers (:69): sum of container requests only.
"""

from __future__ import annotations

from .objects import Pod
from .resource_info import Resource


def get_pod_resource_request(pod: Pod) -> Resource:
    """Running + launch requirement (reference pod_info.go:56-66)."""
    result = get_pod_resource_without_init_containers(pod)
    for c in pod.spec.init_containers:
        result.set_max_resource(Resource.from_resource_list(c.requests))
    return result


def get_pod_resource_without_init_containers(pod: Pod) -> Resource:
    """Sum of main-container requests (reference pod_info.go:69-77)."""
    result = Resource.empty()
    for c in pod.spec.containers:
        result.add(Resource.from_resource_list(c.requests))
    return result
