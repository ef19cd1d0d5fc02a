"""Shadow PodGroups for plain pods scheduled without a group.

Mirrors reference pkg/scheduler/cache/util.go (:28 shadowPodGroup,
:40 createShadowPodGroup: minMember=1, job key = controller UID if owned,
else pod UID).
"""

from __future__ import annotations

from typing import Optional

from ..api import (
    ObjectMeta,
    Pod,
    PodGroup,
    PodGroupSpec,
    get_controller_uid,
)

SHADOW_POD_GROUP_ANNOTATION = "kube-batch/shadow-pod-group"


def shadow_pod_group(pg: Optional[PodGroup]) -> bool:
    """reference util.go:28-36"""
    if pg is None:
        return True
    return SHADOW_POD_GROUP_ANNOTATION in pg.metadata.annotations


def create_shadow_pod_group(pod: Pod) -> PodGroup:
    """reference util.go:40-56"""
    job_id = get_controller_uid(pod) or pod.uid
    return PodGroup(
        metadata=ObjectMeta(
            name=job_id,
            namespace=pod.namespace,
            annotations={SHADOW_POD_GROUP_ANNOTATION: "true"},
            creation_timestamp=pod.metadata.creation_timestamp,
        ),
        spec=PodGroupSpec(min_member=1),
    )


def job_terminated(job) -> bool:
    """A job is terminated when its scheduling spec is gone — pod group
    absent (or shadow) and no legacy PDB attached — and no tasks remain
    (reference api/helpers.go:101-106, cache.go:556-585)."""
    return (
        shadow_pod_group(job.pod_group)
        and getattr(job, "pdb", None) is None
        and len(job.tasks) == 0
    )
