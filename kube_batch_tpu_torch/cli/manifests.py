"""k8s-manifest compatibility: load kube-batch CRD YAML directly.

A kube-batch user's existing manifests — PodGroup and Queue under API
group ``scheduling.incubator.k8s.io`` in either ``v1alpha1`` or
``v1alpha2`` (the reference ships both versions with identical schemas,
pkg/apis/scheduling/{v1alpha1,v1alpha2}/types.go; see config/crds/*.yaml
and example/job.yaml), plus core ``v1`` Pod/Node/PriorityClass — load
straight into the in-process cluster. This is the user-facing API surface
of the reference (SURVEY.md §2 row 25); the generated clientset/informers
(row 26) have no standalone analog beyond the ClusterAPI watch contract.

Multi-document YAML is supported; unknown kinds raise.

A copy of the JAX package's ``cli/manifests.py``; PyYAML is imported only
by the file loader.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from ..api import GROUP_NAME_ANNOTATION_KEY, PodPhase, PriorityClass
from ..api.objects import (
    SCHEDULING_GROUP,  # re-exported: the loader's public group constant
    Affinity,
    Container,
    Node,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    PodGroupSpec,
    PodSpec,
    Queue,
    QueueSpec,
    Taint,
    Toleration,
)
from ..cluster import InProcessCluster

SUPPORTED_VERSIONS = ("v1alpha1", "v1alpha2")


def _meta(doc: dict) -> ObjectMeta:
    m = doc.get("metadata", {}) or {}
    owner_uid = None
    for ref in m.get("ownerReferences", []) or []:
        if ref.get("controller"):
            owner_uid = ref.get("uid") or ref.get("name")
            break
    return ObjectMeta(
        name=m.get("name", ""),
        namespace=m.get("namespace", ""),
        uid=m.get("uid", "") or f"{m.get('namespace', '')}-{m.get('name', '')}",
        labels=dict(m.get("labels", {}) or {}),
        annotations=dict(m.get("annotations", {}) or {}),
        owner_uid=owner_uid,
    )


def _resource_list(d) -> dict:
    return {str(k): str(v) for k, v in (d or {}).items()}


def _pod_group(doc: dict) -> PodGroup:
    spec = doc.get("spec", {}) or {}
    return PodGroup(
        metadata=_meta(doc),
        spec=PodGroupSpec(
            min_member=int(spec.get("minMember", 1)),
            queue=spec.get("queue", ""),
            priority_class_name=spec.get("priorityClassName", ""),
        ),
    )


def _queue(doc: dict) -> Queue:
    spec = doc.get("spec", {}) or {}
    capability = spec.get("capability")
    return Queue(
        metadata=_meta(doc),
        spec=QueueSpec(
            weight=int(spec.get("weight", 1)),
            capability=_resource_list(capability) if capability else None,
        ),
    )


def _toleration(t: dict) -> Toleration:
    return Toleration(
        key=t.get("key", ""),
        operator=t.get("operator", "Equal"),
        value=str(t.get("value", "")),
        effect=t.get("effect", ""),
    )


def _match_expressions(exprs) -> List[dict]:
    """k8s matchExpressions -> the internal expression-dict form (shared
    by node affinity terms, preferences, and pod-affinity selectors)."""
    return [
        {
            "key": e.get("key"),
            "operator": e.get("operator", "In"),
            "values": list(e.get("values") or []),
        }
        for e in exprs or []
    ]


def _affinity(a: dict) -> Affinity:
    node_req = None
    node_pref = None
    node_aff = (a or {}).get("nodeAffinity") or {}
    required = node_aff.get(
        "requiredDuringSchedulingIgnoredDuringExecution"
    ) or {}
    terms = required.get("nodeSelectorTerms") or []
    if terms:
        # Term structure is preserved: k8s ORs across nodeSelectorTerms and
        # ANDs within a term's matchExpressions (vendored reference
        # predicates nodeMatchesNodeSelectorTerms: "if one of the terms is
        # satisfied"). Flattening would turn zone-a OR zone-b into an
        # unsatisfiable conjunction.
        node_req = []
        for t in terms:
            if t.get("matchFields"):
                raise ValueError(
                    "nodeSelectorTerms.matchFields is not supported; "
                    "use matchExpressions"
                )
            node_req.append(
                _match_expressions(t.get("matchExpressions"))
            )
    preferred = node_aff.get(
        "preferredDuringSchedulingIgnoredDuringExecution"
    ) or []
    if preferred:
        node_pref = [
            {
                "weight": p.get("weight", 1),
                "expressions": _match_expressions(
                    (p.get("preference", {}) or {}).get("matchExpressions")
                ),
            }
            for p in preferred
        ]

    def _pod_terms(section: str):
        sec = (a or {}).get(section) or {}
        req = sec.get("requiredDuringSchedulingIgnoredDuringExecution") or []
        out = []
        for term in req:
            topo = term.get("topologyKey", "kubernetes.io/hostname")
            if topo != "kubernetes.io/hostname":
                # The in-process evaluator's topology domain is the node
                # (reference predicates.go:252-262 with node-level
                # NodeInfo); a zone/rack key would silently change which
                # pods count as co-located.
                raise ValueError(
                    f"unsupported {section} topologyKey {topo!r} "
                    "(only kubernetes.io/hostname)"
                )
            sel = term.get("labelSelector", {}) or {}
            unknown = set(sel) - {"matchLabels", "matchExpressions"}
            if unknown:
                raise ValueError(
                    f"unsupported {section} labelSelector fields {sorted(unknown)}"
                )
            parsed = {
                "label_selector": dict(sel.get("matchLabels", {}) or {})
            }
            exprs = sel.get("matchExpressions") or []
            if exprs:
                parsed["match_expressions"] = _match_expressions(exprs)
            out.append(parsed)
        return out or None

    return Affinity(
        node_required=node_req,
        node_preferred=node_pref,
        pod_affinity=_pod_terms("podAffinity"),
        pod_anti_affinity=_pod_terms("podAntiAffinity"),
    )


def _pod(doc: dict) -> Pod:
    spec = doc.get("spec", {}) or {}
    status = doc.get("status", {}) or {}
    containers = []
    ports: List[int] = []
    for c in spec.get("containers", []) or []:
        requests = (
            (c.get("resources", {}) or {}).get("requests", {}) or {}
        )
        cports = [
            int(p.get("hostPort"))
            for p in c.get("ports", []) or []
            if p.get("hostPort")
        ]
        containers.append(Container(
            name=c.get("name", "main"),
            requests=_resource_list(requests),
            ports=cports,
        ))
        ports.extend(cports)
    affinity = spec.get("affinity")
    claims = [
        v["persistentVolumeClaim"]["claimName"]
        for v in spec.get("volumes", []) or []
        if v.get("persistentVolumeClaim", {}).get("claimName")
    ]
    pod = Pod(
        metadata=_meta(doc),
        spec=PodSpec(
            node_name=spec.get("nodeName", ""),
            node_selector=dict(spec.get("nodeSelector", {}) or {}),
            affinity=_affinity(affinity) if affinity else None,
            tolerations=[
                _toleration(t) for t in spec.get("tolerations", []) or []
            ],
            containers=containers or [Container()],
            priority=spec.get("priority"),
            scheduler_name=spec.get(
                "schedulerName", PodSpec().scheduler_name
            ),
            volume_claims=claims,
        ),
    )
    pod.status.phase = status.get("phase", PodPhase.PENDING)
    return pod


def _node(doc: dict) -> Node:
    status = doc.get("status", {}) or {}
    spec = doc.get("spec", {}) or {}
    allocatable = _resource_list(
        status.get("allocatable") or status.get("capacity")
    )
    capacity = _resource_list(status.get("capacity") or allocatable)
    node = Node(
        metadata=_meta(doc),
        status=NodeStatus(allocatable=allocatable, capacity=capacity),
    )
    node.spec.unschedulable = bool(spec.get("unschedulable", False))
    node.spec.taints = [
        Taint(
            key=t.get("key", ""),
            value=str(t.get("value", "")),
            effect=t.get("effect", ""),
        )
        for t in spec.get("taints", []) or []
    ]
    return node


def _pdb(doc: dict) -> Optional[PodDisruptionBudget]:
    """A PDB acts as a legacy gang source ONLY when it has a controller
    owner and an absolute minAvailable (reference event_handlers.go:662-700
    keys the job by the controller UID). Ordinary disruption budgets —
    label-selector based, ownerless, or percentage minAvailable — are not
    gang specs; they load as a no-op instead of failing the manifest."""
    meta = _meta(doc)
    spec = doc.get("spec", {}) or {}
    min_available = spec.get("minAvailable", 1)
    if not meta.owner_uid:
        return None
    if isinstance(min_available, str):
        if min_available.endswith("%"):
            return None
        min_available = int(min_available)
    return PodDisruptionBudget(metadata=meta, min_available=int(min_available))


def _priority_class(doc: dict) -> PriorityClass:
    return PriorityClass(
        metadata=_meta(doc),
        value=int(doc.get("value", 0)),
        global_default=bool(doc.get("globalDefault", False)),
    )


def parse_manifest(doc: dict) -> Tuple[str, object]:
    """(cluster kind, object) from one k8s manifest document."""
    api_version = doc.get("apiVersion", "")
    kind = doc.get("kind", "")
    if "/" in api_version:
        group, version = api_version.split("/", 1)
    else:
        group, version = "", api_version
    if group == SCHEDULING_GROUP:
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported {SCHEDULING_GROUP} version {version!r} "
                f"(supported: {SUPPORTED_VERSIONS})"
            )
        if kind == "PodGroup":
            return "PodGroup", _pod_group(doc)
        if kind == "Queue":
            return "Queue", _queue(doc)
        raise ValueError(f"unknown kind {kind!r} in group {group}")
    if group in ("", "v1") or api_version == "v1":
        if kind == "Pod":
            return "Pod", _pod(doc)
        if kind == "Node":
            return "Node", _node(doc)
        if kind == "PriorityClass":
            return "PriorityClass", _priority_class(doc)
        if kind == "PersistentVolumeClaim":
            meta = doc.get("metadata", {}) or {}
            phase = (doc.get("status", {}) or {}).get("phase", "")
            return "PersistentVolumeClaim", {
                "namespace": meta.get("namespace", ""),
                "name": meta.get("name", ""),
                "bound": phase == "Bound",
            }
    if group == "scheduling.k8s.io" and kind == "PriorityClass":
        return "PriorityClass", _priority_class(doc)
    if group == "policy" and kind == "PodDisruptionBudget":
        pdb = _pdb(doc)
        # (None, None) = recognized but not applicable (no controller
        # owner / percentage budget): not a gang source, skip quietly.
        return ("PodDisruptionBudget", pdb) if pdb else (None, None)
    raise ValueError(f"unsupported manifest {api_version!r} kind {kind!r}")


def apply_manifests(cluster: InProcessCluster, docs: Iterable[dict]) -> int:
    """Create every manifest object in the cluster; returns the count of
    applied objects (recognized-but-skipped documents are not counted)."""
    n = 0
    for doc in docs:
        if not doc:
            continue
        kind, obj = parse_manifest(doc)
        if kind is None:
            continue
        if kind == "PersistentVolumeClaim":
            cluster.create_claim(
                obj["namespace"], obj["name"], bound=obj["bound"]
            )
        else:
            cluster.create(kind, obj)
        n += 1
    return n


def load_manifest_file(cluster: InProcessCluster, path: str) -> int:
    import yaml

    with open(path) as f:
        return apply_manifests(cluster, yaml.safe_load_all(f))


# Convenience: the group-name annotation a Pod uses to join a PodGroup
# (reference labels.go:21, read by job_info).
__all__ = [
    "GROUP_NAME_ANNOTATION_KEY",
    "SCHEDULING_GROUP",
    "apply_manifests",
    "load_manifest_file",
    "parse_manifest",
]
