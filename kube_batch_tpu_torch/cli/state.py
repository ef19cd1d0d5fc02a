"""Cluster-state YAML loader.

The standalone analog of pointing kube-batch at an API server: a YAML
document describing queues, nodes, pod groups, and pods is loaded into the
in-process cluster substrate (reference: config/queue/default.yaml +
example/job.yaml objects, applied by hack/run-e2e-kind.sh:70-79).

Schema (all sections optional)::

    queues:
    - name: default
      weight: 1
      capability: {cpu: "10", memory: 10Gi}    # optional
    nodes:
    - name: n1
      allocatable: {cpu: "32", memory: 128Gi, pods: "110"}
      labels: {zone: us-central2-b}
    podGroups:
    - name: pg1
      namespace: default
      minMember: 3
      queue: default
      priorityClassName: high                  # optional
    pods:
    - name: p1
      namespace: default
      group: pg1                               # via the group annotation
      requests: {cpu: 1000m, memory: 1Gi}
      nodeName: ""                             # pre-bound if set
      phase: Pending
      priority: 10                             # optional
      schedulerName: tpu-batch                 # optional; must match --scheduler-name
    priorityClasses:
    - name: high
      value: 1000

A copy of the JAX package's ``cli/state.py``; PyYAML is imported only by
the file loader.
"""

from __future__ import annotations

from ..api import PodPhase, PriorityClass, build_resource_list
from ..api.objects import ObjectMeta
from ..cluster import InProcessCluster
from ..utils.test_utils import build_node, build_pod, build_pod_group, build_queue


def _resource_list(d):
    d = dict(d or {})
    cpu = d.pop("cpu", None)
    memory = d.pop("memory", None)
    pods = d.pop("pods", None)
    rl = build_resource_list(
        cpu=cpu, memory=memory,
        pods=int(pods) if pods is not None else None,
    )
    rl.update({k: str(v) for k, v in d.items()})  # scalar resources verbatim
    return rl


def load_cluster_state(path: str, simulate_kubelet: bool = True) -> InProcessCluster:
    """Load either the compact schema above or standard k8s manifests.

    Documents carrying ``apiVersion`` are treated as kube-batch CRD /
    core-v1 manifests (cli/manifests.py) — a reference user's existing
    YAML (example/job.yaml, config/queue/default.yaml) loads unchanged."""
    import yaml

    with open(path) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    if docs and any("apiVersion" in d for d in docs):
        from .manifests import apply_manifests

        cluster = InProcessCluster(simulate_kubelet=simulate_kubelet)
        apply_manifests(cluster, docs)
        return cluster
    data = docs[0] if docs else {}
    return build_cluster_from_dict(data, simulate_kubelet=simulate_kubelet)


def build_cluster_from_dict(data: dict, simulate_kubelet: bool = True) -> InProcessCluster:
    cluster = InProcessCluster(simulate_kubelet=simulate_kubelet)
    for q in data.get("queues", []) or []:
        queue = build_queue(
            q["name"], weight=int(q.get("weight", 1)),
            capability=_resource_list(q["capability"]) if q.get("capability") else None,
        )
        cluster.create_queue(queue)
    for pc in data.get("priorityClasses", []) or []:
        cluster.create_priority_class(PriorityClass(
            metadata=ObjectMeta(name=pc["name"]),
            value=int(pc.get("value", 0)),
            global_default=bool(pc.get("globalDefault", False)),
        ))
    for n in data.get("nodes", []) or []:
        cluster.create_node(build_node(
            n["name"], _resource_list(n.get("allocatable")),
            labels=n.get("labels"),
        ))
    for pg in data.get("podGroups", []) or []:
        cluster.create_pod_group(build_pod_group(
            pg["name"], namespace=pg.get("namespace", "default"),
            min_member=int(pg.get("minMember", 1)),
            queue=pg.get("queue", ""),
            priority_class_name=pg.get("priorityClassName", ""),
        ))
    for p in data.get("pods", []) or []:
        pod = build_pod(
            p.get("namespace", "default"), p["name"],
            p.get("nodeName", ""),
            p.get("phase", PodPhase.PENDING),
            _resource_list(p.get("requests")),
            group_name=p.get("group", ""),
            labels=p.get("labels"),
            selector=p.get("nodeSelector"),
            priority=p.get("priority"),
        )
        if "schedulerName" in p:
            pod.spec.scheduler_name = p["schedulerName"]
        cluster.create_pod(pod)
    return cluster
