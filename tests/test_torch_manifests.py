"""Parity of the port's CRD manifest loader (``cli/manifests.py``) with
the JAX package's.

The cases of ``tests/unit/test_manifests.py``: the same YAML documents go
through both packages' ``parse_manifest`` / ``apply_manifests``, the
parsed objects are equal field for field, both reject the same documents
with the same message, and the manifests schedule end to end through
each package's ``Scheduler`` onto the same node.
"""

import dataclasses
import importlib
import json
import threading
import time

import pytest
import yaml

from kube_batch_tpu.api import GROUP_NAME_ANNOTATION_KEY

PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")

MANIFESTS = f"""
apiVersion: scheduling.incubator.k8s.io/v1alpha1
kind: Queue
metadata:
  name: default
spec:
  weight: 4
---
apiVersion: scheduling.incubator.k8s.io/v1alpha2
kind: PodGroup
metadata:
  name: qj-1
  namespace: default
spec:
  minMember: 2
  queue: default
---
apiVersion: v1
kind: Node
metadata:
  name: node-a
  labels: {{zone: a}}
status:
  allocatable: {{cpu: "4", memory: 8Gi, pods: "20"}}
  capacity: {{cpu: "4", memory: 8Gi, pods: "20"}}
---
apiVersion: v1
kind: Pod
metadata:
  name: qj-1-0
  namespace: default
  annotations:
    {GROUP_NAME_ANNOTATION_KEY}: qj-1
spec:
  containers:
  - name: main
    resources:
      requests: {{cpu: 500m, memory: 256Mi}}
---
apiVersion: v1
kind: Pod
metadata:
  name: qj-1-1
  namespace: default
  annotations:
    {GROUP_NAME_ANNOTATION_KEY}: qj-1
spec:
  tolerations:
  - key: dedicated
    operator: Equal
    value: ml
    effect: NoSchedule
  containers:
  - name: main
    resources:
      requests: {{cpu: 500m, memory: 256Mi}}
"""

AFFINITY_POD = """
apiVersion: v1
kind: Pod
metadata:
  name: aff-pod
  namespace: default
spec:
  affinity:
    nodeAffinity:
      requiredDuringSchedulingIgnoredDuringExecution:
        nodeSelectorTerms:
        - matchExpressions:
          - {key: zone, operator: In, values: [a]}
        - matchExpressions:
          - {key: zone, operator: In, values: [b]}
  containers:
  - name: main
    resources:
      requests: {cpu: 100m}
"""

POD_AFFINITY_POD = """
apiVersion: v1
kind: Pod
metadata:
  name: anti-pod
  namespace: default
spec:
  affinity:
    podAntiAffinity:
      requiredDuringSchedulingIgnoredDuringExecution:
      - topologyKey: kubernetes.io/hostname
        labelSelector:
          matchLabels: {app: web}
          matchExpressions:
          - {key: tier, operator: In, values: [frontend]}
  containers:
  - name: main
    resources:
      requests: {cpu: 100m}
"""


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def plain(obj):
    """A package-neutral rendering of a parsed object: its dataclass
    fields as canonical JSON (enums and other leaves by ``str``),
    without the wall-clock creation stamp."""
    if dataclasses.is_dataclass(obj):
        obj = dataclasses.asdict(obj)
        obj.get("metadata", {}).pop("creation_timestamp", None)
    return json.dumps(obj, sort_keys=True, default=str)


def parse_both(doc):
    out = [mod(p, "cli.manifests").parse_manifest(doc) for p in PKGS]
    assert out[0][0] == out[1][0]
    assert plain(out[0][1]) == plain(out[1][1])
    return out[1]


def rejection(doc):
    """Both packages reject ``doc`` with the same ValueError text."""
    msgs = []
    for p in PKGS:
        with pytest.raises(ValueError) as err:
            mod(p, "cli.manifests").parse_manifest(doc)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


def test_both_crd_versions_parse():
    docs = list(yaml.safe_load_all(MANIFESTS))
    kinds = [parse_both(d)[0] for d in docs]
    assert kinds == ["Queue", "PodGroup", "Node", "Pod", "Pod"]
    assert parse_both(docs[0])[1].spec.weight == 4
    assert parse_both(docs[1])[1].spec.min_member == 2
    pod = parse_both(docs[4])[1]
    assert pod.spec.tolerations[0].value == "ml"
    assert pod.metadata.annotations[GROUP_NAME_ANNOTATION_KEY] == "qj-1"


def test_unsupported_version_rejected():
    msg = rejection({
        "apiVersion": "scheduling.incubator.k8s.io/v1beta1",
        "kind": "PodGroup",
    })
    assert "unsupported" in msg


def _schedule(pkg):
    cluster = mod(pkg, "cluster").InProcessCluster(simulate_kubelet=True)
    n = mod(pkg, "cli.manifests").apply_manifests(
        cluster, yaml.safe_load_all(MANIFESTS)
    )
    cache = mod(pkg, "cache").SchedulerCache(cluster=cluster)
    kw = {"device": "cpu"} if pkg.endswith("torch") else {}
    sched = mod(pkg, "scheduler").Scheduler(cache, schedule_period=0.05, **kw)
    running = mod(pkg, "api").PodPhase.RUNNING
    stop = threading.Event()
    t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    t.start()
    deadline = time.time() + 20
    while time.time() < deadline:
        if all(p.status.phase == running
               for p in cluster.list_objects("Pod")):
            break
        time.sleep(0.05)
    stop.set()
    t.join(timeout=5)
    return n, sorted(
        (p.metadata.name, p.status.phase, p.spec.node_name)
        for p in cluster.list_objects("Pod")
    )


def test_manifests_schedule_end_to_end():
    ref, got = (_schedule(p) for p in PKGS)
    assert got == ref
    n, pods = got
    assert n == 5
    assert pods == [("qj-1-0", "Running", "node-a"),
                    ("qj-1-1", "Running", "node-a")]


def test_node_affinity_terms_or_semantics():
    """k8s ORs across nodeSelectorTerms: zone-a OR zone-b matches a
    zone-b node; the flat shorthand is one conjunction term."""
    _, pod = parse_both(yaml.safe_load(AFFINITY_POD))
    terms = pod.spec.affinity.node_required
    assert len(terms) == 2 and isinstance(terms[0], list)
    flat = [{"key": "zone", "operator": "In", "values": ["a"]}]
    cases = [(terms, {"zone": z}) for z in "abc"] + [
        (flat, {"zone": z}) for z in "ab"]
    for pkg in PKGS:
        match = mod(pkg, "plugins.util").match_node_selector_terms
        assert [match(t, labels) for t, labels in cases] == [
            True, True, False, True, False]


def test_node_affinity_match_fields_rejected():
    doc = yaml.safe_load(AFFINITY_POD)
    terms = doc["spec"]["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"
    ]["nodeSelectorTerms"]
    terms[0]["matchFields"] = [
        {"key": "metadata.name", "operator": "In", "values": ["n1"]}
    ]
    assert "matchFields" in rejection(doc)


def test_pod_affinity_match_expressions_parsed():
    _, pod = parse_both(yaml.safe_load(POD_AFFINITY_POD))
    term = pod.spec.affinity.pod_anti_affinity[0]
    assert term["match_expressions"][0]["key"] == "tier"
    labels = [{"app": "web", "tier": "frontend"},
              {"app": "web", "tier": "backend"}, {"tier": "frontend"}]
    for pkg in PKGS:
        match = mod(pkg, "plugins.util").match_affinity_term
        assert [match(term, lab) for lab in labels] == [True, False, False]


def test_pod_affinity_unsupported_topology_rejected():
    doc = yaml.safe_load(POD_AFFINITY_POD)
    doc["spec"]["affinity"]["podAntiAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"
    ][0]["topologyKey"] = "topology.kubernetes.io/zone"
    assert "topologyKey" in rejection(doc)


def test_pod_affinity_unknown_selector_field_rejected():
    doc = yaml.safe_load(POD_AFFINITY_POD)
    doc["spec"]["affinity"]["podAntiAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"
    ][0]["labelSelector"]["matchFoo"] = {}
    assert "matchFoo" in rejection(doc)
