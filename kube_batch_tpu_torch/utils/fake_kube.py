"""In-memory fake Kubernetes API server.

A stdlib HTTP server speaking just enough of the k8s REST protocol —
JSON lists, streaming ?watch=true, the Binding subresource, Lease CRUD
with optimistic concurrency, status PATCHes — to drive the whole
scheduler end-to-end through the real KubeCluster adapter. This is the
repo's kubemark analog (SURVEY.md §4 tier 4: simulated kubelets, real
scheduler): the Binding subresource flips pods to Running like a hollow
kubelet. Used by the port's tests and by ``chip_smoke.py``; nothing on
the scheduler's path imports it.

A copy of the JAX package's ``utils/fake_kube.py``.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..api.objects import SCHEDULING_GROUP as GROUP


def pod_doc(name, ns="default", cpu="500m", group=None, phase="Pending"):
    meta = {"name": name, "namespace": ns, "uid": f"uid-{ns}-{name}"}
    if group:
        meta["annotations"] = {"scheduling.k8s.io/group-name": group}
    return {
        "apiVersion": "v1", "kind": "Pod", "metadata": meta,
        "spec": {"containers": [
            {"name": "main", "resources": {"requests": {
                "cpu": cpu, "memory": "256Mi",
            }}},
        ]},
        "status": {"phase": phase},
    }


def node_doc(name, cpu="4", pods="20"):
    return {
        "apiVersion": "v1", "kind": "Node",
        "metadata": {"name": name, "uid": f"uid-{name}"},
        "status": {
            "allocatable": {"cpu": cpu, "memory": "8Gi", "pods": pods},
            "capacity": {"cpu": cpu, "memory": "8Gi", "pods": pods},
        },
    }


class FakeKube:
    """In-memory k8s API server: lists, watches, binding, status patches."""

    PATHS = {
        "/api/v1/pods": "Pod",
        "/api/v1/nodes": "Node",
        f"/apis/{GROUP}/v1alpha1/podgroups": "PodGroup",
        f"/apis/{GROUP}/v1alpha1/queues": "Queue",
        "/apis/scheduling.k8s.io/v1/priorityclasses": "PriorityClass",
        "/apis/policy/v1/poddisruptionbudgets": "PodDisruptionBudget",
        "/api/v1/persistentvolumeclaims": "PersistentVolumeClaim",
    }

    # namespaced item-GET collection segment -> kind
    COLLECTIONS = {
        "pods": "Pod",
        "persistentvolumeclaims": "PersistentVolumeClaim",
    }

    def __init__(self):
        self.objects = {kind: {} for kind in self.PATHS.values()}
        self.subscribers = {kind: [] for kind in self.PATHS.values()}
        self.bindings = []
        self.status_patches = []
        self.leases = {}
        self.lock = threading.RLock()
        self.rv = 0
        self.last_auth = None      # Authorization header of last request
        self.reject_token = None   # bearer token to 401 (auth tests)
        # Failure injection (error-path fixtures): callable
        # (method, path) -> None | (code, status_doc). Return a k8s
        # Status document shaped like a real apiserver error to have the
        # request answered with it instead of being served.
        self.request_hook = None
        # Bind-failure injection (the sim/fault-run seam, narrower than
        # request_hook): callable (pod_key, hostname) -> None |
        # (code, status_doc). A non-None return answers the Binding POST
        # with that error WITHOUT mutating the pod — the scheduler's
        # resync path must recover. Decisions should be pure functions
        # of (pod, attempt) so a recorded run replays bit-identically.
        self.bind_failure_hook = None

        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"  # close-delimited watch streams

            def log_message(self, *a):
                pass

            def _json(self, code, body):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _read_body(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n)) if n else {}

            def _auth_gate(self):
                fake.last_auth = self.headers.get("Authorization")
                if (
                    fake.reject_token is not None
                    and fake.last_auth == f"Bearer {fake.reject_token}"
                ):
                    self._json(401, {"kind": "Status", "code": 401})
                    return False
                hook = fake.request_hook
                if hook is not None:
                    injected = hook(self.command, self.path)
                    if injected is not None:
                        code, body = injected
                        self._json(code, body)
                        return False
                return True

            def do_GET(self):
                if not self._auth_gate():
                    return
                path, _, qs = self.path.partition("?")
                kind = fake.PATHS.get(path)
                if kind is None:
                    if "/leases/" in path:
                        with fake.lock:
                            lease = fake.leases.get(path)
                        if lease is None:
                            self._json(404, {"kind": "Status", "code": 404})
                        else:
                            self._json(200, lease)
                        return
                    # Item GET: /api/v1/namespaces/{ns}/{collection}/{name}
                    if "/namespaces/" in path:
                        parts = path.split("/")
                        ns, coll, name = parts[4], parts[5], parts[6]
                        obj_kind = fake.COLLECTIONS.get(coll, "Pod")
                        with fake.lock:
                            obj = fake.objects[obj_kind].get(f"{ns}/{name}")
                        if obj is None:
                            self._json(404, {"kind": "Status", "code": 404})
                        else:
                            self._json(200, obj)
                        return
                    self._json(404, {"kind": "Status", "code": 404})
                    return
                if "watch=true" in qs:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    q = queue.Queue()
                    with fake.lock:
                        fake.subscribers[kind].append(q)
                    try:
                        while True:
                            try:
                                event = q.get(timeout=0.2)
                            except queue.Empty:
                                continue
                            if event is None:
                                return
                            self.wfile.write(
                                (json.dumps(event) + "\n").encode()
                            )
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return
                with fake.lock:
                    # Sorted by key, NOT insertion order: list responses
                    # must not depend on the interleaving of concurrent
                    # creates, or a recorded scheduler run (whose cache
                    # ingest order follows the initial list) would not
                    # replay bit-identically against the same state.
                    items = [
                        fake.objects[kind][k]
                        for k in sorted(fake.objects[kind])
                    ]
                    rv = str(fake.rv)
                if path.startswith("/api/v1"):
                    api_version = "v1"
                else:
                    parts = path.split("/")
                    api_version = f"{parts[2]}/{parts[3]}"
                self._json(200, {
                    "apiVersion": api_version, "kind": f"{kind}List",
                    "metadata": {"resourceVersion": rv},
                    "items": items,
                })

            def do_POST(self):
                if not self._auth_gate():
                    return
                if self.path.endswith("/leases"):
                    body = self._read_body()
                    name = body["metadata"]["name"]
                    key = f"{self.path}/{name}"
                    with fake.lock:
                        if key in fake.leases:
                            self._json(409, {"kind": "Status", "code": 409})
                            return
                        fake.rv += 1
                        body["metadata"]["resourceVersion"] = str(fake.rv)
                        fake.leases[key] = body
                    self._json(201, body)
                    return
                if self.path.endswith("/binding"):
                    body = self._read_body()
                    parts = self.path.split("/")
                    ns, name = parts[4], parts[6]
                    hostname = body.get("target", {}).get("name", "")
                    hook = fake.bind_failure_hook
                    if hook is not None:
                        injected = hook(f"{ns}/{name}", hostname)
                        if injected is not None:
                            code, doc = injected
                            self._json(code, doc)
                            return
                    with fake.lock:
                        pod = fake.objects["Pod"].get(f"{ns}/{name}")
                        if pod is None:
                            self._json(404, {"code": 404})
                            return
                        pod["spec"]["nodeName"] = hostname
                        pod["status"]["phase"] = "Running"  # hollow kubelet
                        fake.bindings.append((f"{ns}/{name}", hostname))
                        fake._emit("Pod", "MODIFIED", pod)
                    self._json(201, {"kind": "Status", "status": "Success"})
                    return
                if "/events" in self.path:
                    self._json(201, {"kind": "Status", "status": "Success"})
                    return
                self._json(404, {"code": 404})

            def do_PATCH(self):
                if not self._auth_gate():
                    return
                body = self._read_body()
                with fake.lock:
                    fake.status_patches.append((self.path, body))
                self._json(200, {"kind": "Status", "status": "Success"})

            def do_PUT(self):
                if not self._auth_gate():
                    return
                if "/leases/" not in self.path:
                    self._json(404, {"code": 404})
                    return
                body = self._read_body()
                with fake.lock:
                    stored = fake.leases.get(self.path)
                    if stored is None:
                        self._json(404, {"code": 404})
                        return
                    # Optimistic concurrency: resourceVersion must match.
                    if (
                        body.get("metadata", {}).get("resourceVersion")
                        != stored["metadata"]["resourceVersion"]
                    ):
                        self._json(409, {"kind": "Status", "code": 409})
                        return
                    fake.rv += 1
                    body["metadata"]["resourceVersion"] = str(fake.rv)
                    fake.leases[self.path] = body
                self._json(200, body)

            def do_DELETE(self):
                if not self._auth_gate():
                    return
                parts = self.path.split("/")
                ns, name = parts[4], parts[6]
                with fake.lock:
                    pod = fake.objects["Pod"].pop(f"{ns}/{name}", None)
                    if pod is not None:
                        fake._emit("Pod", "DELETED", pod)
                self._json(200, {"kind": "Status", "status": "Success"})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()

    @property
    def url(self):
        host, port = self.server.server_address
        return f"http://{host}:{port}"

    def _key(self, doc):
        m = doc["metadata"]
        ns = m.get("namespace", "")
        return f"{ns}/{m['name']}" if ns else m["name"]

    def _emit(self, kind, etype, doc):
        self.rv += 1
        doc.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        for q in self.subscribers[kind]:
            q.put({"type": etype, "object": doc})

    def create(self, kind, doc):
        with self.lock:
            self.objects[kind][self._key(doc)] = doc
            self._emit(kind, "ADDED", doc)

    def remove_silently(self, kind, key):
        """Delete an object WITHOUT emitting a watch event — simulates a
        deletion the client's watch missed (e.g. during a 410 gap)."""
        with self.lock:
            self.objects[kind].pop(key, None)

    def emit_error(self, kind, code, reason="Expired"):
        """Send a watch ERROR event shaped like a real apiserver's (a
        Status document as the object), e.g. 410 Gone after resource-
        version expiry."""
        with self.lock:
            for q in self.subscribers[kind]:
                q.put({
                    "type": "ERROR",
                    "object": {
                        "kind": "Status", "apiVersion": "v1",
                        "status": "Failure", "reason": reason,
                        "code": code,
                        "message": f"too old resource version ({reason})",
                    },
                })

    def kick_watchers(self, kind):
        """Close every open watch stream for ``kind`` (server-side
        disconnect); clients are expected to reconnect from their last
        resourceVersion."""
        with self.lock:
            for q in self.subscribers[kind]:
                q.put(None)
            self.subscribers[kind] = []

    def close(self):
        with self.lock:
            for qs in self.subscribers.values():
                for q in qs:
                    q.put(None)
        self.server.shutdown()


def pvc_doc(name, ns="default", phase="Pending"):
    return {
        "apiVersion": "v1", "kind": "PersistentVolumeClaim",
        "metadata": {"name": name, "namespace": ns,
                     "uid": f"uid-pvc-{ns}-{name}"},
        "spec": {},
        "status": {"phase": phase},
    }


def pod_with_claim_doc(name, claim, ns="default"):
    doc = pod_doc(name, ns=ns, group=None)
    doc["spec"]["volumes"] = [
        {"name": claim, "persistentVolumeClaim": {"claimName": claim}},
    ]
    return doc
