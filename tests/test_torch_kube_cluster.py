"""Parity of the port's real-cluster adapter (``cluster/kube.py``) and its
fake API server (``utils/fake_kube.py``) with the JAX package's.

The 29 cases of ``tests/unit/test_kube_cluster.py`` run once per package
(parametrised over ``pkg``): each package's ``KubeCluster`` against its
own ``FakeKube`` (lists, streaming watches, the Binding subresource,
status PATCHes, the Lease CAS, relist delete reconciliation, apiserver
error shapes, credential plugins, the volume seam). The port's schedulers
run on the CPU. Then the packages against each other, with no tolerance:
the same API documents listed through both adapters give equal domain
objects field by field, and the scheduler end-to-end case gives the same
``fake.bindings`` and status-patch bodies under the default policy and
under the TPU policy (the port's ``allocate_tpu`` on the plain chain,
``use_kernel=False``, which is the JAX package's default chain on the
CPU).
"""

import dataclasses
import importlib
import json
import logging
import os
import pathlib
import threading
import time
from types import SimpleNamespace
from urllib.error import HTTPError

import pytest
import yaml

PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")
GROUP = "scheduling.incubator.k8s.io"
REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_CONF = str(REPO / "config" / "tpu-batch-conf-tpu.yaml")


def package(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    m("actions")
    m("plugins")
    kube, fk, cache = m("cluster.kube"), m("utils.fake_kube"), m("cache")
    port = name.endswith("torch")

    def scheduler(c, conf=None, **kw):
        if port:
            kw["device"] = "cpu"
        return m("scheduler").Scheduler(c, conf, **kw)

    return SimpleNamespace(
        name=name, port=port, kube=kube, fk=fk,
        KubeCluster=kube.KubeCluster, KubeConfig=kube.KubeConfig,
        FakeKube=fk.FakeKube, node_doc=fk.node_doc, pod_doc=fk.pod_doc,
        pvc_doc=fk.pvc_doc, pod_with_claim_doc=fk.pod_with_claim_doc,
        SchedulerCache=cache.SchedulerCache,
        DefaultVolumeBinder=cache.DefaultVolumeBinder,
        Scheduler=scheduler, server=m("cli.server"),
        rng=m("utils.scheduler_helper")._rng,
    )


@pytest.fixture(params=PKGS)
def P(request):
    return package(request.param)


@pytest.fixture
def fake(P):
    f = P.FakeKube()
    yield f
    f.close()


def make_cluster(P, fake):
    return P.KubeCluster(P.KubeConfig(fake.url), reconnect_delay=0.05)


def queue_doc(name="default", weight=1):
    return {"apiVersion": f"{GROUP}/v1alpha1", "kind": "Queue",
            "metadata": {"name": name}, "spec": {"weight": weight}}


def group_doc(name, min_member, queue=None, ns="default"):
    spec = {"minMember": min_member}
    if queue:
        spec["queue"] = queue
    return {"apiVersion": f"{GROUP}/v1alpha1", "kind": "PodGroup",
            "metadata": {"name": name, "namespace": ns}, "spec": spec}


def _status_doc(code, reason, message):
    """A Status document shaped like a real apiserver error response."""
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "reason": reason, "message": message, "code": code}


def wait_until(cond, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def running(fake, n=2):
    """``n`` bindings made and every pod Running at the API server."""
    with fake.lock:
        pods = list(fake.objects["Pod"].values())
    return len(fake.bindings) >= n and all(
        p["status"]["phase"] == "Running" for p in pods)


def run_gang_end_to_end(P, fake, conf=None, timeout=20.0, until=running):
    """The reference's kind-e2e analog: queue, gang of 2, one node, the
    full scheduler loop through the REST protocol until ``until(fake)``
    (by default: both pods run)."""
    fake.create("Queue", queue_doc())
    fake.create("PodGroup", group_doc("g1", 2, queue="default"))
    fake.create("Node", P.node_doc("n1"))
    for i in range(2):
        fake.create("Pod", P.pod_doc(f"p{i}", group="g1"))
    cluster = make_cluster(P, fake)
    cache = P.SchedulerCache(cluster=cluster)
    sched = P.Scheduler(cache, conf, schedule_period=0.05)
    stop = threading.Event()
    t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    t.start()
    ok = wait_until(lambda: until(fake), timeout)
    stop.set()
    cluster.stop()
    t.join(timeout=5)
    return ok


class TestKubeCluster:
    def test_list_converts_domain_objects(self, P, fake):
        fake.create("Node", P.node_doc("n1"))
        fake.create("Pod", P.pod_doc("p1"))
        fake.create("Queue", queue_doc("q1", weight=3))
        cluster = make_cluster(P, fake)
        nodes = cluster.list_objects("Node")
        pods = cluster.list_objects("Pod")
        queues = cluster.list_objects("Queue")
        assert [n.metadata.name for n in nodes] == ["n1"]
        assert [p.metadata.name for p in pods] == ["p1"]
        assert queues[0].spec.weight == 3

    def test_watch_delivers_events(self, P, fake):
        cluster = make_cluster(P, fake)
        got = []
        ready = threading.Event()
        cluster.add_watch(
            lambda kind, etype, obj: (got.append((kind, etype)), ready.set())
        )
        time.sleep(0.3)  # let watch connections establish
        fake.create("Pod", P.pod_doc("p1"))
        assert ready.wait(5.0), got
        assert ("Pod", "ADDED") in got
        cluster.stop()

    def test_bind_pod_posts_binding(self, P, fake):
        fake.create("Pod", P.pod_doc("p1"))
        cluster = make_cluster(P, fake)
        pod = cluster.list_objects("Pod")[0]
        cluster.bind_pod(pod, "n1")
        assert fake.bindings == [("default/p1", "n1")]
        assert cluster.get_pod("default", "p1").spec.node_name == "n1"

    def test_update_pod_group_patches_status(self, P, fake):
        fake.create("PodGroup", group_doc("g1", 1))
        cluster = make_cluster(P, fake)
        pg = cluster.list_objects("PodGroup")[0]
        pg.status.phase = "Running"
        pg.status.running = 1
        cluster.update_pod_group(pg)
        path, body = fake.status_patches[-1]
        assert path.endswith("/podgroups/g1/status")
        assert body["status"]["phase"] == "Running"

    def test_scheduler_end_to_end_against_fake_api(self, P, fake):
        """The full scheduler drives a gang through the REST protocol —
        list, watch, gang gate, Binding subresource — and the pods come
        back Running via watch events."""
        assert run_gang_end_to_end(P, fake), fake.bindings
        assert {b[1] for b in fake.bindings} == {"n1"}


class TestLeaseElection:
    """coordination/v1 Lease lock: CAS via resourceVersion, steal on
    expiry judged by locally observed staleness."""

    def test_acquire_creates_lease(self, P, fake):
        cluster = make_cluster(P, fake)
        assert cluster.try_acquire_lease("kube-system", "tb", "me", 15.0)
        lease = list(fake.leases.values())[0]
        assert lease["spec"]["holderIdentity"] == "me"

    def test_fresh_foreign_lease_blocks(self, P, fake):
        cluster = make_cluster(P, fake)
        assert cluster.try_acquire_lease("kube-system", "tb", "a", 15.0)
        assert not cluster.try_acquire_lease("kube-system", "tb", "b", 15.0)
        # ...but the holder itself renews fine (transitions unchanged).
        assert cluster.try_acquire_lease("kube-system", "tb", "a", 15.0)
        lease = list(fake.leases.values())[0]
        assert lease["spec"]["leaseTransitions"] == 0

    def test_expired_lease_is_stolen(self, P, fake):
        cluster_a = make_cluster(P, fake)
        cluster_b = make_cluster(P, fake)
        assert cluster_a.try_acquire_lease("kube-system", "tb", "a", 0.05)
        assert not cluster_b.try_acquire_lease("kube-system", "tb", "b", 0.05)
        time.sleep(0.1)  # a never renews: record stays unchanged
        assert cluster_b.try_acquire_lease("kube-system", "tb", "b", 0.05)
        lease = list(fake.leases.values())[0]
        assert lease["spec"]["holderIdentity"] == "b"
        assert lease["spec"]["leaseTransitions"] == 1

    def test_renewing_holder_is_never_stolen_despite_skew(self, P, fake):
        cluster_a = make_cluster(P, fake)
        cluster_b = make_cluster(P, fake)
        assert cluster_a.try_acquire_lease("kube-system", "tb", "a", 0.2)
        for _ in range(4):
            assert not cluster_b.try_acquire_lease(
                "kube-system", "tb", "b", 0.2)
            time.sleep(0.1)
            assert cluster_a.try_acquire_lease(
                "kube-system", "tb", "a", 0.2)  # renew moves renewTime
        assert not cluster_b.try_acquire_lease("kube-system", "tb", "b", 0.2)

    def test_concurrent_steal_loses_cas(self, P, fake):
        cluster_a = make_cluster(P, fake)
        cluster_b = make_cluster(P, fake)
        assert cluster_a.try_acquire_lease("kube-system", "tb", "a", 0.05)
        assert not cluster_b.try_acquire_lease("kube-system", "tb", "b", 0.05)
        time.sleep(0.1)
        orig_request = cluster_b._request

        def racing_request(method, path, body=None, **kw):
            out = orig_request(method, path, body=body, **kw)
            if method == "GET" and "/leases/" in path:
                with fake.lock:  # racer steals right after our GET
                    key = next(iter(fake.leases))
                    fake.rv += 1
                    fake.leases[key]["metadata"]["resourceVersion"] = str(
                        fake.rv)
            return out

        cluster_b._request = racing_request
        assert not cluster_b.try_acquire_lease("kube-system", "tb", "b", 0.05)

    def test_kube_lease_elector_roundtrip(self, P, fake):
        cluster = make_cluster(P, fake)
        a = P.server.KubeLeaseElector(cluster, "kube-system", identity="a",
                                      lease_duration=15.0)
        b = P.server.KubeLeaseElector(cluster, "kube-system", identity="b",
                                      lease_duration=15.0)
        assert a.try_acquire()
        assert not b.try_acquire()
        assert a.try_acquire()  # renew

    def test_release_lets_successor_acquire_immediately(self, P, fake):
        cluster = make_cluster(P, fake)
        assert cluster.try_acquire_lease("kube-system", "tb", "a", 15.0)
        cluster.release_lease("kube-system", "tb", "a")
        lease = list(fake.leases.values())[0]
        assert lease["spec"]["holderIdentity"] == ""
        assert cluster.try_acquire_lease("kube-system", "tb", "b", 15.0)

    def test_release_after_transient_failure_still_clears_lease(self, P,
                                                                fake):
        cluster = make_cluster(P, fake)
        el = P.server.KubeLeaseElector(cluster, "kube-system", identity="a")
        assert el.try_acquire()
        assert el.held_at_least_once
        real = cluster.try_acquire_lease
        cluster.try_acquire_lease = lambda *a, **k: (_ for _ in ()).throw(
            OSError("api down"))
        assert not el.try_acquire()
        assert not el.is_leader
        cluster.try_acquire_lease = real
        el.release()
        lease = list(fake.leases.values())[0]
        assert lease["spec"]["holderIdentity"] == ""

    def test_foreign_timestamp_formats_cannot_cause_steal(self, P, fake):
        cluster = make_cluster(P, fake)
        assert cluster.try_acquire_lease("kube-system", "tb", "a", 5.0)
        key = next(iter(fake.leases))
        with fake.lock:
            fake.leases[key]["spec"]["renewTime"] = "garbage-timestamp"
            fake.rv += 1
            fake.leases[key]["metadata"]["resourceVersion"] = str(fake.rv)
        b = make_cluster(P, fake)
        assert not b.try_acquire_lease("kube-system", "tb", "b", 5.0)


class TestRelistDeleteReconciliation:
    """Objects deleted during a watch gap are reconciled on relist via
    synthesized DELETED events (client-go reflector Replace)."""

    def test_running_pod_deleted_during_gap_returns_capacity(self, P, fake):
        fake.create("Node", P.node_doc("n1"))
        doc = P.pod_doc("p1", phase="Running")
        doc["spec"]["nodeName"] = "n1"
        fake.create("Pod", doc)
        cluster = make_cluster(P, fake)
        cache = P.SchedulerCache(cluster=cluster)
        stop = threading.Event()
        cache.run(stop)
        assert cache.wait_for_cache_sync(stop)
        assert wait_until(lambda: (
            cache.nodes.get("n1") is not None
            and cache.nodes["n1"].used.milli_cpu == 500), 5), \
            "pod never occupied the node"
        fake.remove_silently("Pod", "default/p1")
        fake.emit_error("Pod", 410)
        assert wait_until(lambda: cache.nodes["n1"].used.milli_cpu == 0,
                          10), "phantom pod still holds capacity"
        assert not [t for j in cache.jobs.values() for t in j.tasks.values()]
        stop.set()
        cluster.stop()
        cache.shutdown()

    def test_node_deleted_during_gap_leaves_mirror(self, P, fake):
        fake.create("Node", P.node_doc("n1"))
        fake.create("Node", P.node_doc("n2"))
        cluster = make_cluster(P, fake)
        cache = P.SchedulerCache(cluster=cluster)
        stop = threading.Event()
        cache.run(stop)
        assert cache.wait_for_cache_sync(stop)
        wait_until(lambda: len(cache.nodes) == 2, 5)
        fake.remove_silently("Node", "n2")
        fake.emit_error("Node", 410)
        assert wait_until(lambda: "n2" not in cache.nodes, 10), \
            "deleted node still in mirror after relist"
        assert "n1" in cache.nodes
        stop.set()
        cluster.stop()
        cache.shutdown()


class TestApiErrorPaths:
    """Apiserver error shapes against the adapter: RBAC 403 on the watch,
    409 on a status PATCH, 403 on a bind POST, server-side watch
    disconnects."""

    def test_watch_disconnect_resumes_without_duplicate_events(self, P,
                                                               fake):
        fake.create("Pod", P.pod_doc("p1"))
        cluster = make_cluster(P, fake)
        got = []
        cluster.add_watch(lambda kind, etype, obj: got.append(
            (kind, etype, obj.metadata.name)))
        assert wait_until(lambda: fake.subscribers["Pod"], 5), \
            "watch never connected"
        fake.create("Pod", P.pod_doc("p-rv"))
        assert wait_until(lambda: ("Pod", "ADDED", "p-rv") in got, 5)
        fake.kick_watchers("Pod")  # server-side disconnect
        assert wait_until(lambda: fake.subscribers["Pod"], 5), \
            "watch never reconnected"
        fake.create("Pod", P.pod_doc("p2"))
        assert wait_until(lambda: ("Pod", "ADDED", "p2") in got, 5)
        # Resumed from the learned resourceVersion: no relist replay.
        assert ("Pod", "ADDED", "p1") not in got
        assert got.count(("Pod", "ADDED", "p-rv")) == 1
        cluster.stop()

    def test_watch_403_escalates_after_consecutive_failures(self, P, fake,
                                                            caplog):
        forbidden = _status_doc(
            403, "Forbidden",
            'pods is forbidden: User "system:serviceaccount:x:y" cannot '
            'watch resource "pods"')
        fake.request_hook = lambda method, path: (
            (403, forbidden)
            if method == "GET" and "/pods" in path and "watch=true" in path
            else None)

        def escalated():
            return any("view of Pod objects is stale" in r.message
                       for r in caplog.records)

        with caplog.at_level(logging.WARNING, logger=P.name):
            cluster = make_cluster(P, fake)
            got = []
            cluster.add_watch(
                lambda kind, etype, obj: got.append((kind, etype)))
            wait_until(escalated, 10)
        assert any("view of Pod objects is stale" in r.message
                   and "HTTP Error 403" in r.message
                   for r in caplog.records), \
            "persistent 403 never escalated to a warning"
        fake.request_hook = None
        assert wait_until(lambda: fake.subscribers["Pod"], 10), \
            "watch never reconnected after 403"
        fake.create("Pod", P.pod_doc("p-after"))
        assert wait_until(lambda: ("Pod", "ADDED") in got, 10), \
            "watch never recovered after 403"
        cluster.stop()

    def test_status_patch_conflict_raises(self, P, fake):
        fake.create("PodGroup", group_doc("g1", 1))
        cluster = make_cluster(P, fake)
        pg = cluster.list_objects("PodGroup")[0]
        pg.status.phase = "Running"
        fake.request_hook = lambda method, path: (
            (409, _status_doc(
                409, "Conflict",
                'Operation cannot be fulfilled on podgroups "g1": the '
                "object has been modified"))
            if method == "PATCH" and path.endswith("/podgroups/g1/status")
            else None)
        with pytest.raises(HTTPError) as exc:
            cluster.update_pod_group(pg)
        assert exc.value.code == 409
        fake.request_hook = None
        cluster.update_pod_group(pg)
        assert fake.status_patches[-1][0].endswith("/podgroups/g1/status")

    def test_bind_403_scheduler_recovers_next_cycle(self, P, fake):
        """A bind POST denied by RBAC must not wedge the task: the cache
        resyncs it and a later cycle re-binds once the denial clears."""
        fake.create("Queue", queue_doc())
        fake.create("PodGroup", group_doc("g1", 1, queue="default"))
        fake.create("Node", P.node_doc("n1"))
        fake.create("Pod", P.pod_doc("p1", group="g1"))
        denied = {"count": 0}

        def deny_bindings(method, path):
            if method == "POST" and path.endswith("/binding"):
                if denied["count"] < 2:
                    denied["count"] += 1
                    return (403, _status_doc(
                        403, "Forbidden",
                        'pods/binding is forbidden: User cannot create '
                        'resource "pods/binding"'))
            return None

        fake.request_hook = deny_bindings
        cluster = make_cluster(P, fake)
        cache = P.SchedulerCache(cluster=cluster)
        sched = P.Scheduler(cache, schedule_period=0.05)
        stop = threading.Event()
        t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
        t.start()
        try:
            assert wait_until(lambda: denied["count"] >= 2, 10), \
                "bind POST was never attempted"

            def bound():
                with fake.lock:
                    pods = list(fake.objects["Pod"].values())
                return fake.bindings and all(
                    p["status"]["phase"] == "Running" for p in pods)

            assert wait_until(bound, 20), (
                f"pod never bound after RBAC denial cleared: "
                f"bindings={fake.bindings}")
        finally:
            stop.set()
            cluster.stop()
            t.join(timeout=5)


class TestCredentialPlugins:
    """Exec credential plugins and rotating token files."""

    def _stub_plugin(self, tmp_path, token="tok-1", expiry=None,
                     count_file=None):
        status = {"token": token}
        if expiry:
            status["expirationTimestamp"] = expiry
        script = tmp_path / "stub-auth-plugin"
        lines = ["#!/bin/sh"]
        if count_file:
            lines.append(f'echo run >> "{count_file}"')
        cred = json.dumps({
            "apiVersion": "client.authentication.k8s.io/v1",
            "kind": "ExecCredential", "status": status})
        lines.append(f"cat <<'CRED'\n{cred}\nCRED")
        script.write_text("\n".join(lines) + "\n")
        script.chmod(0o755)
        return str(script)

    def _gke_kubeconfig(self, tmp_path, plugin):
        cfg = {
            "apiVersion": "v1", "kind": "Config",
            "current-context": "gke",
            "contexts": [{"name": "gke",
                          "context": {"cluster": "c", "user": "u"}}],
            "clusters": [{"name": "c",
                          "cluster": {"server": "http://127.0.0.1:1"}}],
            "users": [{"name": "u", "user": {"exec": {
                "apiVersion": "client.authentication.k8s.io/v1",
                "command": plugin, "args": [],
                "env": [{"name": "X", "value": "y"}],
                "provideClusterInfo": True, "interactiveMode": "Never",
            }}}],
        }
        path = tmp_path / "kubeconfig"
        path.write_text(yaml.safe_dump(cfg))
        return str(path)

    def test_gke_shaped_kubeconfig_authenticates(self, P, tmp_path, fake):
        plugin = self._stub_plugin(tmp_path, token="gke-token")
        cfg = P.KubeConfig.from_kubeconfig(
            self._gke_kubeconfig(tmp_path, plugin))
        assert cfg.bearer_token() == "gke-token"
        cfg.server = fake.url
        cluster = P.KubeCluster(cfg)
        fake.create("Node", P.node_doc("n1"))
        assert [n.metadata.name for n in cluster.list_objects("Node")] \
            == ["n1"]
        assert fake.last_auth == "Bearer gke-token"

    def test_exec_token_cached_until_expiry_and_invalidate(self, P,
                                                           tmp_path):
        count = tmp_path / "runs"
        plugin = self._stub_plugin(tmp_path, token="t",
                                   expiry="2099-01-01T00:00:00Z",
                                   count_file=str(count))
        auth = P.kube.ExecAuth({"command": plugin})
        assert auth.current() == "t"
        assert auth.current() == "t"  # cached: plugin not re-run
        assert count.read_text().count("run") == 1
        auth.invalidate()  # the 401 path
        assert auth.current() == "t"
        assert count.read_text().count("run") == 2

    def test_legacy_auth_provider_rejected_with_remedy(self, P, tmp_path):
        path = tmp_path / "kubeconfig"
        path.write_text(yaml.safe_dump({
            "current-context": "x",
            "contexts": [{"name": "x",
                          "context": {"cluster": "c", "user": "u"}}],
            "clusters": [{"name": "c", "cluster": {"server": "https://h"}}],
            "users": [{"name": "u", "user": {"auth-provider": {
                "name": "gcp"}}}],
        }))
        with pytest.raises(ValueError, match="exec credential plugin"):
            P.KubeConfig.from_kubeconfig(str(path))

    def test_file_auth_rereads_rotated_token(self, P, tmp_path):
        tok = tmp_path / "token"
        tok.write_text("old")
        auth = P.kube.FileAuth(str(tok))
        assert auth.current() == "old"
        tok.write_text("new")
        os.utime(tok, (time.time() + 5, time.time() + 5))
        assert auth.current() == "new"

    def test_401_retries_once_with_fresh_token(self, P, fake):
        calls = {"n": 0}

        class FlakyAuth:
            def current(self):
                return "stale" if calls["n"] == 0 else "fresh"

            def invalidate(self):
                calls["n"] += 1

        fake.reject_token = "stale"  # FakeKube 401s this bearer token
        cluster = P.KubeCluster(P.KubeConfig(fake.url, auth=FlakyAuth()))
        fake.create("Node", P.node_doc("n1"))
        nodes = cluster.list_objects("Node")
        assert [n.metadata.name for n in nodes] == ["n1"]
        assert calls["n"] == 1
        assert fake.last_auth == "Bearer fresh"


class TestKubeVolumeCapability:
    """Claim phases from the PVC watch drive assume/wait; an unbound
    claim delays dispatch until bound; a bind timeout releases the
    assumptions and resyncs the task."""

    def _schedulable(self, P, fake, claim_phase):
        fake.create("Queue", queue_doc())
        fake.create("Node", P.node_doc("n1"))
        fake.create("PersistentVolumeClaim",
                    P.pvc_doc("data", phase=claim_phase))
        fake.create("Pod", P.pod_with_claim_doc("p1", "data"))

    def _run_once(self, P, fake, bind_timeout):
        cluster = make_cluster(P, fake)
        cache = P.SchedulerCache(
            cluster=cluster,
            volume_binder=P.DefaultVolumeBinder(
                cluster, bind_timeout=bind_timeout))
        stop = threading.Event()
        cache.run(stop)
        assert cache.wait_for_cache_sync(stop)
        time.sleep(0.3)  # PVC watch primes its store via relist
        P.Scheduler(cache).run_once()
        return cluster, cache, stop

    def test_unbound_claim_delays_dispatch_until_bound(self, P, fake):
        self._schedulable(P, fake, claim_phase="Pending")
        cluster, cache, stop = self._run_once(P, fake, bind_timeout=10.0)
        time.sleep(0.5)
        assert fake.bindings == []
        with fake.lock:
            doc = fake.objects["PersistentVolumeClaim"]["default/data"]
            doc["status"]["phase"] = "Bound"
            fake._emit("PersistentVolumeClaim", "MODIFIED", doc)
        wait_until(lambda: fake.bindings, 10)
        assert fake.bindings == [("default/p1", "n1")]
        stop.set()
        cluster.stop()
        cache.shutdown()

    def test_bind_timeout_releases_and_resyncs(self, P, fake):
        self._schedulable(P, fake, claim_phase="Pending")
        cluster, cache, stop = self._run_once(P, fake, bind_timeout=0.3)
        time.sleep(1.2)
        assert fake.bindings == []
        assert cluster._claim_assumed == {}
        stop.set()
        cluster.stop()
        cache.shutdown()


class TestFakeKubeDeterminism:
    """Injectable bind failures, and list order independent of creation
    order."""

    def test_bind_failure_hook_rejects_without_binding(self, P, fake):
        fake.create("Pod", P.pod_doc("p1"))
        failed = []

        def hook(pod_key, hostname):
            failed.append((pod_key, hostname))
            return 500, {"kind": "Status", "code": 500,
                         "reason": "InternalError"}

        fake.bind_failure_hook = hook
        cluster = make_cluster(P, fake)
        pod = cluster.list_objects("Pod")[0]
        with pytest.raises(Exception):
            cluster.bind_pod(pod, "n1")
        assert failed == [("default/p1", "n1")]
        assert fake.bindings == []
        with fake.lock:
            stored = fake.objects["Pod"]["default/p1"]
        assert "nodeName" not in stored["spec"]
        fake.bind_failure_hook = None
        cluster.bind_pod(pod, "n1")
        assert fake.bindings == [("default/p1", "n1")]

    def test_list_order_is_sorted_not_insertion(self, P, fake):
        for name in ("p3", "p1", "p2"):
            fake.create("Pod", P.pod_doc(name))
        cluster = make_cluster(P, fake)
        names = [p.metadata.name for p in cluster.list_objects("Pod")]
        assert names == ["p1", "p2", "p3"]


# ------------------------------------------------- the packages, side by side


def api_documents():
    """One API document of every kind the adapter lists, with the fields
    its parsers read."""
    ref = package(PKGS[0]).fk
    pod = ref.pod_doc("p1", group="g1", cpu="1500m")
    pod["metadata"]["labels"] = {"app": "x"}
    pod["spec"].update(nodeSelector={"zone": "a"}, priority=7,
                       schedulerName="tpu-batch")
    bound = ref.pod_doc("p2", phase="Running")
    bound["spec"]["nodeName"] = "n1"
    node = ref.node_doc("n1", cpu="8", pods="30")
    node["metadata"]["labels"] = {"zone": "a"}
    node["spec"] = {"unschedulable": False, "taints": [
        {"key": "k", "value": "v", "effect": "NoSchedule"}]}
    return [
        ("Node", node), ("Node", ref.node_doc("n2")),
        ("Pod", pod), ("Pod", bound),
        ("Pod", ref.pod_with_claim_doc("p3", "data")),
        ("PodGroup", group_doc("g1", 2, queue="q1")),
        ("Queue", queue_doc("q1", weight=3)),
        ("PriorityClass", {
            "apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
            "metadata": {"name": "high"}, "value": 1000}),
        ("PodDisruptionBudget", {
            "apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": {"name": "pdb1", "namespace": "default",
                         "ownerReferences": [{"uid": "owner-1",
                                              "controller": True}]},
            "spec": {"minAvailable": 1}}),
        ("PersistentVolumeClaim", ref.pvc_doc("data", phase="Bound")),
    ]


def plain(obj):
    """A domain object as plain data: dataclasses to dicts, enums to
    their values, tagged with the type's name. The creation timestamp is
    left out: the parsers stamp the wall clock of the conversion."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {
            f.name: plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.name != "creation_timestamp"})
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if hasattr(obj, "value") and type(obj).__module__.startswith(PKGS[0]):
        return obj.value
    return obj


def test_both_adapters_list_equal_domain_objects():
    """The same documents through both packages' ``KubeCluster`` and
    ``FakeKube``: equal domain objects, field by field."""
    listed = []
    for name in PKGS:
        P = package(name)
        fake = P.FakeKube()
        try:
            for kind, doc in api_documents():
                fake.create(kind, json.loads(json.dumps(doc)))
            cluster = make_cluster(P, fake)
            listed.append({kind: [plain(o) for o in cluster.list_objects(kind)]
                           for kind in P.KubeCluster.WATCH_KINDS})
        finally:
            fake.close()
    assert listed[0] == listed[1]
    counts = {k: len(v) for k, v in listed[1].items()}
    assert counts == {"Pod": 3, "Node": 2, "PodGroup": 1, "Queue": 1,
                      "PriorityClass": 1, "PodDisruptionBudget": 1,
                      "PersistentVolumeClaim": 1}
    pod = dict(listed[1]["Pod"][0][1])
    assert pod["spec"][1]["node_selector"] == {"zone": "a"}


@pytest.fixture
def plain_chain(monkeypatch):
    """The JAX package's TPU policy on one CPU device with host
    selection, and the port's shared ``allocate_tpu`` on its plain
    chain (the JAX default chain)."""
    from kube_batch_tpu.solver import sharding as JS
    from kube_batch_tpu_torch.framework import get_action

    monkeypatch.setenv("KBT_SOLVER", "jax")
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    monkeypatch.delenv("KBT_SOLVER_TOPK", raising=False)
    monkeypatch.setattr(JS, "default_mesh", lambda devices=None: None)
    package(PKGS[1])
    action, _ = get_action("allocate_tpu")
    saved = action.use_kernel
    action.use_kernel = False
    yield
    action.use_kernel = saved


def converged(fake):
    """Both pods run, and a status PATCH reports both running."""
    with fake.lock:
        bodies = [b for _, b in fake.status_patches]
    return running(fake) and any(
        b["status"]["running"] == 2 for b in bodies)


@pytest.mark.parametrize("policy", ["default", "tpu"])
def test_end_to_end_bindings_and_patches_equal(policy, plain_chain):
    """The scheduler end-to-end case through each package's adapter and
    fake, run until a PodGroup status PATCH reports both pods running:
    the same bindings, the same first status body (the binding cycle's)
    and the same converged one. The bodies between them follow when the
    kubelet's Running flips reach the watch, not the package."""
    conf = TPU_CONF if policy == "tpu" else None
    out = []
    for name in PKGS:
        P = package(name)
        P.rng.seed(0)
        fake = P.FakeKube()
        try:
            assert run_gang_end_to_end(P, fake, conf, until=converged), (
                name, fake.bindings, fake.status_patches)
            with fake.lock:
                patches = list(fake.status_patches)
            out.append({
                "bindings": sorted(fake.bindings),
                "paths": sorted({path for path, _ in patches}),
                "first": patches[0][1],
                "converged": next(b for _, b in patches
                                  if b["status"]["running"] == 2),
            })
        finally:
            fake.close()
    assert out[0] == out[1]
    assert out[1]["bindings"] == [("default/p0", "n1"), ("default/p1", "n1")]
    assert out[1]["paths"] == [
        f"/apis/{GROUP}/v1alpha1/namespaces/default/podgroups/g1/status"]
    assert out[1]["converged"]["status"]["phase"] == "Running"
