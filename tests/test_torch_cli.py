"""Parity of the port's process layer (``cli/``) with the JAX package's.

The nine cases of ``tests/unit/test_cli.py`` run through both packages
and compare: parsed flags, the version banner, the cluster-state loader,
the metrics endpoint, the file-lease elector and ``cli.run`` in
``--once`` mode with and without leader election (same bound (pod,
node) set). The port's own cases follow: ``--device`` in place of the
backend probe (``cuda`` raises without CUDA, the process exits non-zero
with a message), the modes that refuse with a message (``sim`` and
``sim-study`` without CUDA unless ``--device cpu`` is given, ``--master``
without CUDA under the TPU policy, before any request, an unreadable
``--kubeconfig``), the ``explain`` subcommand equals the reference's, and
one cluster-state file goes through ``python -m`` of each package, one
subprocess each, with equal bound sets. The real-cluster mode:
``--master`` and ``--kubeconfig`` (a bearer token) against the port's
``FakeKube`` bind the example gang, and one set of API documents served
to ``python -m`` of each package binds the same (pod, node) set.
"""

import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch
import yaml

PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")
REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_CONF = str(REPO / "config" / "tpu-batch-conf-tpu.yaml")
EXAMPLE_FILE = str(REPO / "config" / "example-cluster.yaml")

EXAMPLE_STATE = {
    "queues": [{"name": "default", "weight": 1}],
    "nodes": [
        {"name": "n1", "allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}},
        {"name": "n2", "allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}},
    ],
    "podGroups": [
        {"name": "pg1", "namespace": "default", "minMember": 3, "queue": "default"}
    ],
    "pods": [
        {"name": f"p{i}", "namespace": "default", "group": "pg1",
         "requests": {"cpu": "1000m", "memory": "1Gi"}}
        for i in range(3)
    ],
}


def cli(pkg):
    return importlib.import_module(f"{pkg}.cli")


def options(pkg, **kw):
    if pkg.endswith("torch"):
        kw.setdefault("device", "cpu")
    return cli(pkg).ServerOption(**kw)


def fields(opt):
    """The flags both packages share (the port swaps the backend-probe
    timeout for ``device``)."""
    out = dataclasses.asdict(opt)
    out.pop("backend_probe_timeout", None)
    out.pop("device", None)
    return out


def bound_pods(cluster):
    return sorted(
        (p.metadata.name, p.spec.node_name, str(p.status.phase))
        for p in cluster.list_objects("Pod") if p.spec.node_name
    )


def seed_greedy(pkg):
    """The greedy allocate picks at random among equal-scored nodes:
    pin each package's tie-break RNG the same way."""
    importlib.import_module(f"{pkg}.utils.scheduler_helper")._rng.seed(0)


def test_parse_options_defaults():
    ref, got = (cli(p).parse_options([]) for p in PKGS)
    assert fields(got) == fields(ref)
    assert got.scheduler_name == "tpu-batch"
    assert got.schedule_period == 1.0
    assert got.default_queue == "default"
    assert got.listen_address == ":8080"
    assert got.enable_priority_class
    assert not got.enable_leader_election
    assert got.device == "cuda"


def test_parse_options_flags():
    argv = [
        "--scheduler-name", "x", "--schedule-period", "0.25",
        "--default-queue", "q", "--leader-elect",
        "--lock-object-namespace", "/tmp/locks", "--no-priority-class",
        "--once",
    ]
    ref, got = (cli(p).parse_options(argv) for p in PKGS)
    assert fields(got) == fields(ref)
    assert got.scheduler_name == "x"
    assert got.schedule_period == 0.25
    assert got.default_queue == "q"
    assert got.enable_leader_election
    assert got.lock_object_namespace == "/tmp/locks"
    assert not got.enable_priority_class
    assert got.once
    assert cli(PKGS[1]).parse_options(["--device", "cpu"]).device == "cpu"


def test_check_option_or_die():
    for pkg in PKGS:
        opt = cli(pkg).ServerOption(
            enable_leader_election=True, lock_object_namespace="")
        with pytest.raises(ValueError, match="lock-object-namespace"):
            opt.check_option_or_die()


def test_version_string():
    banners = [
        importlib.import_module(f"{p}.version").version_string()
        for p in PKGS
    ]
    for s in banners:
        assert "tpu-batch version" in s
    assert banners[0].splitlines()[:4] == banners[1].splitlines()[:4]
    assert "torch:" in banners[1] and "jax" not in banners[1]


def test_cluster_state_loader(tmp_path):
    path = tmp_path / "state.yaml"
    path.write_text(yaml.safe_dump(EXAMPLE_STATE))
    counts = []
    for pkg in PKGS:
        cluster = cli(pkg).load_cluster_state(str(path))
        counts.append({
            kind: sorted(o.metadata.name for o in cluster.list_objects(kind))
            for kind in ("Node", "Pod", "PodGroup", "Queue")
        })
    assert counts[0] == counts[1]
    assert [len(counts[1][k]) for k in ("Node", "Pod", "PodGroup", "Queue")] \
        == [2, 3, 1, 1]


def test_metrics_http_endpoint():
    for pkg in PKGS:
        server, _ = cli(pkg).start_metrics_server("127.0.0.1:0")
        try:
            port = server.server_address[1]
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5
            ).read().decode()
            assert "tpu_batch_e2e_scheduling_latency_seconds" in body
            health = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5
            ).read()
            assert health == b"ok\n"
            dvars = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/vars", timeout=5
            ).read())
            assert "robustness" in dvars and "integrity" in dvars
        finally:
            server.shutdown()


def test_leader_election_exclusive(tmp_path):
    for pkg in PKGS:
        lock_dir = tmp_path / pkg
        lock_dir.mkdir()
        elector = cli(pkg).LeaderElector
        a = elector(str(lock_dir), "a", lease_duration=5.0)
        b = elector(str(lock_dir), "b", lease_duration=5.0)
        assert a.try_acquire()
        assert not b.try_acquire()
        # Stale lease (older than lease_duration) may be stolen.
        with open(a.lock_path) as f:
            lease = json.load(f)
        lease["renew_ts"] = time.time() - 10.0
        with open(a.lock_path, "w") as f:
            json.dump(lease, f)
        assert b.try_acquire()
        assert not a.try_acquire()
        b.release()
        assert not os.path.exists(b.lock_path)


def test_run_once_binds_gang():
    """Full process path: cli.run --once schedules the example gang,
    onto the same nodes in both packages."""
    results = []
    for pkg in PKGS:
        seed_greedy(pkg)
        cluster = cli(pkg).build_cluster_from_dict(EXAMPLE_STATE)
        cli(pkg).run(options(pkg, enable_leader_election=False, once=True,
                             listen_address="127.0.0.1:0"),
                     cluster=cluster)
        results.append(bound_pods(cluster))
    assert results[0] == results[1]
    assert len(results[1]) == 3
    # simulate_kubelet flips bound pods to Running.
    assert all(phase == "Running" for _, _, phase in results[1])


def test_run_with_leader_election(tmp_path):
    """A leader-elected run executes the cycle and releases its lease."""
    results = []
    for pkg in PKGS:
        seed_greedy(pkg)
        lock_dir = tmp_path / pkg
        lock_dir.mkdir()
        cluster = cli(pkg).build_cluster_from_dict(EXAMPLE_STATE)
        opt = options(pkg, enable_leader_election=True,
                      lock_object_namespace=str(lock_dir), once=True,
                      listen_address="127.0.0.1:0")
        done = threading.Event()

        def target():
            cli(pkg).run(opt, cluster=cluster)
            done.set()

        threading.Thread(target=target, daemon=True).start()
        assert done.wait(timeout=30)
        results.append(bound_pods(cluster))
        assert not (lock_dir / "tpu-batch-leader.lock").exists()
    assert results[0] == results[1] and len(results[1]) == 3


# ------------------------------------------------------- the port's own


def subprocess_env(**extra):
    """The test's environment for a child process: this checkout on the
    path, and one compute thread (the suite runs beside other workers)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    return env


def port_main(*argv):
    """``python -m kube_batch_tpu_torch`` in a subprocess."""
    env = subprocess_env()
    return subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch", *argv],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )


def test_device_flag_replaces_the_backend_probe():
    """The TPU policy resolves ``--device`` before the first cycle:
    ``cuda`` without CUDA is a startup error that names ``--device
    cpu``; the default policy never resolves it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid")
    P = cli(PKGS[1])
    cluster = P.build_cluster_from_dict(EXAMPLE_STATE)
    opt = P.ServerOption(once=True, listen_address="127.0.0.1:0",
                         scheduler_conf=TPU_CONF)
    with pytest.raises(P.StartupError, match="--device cpu"):
        P.run(opt, cluster=cluster)
    assert bound_pods(cluster) == []
    P.run(P.ServerOption(once=True, listen_address="127.0.0.1:0"),
          cluster=cluster)
    assert len(bound_pods(cluster)) == 3
    out = port_main("--cluster-state", EXAMPLE_FILE, "--scheduler-conf",
                    TPU_CONF, "--once", "--listen-address", "127.0.0.1:0")
    assert out.returncode != 0
    assert "--device cpu" in out.stderr


def test_unported_modes_refuse_with_a_message(tmp_path):
    """What still refuses to start, each with a ``tpu-batch:`` message
    and no traceback: ``sim`` and ``sim-study`` without CUDA,
    ``--master`` under the TPU policy without CUDA (before any request
    reaches the server), and a ``--kubeconfig`` that is not there. The
    Lease elector and the real-cluster mode are ported (below)."""
    P = cli(PKGS[1])
    with pytest.raises(P.StartupError, match="kubeconfig"):
        P.run(P.ServerOption(once=True, listen_address="127.0.0.1:0",
                             device="cpu",
                             kubeconfig=str(tmp_path / "missing")))
    argvs = [["--kubeconfig", str(tmp_path / "missing"), "--once",
              "--device", "cpu"]]
    if not torch.cuda.is_available():
        argvs += [["--master", "http://127.0.0.1:1", "--scheduler-conf",
                   TPU_CONF, "--once"], ["sim"], ["sim-study"]]
    for argv in argvs:
        out = port_main(*argv)
        assert out.returncode != 0, argv
        assert "tpu-batch:" in out.stderr and "Traceback" not in out.stderr
    assert "tpu-batch version" in port_main("--version").stdout


def test_explain_subcommand_matches_reference(tmp_path, capsys):
    state = dict(EXAMPLE_STATE, pods=EXAMPLE_STATE["pods"] + [{
        "name": "big", "namespace": "default", "group": "pg2",
        "requests": {"cpu": "64", "memory": "1Gi"}}],
        podGroups=EXAMPLE_STATE["podGroups"] + [{
            "name": "pg2", "namespace": "default", "minMember": 1,
            "queue": "default"}])
    path = tmp_path / "state.yaml"
    path.write_text(yaml.safe_dump(state))
    outs = []
    for pkg in PKGS:
        explain = importlib.import_module(f"{pkg}.obs.explain")
        rc = explain.cli_main(["default/pg2", "--cluster-state", str(path),
                               "--json"])
        outs.append((rc, json.loads(capsys.readouterr().out)))
    assert outs[0] == outs[1]
    assert outs[1][0] == 0


_BIND_PROBE = """
import json, runpy, sys
from {pkg}.cluster import api
bind = api.InProcessCluster.bind_pod
def traced(self, pod, hostname):
    bind(self, pod, hostname)
    print("BIND " + json.dumps([pod.metadata.name, hostname]), flush=True)
api.InProcessCluster.bind_pod = traced
sys.argv = [{pkg!r}] + {argv!r}
runpy.run_module({pkg!r}, run_name="__main__")
"""


def test_both_entry_points_bind_the_same_pods(tmp_path):
    """One cluster-state file through ``python -m`` of each package,
    ``--once`` under the TPU policy (the JAX package with host
    selection, the port on the CPU): equal bound (pod, node) sets. The
    probe wraps the in-process cluster's ``bind_pod`` to print each
    bind; everything else is the module's own ``__main__``."""
    state = {
        "queues": [{"name": "default", "weight": 1},
                   {"name": "batch", "weight": 2}],
        "nodes": [{"name": f"n{j}", "allocatable": {
            "cpu": str(4 + 2 * (j % 3)), "memory": f"{8 + 4 * (j % 2)}Gi",
            "pods": "110"}} for j in range(6)],
        "podGroups": [{"name": f"pg{g}", "namespace": "default",
                       "minMember": 1 + g % 3,
                       "queue": "batch" if g % 2 else "default"}
                      for g in range(5)],
        "pods": [{"name": f"pg{g}-p{i}", "namespace": "default",
                  "group": f"pg{g}", "requests": {
                      "cpu": f"{500 * (1 + (g + i) % 3)}m",
                      "memory": f"{512 * (1 + i % 2)}Mi"}}
                 for g in range(5) for i in range(4)],
    }
    path = tmp_path / "state.yaml"
    path.write_text(yaml.safe_dump(state))
    argv = ["--cluster-state", str(path), "--scheduler-conf", TPU_CONF,
            "--once", "--listen-address", "127.0.0.1:0"]
    env = subprocess_env(JAX_PLATFORMS="cpu", KBT_SELECT_DEVICE="0",
                         KBT_SOLVER="jax")
    binds = []
    for pkg, extra in zip(PKGS, ([], ["--device", "cpu"])):
        out = subprocess.run(
            [sys.executable, "-c",
             _BIND_PROBE.format(pkg=pkg, argv=argv + extra)],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        binds.append(sorted(
            tuple(json.loads(line[5:])) for line in out.stdout.splitlines()
            if line.startswith("BIND ")
        ))
    assert binds[0] == binds[1]
    assert len(binds[1]) >= 10


# ------------------------------------------- the real-cluster mode (--master)

GROUP = "scheduling.incubator.k8s.io"


def example_documents(state):
    """A cluster-state dict as Kubernetes API documents."""
    docs = [("Queue", {"apiVersion": f"{GROUP}/v1alpha1", "kind": "Queue",
                       "metadata": {"name": q["name"]},
                       "spec": {"weight": q["weight"]}})
            for q in state["queues"]]
    docs += [("Node", {"apiVersion": "v1", "kind": "Node",
                       "metadata": {"name": n["name"],
                                    "uid": f"uid-{n['name']}"},
                       "status": {"allocatable": n["allocatable"],
                                  "capacity": n["allocatable"]}})
             for n in state["nodes"]]
    docs += [("PodGroup", {"apiVersion": f"{GROUP}/v1alpha1",
                           "kind": "PodGroup",
                           "metadata": {"name": g["name"],
                                        "namespace": g["namespace"]},
                           "spec": {"minMember": g["minMember"],
                                    "queue": g["queue"]}})
             for g in state["podGroups"]]
    docs += [("Pod", {"apiVersion": "v1", "kind": "Pod",
                      "metadata": {
                          "name": p["name"], "namespace": p["namespace"],
                          "uid": f"uid-{p['namespace']}-{p['name']}",
                          "annotations": {
                              "scheduling.k8s.io/group-name": p["group"]}},
                      "spec": {"schedulerName": "tpu-batch", "containers": [
                          {"name": "main",
                           "resources": {"requests": p["requests"]}}]},
                      "status": {"phase": "Pending"}})
             for p in state["pods"]]
    return docs


def fake_kube(state):
    from kube_batch_tpu_torch.utils.fake_kube import FakeKube

    fake = FakeKube()
    for kind, doc in example_documents(state):
        fake.create(kind, json.loads(json.dumps(doc)))
    return fake


def test_master_once_binds_the_example_gang(tmp_path):
    """``python -m kube_batch_tpu_torch --master URL --once --device
    cpu`` against the port's FakeKube binds the example gang through the
    Binding subresource; ``--kubeconfig`` with a bearer token does the
    same, and every request carries the token."""
    fake = fake_kube(EXAMPLE_STATE)
    try:
        out = port_main("--master", fake.url, "--scheduler-conf", TPU_CONF,
                        "--once", "--device", "cpu", "--listen-address",
                        "127.0.0.1:0")
        assert out.returncode == 0, out.stderr[-2000:]
        assert sorted(p for p, _ in fake.bindings) == [
            "default/p0", "default/p1", "default/p2"]
        assert any(path.endswith("/podgroups/pg1/status")
                   for path, _ in fake.status_patches)
    finally:
        fake.close()
    fake = fake_kube(EXAMPLE_STATE)
    try:
        config = tmp_path / "kubeconfig"
        config.write_text(yaml.safe_dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "c",
            "contexts": [{"name": "c",
                          "context": {"cluster": "k", "user": "u"}}],
            "clusters": [{"name": "k", "cluster": {"server": fake.url}}],
            "users": [{"name": "u", "user": {"token": "s3cret"}}],
        }))
        out = port_main("--kubeconfig", str(config), "--once", "--device",
                        "cpu", "--listen-address", "127.0.0.1:0")
        assert out.returncode == 0, out.stderr[-2000:]
        assert len(fake.bindings) == 3
        assert fake.last_auth == "Bearer s3cret"
    finally:
        fake.close()


def test_both_entry_points_bind_the_same_pods_over_http():
    """The six-node, five-gang state of the case above as API documents,
    served by a fresh FakeKube to ``python -m`` of each package with
    ``--master`` under the TPU policy (the JAX package with host
    selection, the port on the CPU): equal bound (pod, node) sets."""
    state = {
        "queues": [{"name": "default", "weight": 1},
                   {"name": "batch", "weight": 2}],
        "nodes": [{"name": f"n{j}", "allocatable": {
            "cpu": str(4 + 2 * (j % 3)), "memory": f"{8 + 4 * (j % 2)}Gi",
            "pods": "110"}} for j in range(6)],
        "podGroups": [{"name": f"pg{g}", "namespace": "default",
                       "minMember": 1 + g % 3,
                       "queue": "batch" if g % 2 else "default"}
                      for g in range(5)],
        "pods": [{"name": f"pg{g}-p{i}", "namespace": "default",
                  "group": f"pg{g}", "requests": {
                      "cpu": f"{500 * (1 + (g + i) % 3)}m",
                      "memory": f"{512 * (1 + i % 2)}Mi"}}
                 for g in range(5) for i in range(4)],
    }
    env = subprocess_env(JAX_PLATFORMS="cpu", KBT_SELECT_DEVICE="0",
                         KBT_SOLVER="jax")
    binds = []
    for pkg, extra in zip(PKGS, ([], ["--device", "cpu"])):
        fake = fake_kube(state)
        try:
            out = subprocess.run(
                [sys.executable, "-m", pkg, "--master", fake.url,
                 "--scheduler-conf", TPU_CONF, "--once", "--listen-address",
                 "127.0.0.1:0", *extra],
                capture_output=True, text=True, cwd=REPO, env=env,
                timeout=300)
            assert out.returncode == 0, out.stderr[-2000:]
            binds.append(sorted(fake.bindings))
        finally:
            fake.close()
    assert binds[0] == binds[1]
    assert len(binds[1]) >= 10
