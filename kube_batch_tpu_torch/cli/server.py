"""Server runner: metrics endpoint, leader election, scheduler lifecycle.

Mirrors reference cmd/kube-batch/app/server.go (:63 Run — build config,
start scheduler, /metrics HTTP server :86-89, leader election via resource
lock :96-141). Standalone substitutions: the cluster substrate is the
in-process store (or a YAML-loaded snapshot of one), and the leader lock is
a lease file in the lock namespace directory — same lease/renew/retry
timings as the reference's ConfigMap lock (server.go:49-53).

A copy of the JAX package's ``cli/server.py``, edited where it named JAX:
the backend probe before the first cycle becomes the device choice
(``--device``, resolved through ``device.resolve_device`` when the policy
names ``allocate_tpu``, before the cluster, the cache or the first
cycle), handed to ``Scheduler(..., device=)``. No CUDA under ``--device
cuda`` is a :class:`StartupError`, in real-cluster mode
(``--master``/``--kubeconfig``) too: the process never contacts the API
server then. A kubeconfig that cannot be read is one as well.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import torch

from .. import metrics
from ..cache import new_scheduler_cache
from ..cluster import ClusterAPI, InProcessCluster
from ..conf import DEFAULT_SCHEDULER_CONF
from ..device import resolve_device
from ..obs import QUALITY, RECORDER, TELEMETRY
from ..obs import explain as obs_explain
from ..obs import latency as obs_latency
from ..obs import telemetry as obs_telemetry
from ..scheduler import Scheduler, load_scheduler_conf
from ..version import RELEASE_VERSION
from .options import (
    LEASE_DURATION,
    RENEW_DEADLINE,
    RETRY_PERIOD,
    ServerOption,
    register_options,
)
from .state import load_cluster_state

logger = logging.getLogger(__name__)

class StartupError(RuntimeError):
    """The process cannot start as asked: a device that is not there, or
    a cluster config that cannot be read. ``cli.main`` prints it and
    exits non-zero."""


class _MetricsHandler(BaseHTTPRequestHandler):
    """Serves /metrics (Prometheus text exposition, reference
    server.go:86-89 promhttp handler) plus the observability surface:

    - ``/healthz``: cheap liveness ("ok") — probes must not scrape the
      full exposition;
    - ``/debug/vars``: uptime, version, last-cycle age, cycle error
      count, plus a resource-health snapshot (process RSS, allocator
      blocks, CUDA device memory, the kernel build census,
      telemetry ring occupancy) as one small JSON object — one curl
      answers "is this process healthy";
    - ``/debug/timeseries``: the long-horizon telemetry windows + the
      newest raw per-cycle samples (obs/telemetry.py);
    - ``/debug/flightrecorder``: the flight recorder's ring as
      canonical JSON (obs/flightrecorder.py);
    - ``/debug/latency``: the placement-latency ledger snapshot —
      per-queue/per-cycle-kind stage-decomposed percentiles, recent
      applied entries, audit-ring meta (obs/latency.py);
    - ``/debug/quality``: the placement-quality monitor snapshot —
      the newest scorecard (density/fragmentation/fairness/churn)
      plus the cumulative churn counters (obs/quality.py);
    - ``/debug/jobs`` and ``/debug/jobs/<ns>/<name>``: per-job last
      unschedulable verdicts (obs/explain.py).

    Unknown paths get a 404 WITH a body naming the path — a silent
    empty 404 reads like a transport bug from curl."""

    def _reply(self, body, ctype="text/plain", code=200):
        if isinstance(body, str):
            body = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _debug_vars(self) -> dict:
        now = time.time()
        last = RECORDER.last_cycle_ts
        out = {
            "version": RELEASE_VERSION,
            "pid": os.getpid(),
            "uptime_seconds": round(now - _SERVER_STARTED[0], 3),
            "last_cycle_age_seconds": (
                round(now - last, 3) if last is not None else None
            ),
            "cycles_recorded": RECORDER._seq,
            "cycle_errors": metrics.scheduler_cycle_errors.get(),
            "unschedulable_jobs": len(obs_explain.all_verdicts()),
            "telemetry": {
                "cycles_observed": TELEMETRY.cycles_observed,
                "windows_rolled": TELEMETRY.windows_rolled,
                "window_cycles": TELEMETRY.window_cycles,
                "ring_occupancy": len(TELEMETRY._raw),
            },
        }
        # Resource-watermark snapshot: same probes the telemetry series
        # record (RSS, allocator blocks, CUDA device memory, the
        # kernel build census, ring occupancies, label-series
        # cardinality) — a single curl gives a health picture.
        try:
            out["watermarks"] = obs_telemetry.collect_watermarks(
                cache=TELEMETRY.attached_cache()
            )
        except Exception:  # pragma: no cover - probes must not 500
            logger.exception("/debug/vars watermark probe failed")
        # Placement-latency SLI summary (obs/latency.py): stamped/
        # applied counters, stage and per-queue p99s, audit-ring meta —
        # one curl answers "are pods placing, and how fast". The full
        # percentile tree lives at /debug/latency.
        try:
            out["latency"] = {
                **obs_latency.LEDGER.summary(),
                "audit": obs_latency.AUDIT.meta(),
            }
        except Exception:  # pragma: no cover - probes must not 500
            logger.exception("/debug/vars latency probe failed")
        # Serving SLO surface (doc/design/serving.md): per-class
        # attainment, violation count, budget burn, pending targeted
        # placements — one curl answers "are serving SLOs being met".
        # A duplicate of latency.serving at the top level so SLO health
        # is greppable next to robustness/integrity.
        try:
            out["serving"] = obs_latency.LEDGER.serving_summary()
        except Exception:  # pragma: no cover - probes must not 500
            logger.exception("/debug/vars serving probe failed")
        # Degraded-mode surface (doc/design/robustness.md): breaker
        # state machine + quarantine age, the last ladder descent, the
        # loop watchdog, and the leadership fence — one curl says
        # whether (and why) the scheduler is running on a lower rung.
        try:
            from ..cache import recovery as cache_recovery
            from ..scheduler import ACTIVE_WATCHDOG, LEASE_TTL_CHECK
            from ..solver import containment

            cache = TELEMETRY.attached_cache()
            fence_fn = getattr(cache, "fence_reason", None)
            out["robustness"] = {
                "breaker": containment.BREAKER.state_dict(),
                "last_fallback": (
                    dict(containment.last_fallback) or None
                ),
                "solve_budget_seconds": containment.solve_budget(),
                "watchdog": (
                    ACTIVE_WATCHDOG.state_dict()
                    if ACTIVE_WATCHDOG is not None else None
                ),
                "watchdog_trips": metrics.scheduler_watchdog_trips.get(),
                "cache_fence": fence_fn() if fence_fn else None,
                # Failover surface: the startup journal-recovery pass's
                # outcome (None = clean start / no journal seam) and
                # the lease-TTL sanity verdict vs the watchdog budget.
                "recovery": cache_recovery.LAST_RECOVERY,
                "lease_ttl": LEASE_TTL_CHECK,
            }
        except Exception:  # pragma: no cover - probes must not 500
            logger.exception("/debug/vars robustness probe failed")
        # Placement-quality surface (doc/design/quality.md): headline
        # numbers off the newest scorecard (packing density, Jain
        # fairness, emptiable nodes, churn per placement) plus the
        # cumulative disruption counters — one curl answers "is the
        # scheduler placing WELL, not just fast". The full card lives
        # at /debug/quality.
        try:
            snap = QUALITY.snapshot()
            last = snap.get("last") or {}
            out["quality"] = {
                "enabled": snap["enabled"],
                "every": snap["every"],
                "cards_computed": snap["cards_computed"],
                "counters": snap["counters"],
                "density_dom": last.get("density_dom"),
                "fairness_jain": (
                    last.get("fairness", {}).get("jain")
                    if last else None
                ),
                "emptiable_nodes": (
                    last.get("frag", {}).get("emptiable_nodes")
                    if last else None
                ),
                "churn_per_placement": (
                    last.get("churn", {}).get("per_placement")
                    if last else None
                ),
            }
        except Exception:  # pragma: no cover - probes must not 500
            logger.exception("/debug/vars quality probe failed")
        # State-integrity surface (doc/design/robustness.md, cluster-
        # truth anti-entropy): absorbed event-stream anomalies, watch-
        # gap/relist state, and the divergence sweep's cumulative
        # detected/repaired counters — one curl answers "does the
        # mirror still match the cluster, and what repaired it".
        try:
            cache = TELEMETRY.attached_cache()
            integrity_fn = getattr(cache, "integrity_state", None)
            out["integrity"] = integrity_fn() if integrity_fn else None
        except Exception:  # pragma: no cover - probes must not 500
            logger.exception("/debug/vars integrity probe failed")
        return out

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/")
        if path in ("", "/healthz"):
            self._reply("ok\n")
        elif path.startswith("/metrics"):
            self._reply(
                metrics.REGISTRY.expose_text(),
                ctype="text/plain; version=0.0.4",
            )
        elif path == "/debug/vars":
            self._reply(
                json.dumps(self._debug_vars(), sort_keys=True) + "\n",
                ctype="application/json",
            )
        elif path == "/debug/timeseries":
            self._reply(
                json.dumps(
                    TELEMETRY.snapshot(), sort_keys=True, default=repr
                ) + "\n",
                ctype="application/json",
            )
        elif path == "/debug/flightrecorder":
            self._reply(
                RECORDER.dump_json(reason="http") + "\n",
                ctype="application/json",
            )
        elif path == "/debug/latency":
            payload = obs_latency.LEDGER.snapshot()
            payload["audit"] = obs_latency.AUDIT.meta()
            self._reply(
                json.dumps(payload, sort_keys=True, default=repr) + "\n",
                ctype="application/json",
            )
        elif path == "/debug/quality":
            self._reply(
                json.dumps(
                    QUALITY.snapshot(), sort_keys=True, default=repr
                ) + "\n",
                ctype="application/json",
            )
        elif path == "/debug/jobs":
            payload = {
                "jobs": [v.to_dict() for v in obs_explain.all_verdicts()]
            }
            self._reply(
                json.dumps(payload, sort_keys=True) + "\n",
                ctype="application/json",
            )
        elif path.startswith("/debug/jobs/"):
            uid = path[len("/debug/jobs/"):]
            verdict = obs_explain.get_verdict(uid)
            if verdict is None:
                self._reply(
                    f"no unschedulable verdict recorded for job "
                    f"{uid!r}\n",
                    code=404,
                )
            else:
                self._reply(
                    json.dumps(
                        {"verdict": verdict.to_dict()}, sort_keys=True
                    ) + "\n",
                    ctype="application/json",
                )
        else:
            self._reply(f"404 page not found: {self.path}\n", code=404)

    def log_message(self, fmt, *args):
        logger.debug("metrics-http: " + fmt, *args)


# Wall-clock epoch of the most recent start_metrics_server call (list so
# the handler reads the live value; /debug/vars uptime).
_SERVER_STARTED = [time.time()]


def start_metrics_server(listen_address: str) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the /metrics endpoint in a daemon thread; returns (server, thread)."""
    host, _, port = listen_address.rpartition(":")
    _SERVER_STARTED[0] = time.time()
    server = ThreadingHTTPServer((host or "0.0.0.0", int(port)), _MetricsHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="metrics-http")
    thread.start()
    return server, thread


class LeaderElector:
    """File-lease leader election.

    The reference locks a ConfigMap via resourcelock + leaderelection
    (server.go:96-141, lease 15s / renew 10s / retry 5s). Standalone analog:
    an O_EXCL-created lease file carrying {holder, renew_ts}; a lease whose
    renew timestamp is older than the lease duration may be stolen. Same
    timings, same semantics: winner runs, loser retries; losing the lease
    mid-flight calls on_stopped_leading (the reference fatals there,
    server.go:133).
    """

    def __init__(
        self,
        lock_dir: str,
        identity: str,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
    ):
        self.lock_path = os.path.join(lock_dir, "tpu-batch-leader.lock")
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._renew_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.is_leader = False
        self._lost: Optional[threading.Event] = None
        self.fenced_reason: Optional[str] = None

    def fence(self, reason: str = "") -> None:
        """Zombie-leader fencing (called by the loop watchdog via
        ``Scheduler.fence_hooks``): this process believes it is wedged,
        so it must STOP renewing and release the lease — otherwise the
        renew thread, which is perfectly healthy, keeps the cluster
        hostage to a leader that makes no progress. Signals the lost
        event too, so anything chained on leadership loss (the
        scheduling loop's stop) fires when the process unwedges."""
        self.fenced_reason = reason or "fenced"
        logger.error(
            "leader election FENCED (%s): releasing lease, no further "
            "renewals", self.fenced_reason,
        )
        self.is_leader = False
        if self._lost is not None:
            self._lost.set()
        self.release()

    def _read_lease(self):
        try:
            with open(self.lock_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_lease(self) -> None:
        tmp = f"{self.lock_path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump({"holder": self.identity, "renew_ts": time.time()}, f)
        os.replace(tmp, self.lock_path)

    def try_acquire(self) -> bool:
        """Compare-and-swap on the lease, serialized by an flock mutex.

        The reference's resourcelock does CAS through the API server's
        resourceVersion; plain rename/O_EXCL dances cannot express
        'replace only if unchanged' (a holder resuming from a long stall
        could clobber a freshly stolen lease → split brain), so the
        read-check-write runs under an exclusive flock on a sidecar mutex
        file instead."""
        import fcntl

        if self._stop.is_set():
            # release()/fence() is clearing the lease: an in-flight
            # renew must not re-acquire it for the dying identity.
            self.is_leader = False
            return False
        with open(f"{self.lock_path}.mutex", "a+") as mutex:
            try:
                # Non-blocking: a peer frozen INSIDE the critical section
                # must not wedge every other contender forever (flock is
                # only released on process exit) — failing this attempt
                # and retrying preserves the lease-expiry liveness story.
                fcntl.flock(mutex, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                self.is_leader = False
                return False
            try:
                lease = self._read_lease()
                now = time.time()
                can_take = (
                    lease is None
                    or lease["holder"] == self.identity
                    or now - lease["renew_ts"] > self.lease_duration
                )
                if can_take:
                    self._write_lease()
                self.is_leader = can_take
                return self.is_leader
            finally:
                fcntl.flock(mutex, fcntl.LOCK_UN)

    def run(self, on_started_leading, on_stopped_leading) -> None:
        """Block until leadership is acquired, then run the payload while
        renewing every retry_period (reference leaderelection.RunOrDie)."""
        while not self._stop.is_set() and not self.try_acquire():
            logger.info("leader election: lease held by another instance; retrying")
            self._stop.wait(self.retry_period)
        if self._stop.is_set():
            return

        lost = threading.Event()
        self._lost = lost

        def renew_loop():
            last_renew = time.time()
            while not self._stop.is_set() and not lost.is_set():
                if self.try_acquire():
                    last_renew = time.time()
                elif time.time() - last_renew > self.renew_deadline:
                    lost.set()
                    break
                self._stop.wait(self.retry_period)

        self._renew_thread = threading.Thread(
            target=renew_loop, daemon=True, name="leader-renew"
        )
        self._renew_thread.start()
        try:
            on_started_leading(lost)
        finally:
            if lost.is_set():
                self.is_leader = False
                on_stopped_leading()

    def release(self) -> None:
        self._stop.set()
        # Drain the renew loop BEFORE removing the lease file: a renew
        # whose read-check-write straddles the removal would re-create
        # the lease for a dying identity, pinning the cluster to it for
        # a full lease_duration (the same zombie-renew race the Kube
        # elector drains; fence() relies on this ordering too).
        if (
            self._renew_thread is not None
            and self._renew_thread is not threading.current_thread()
        ):
            self._renew_thread.join(timeout=10.0)
        lease = self._read_lease()
        if lease and lease["holder"] == self.identity:
            try:
                os.remove(self.lock_path)
            except OSError:
                pass


class KubeLeaseElector(LeaderElector):
    """Leader election over a coordination/v1 Lease in the API server —
    the reference's ConfigMap resourcelock analog (server.go:113-141),
    giving cross-HOST failover in real-cluster mode where the file lease
    only covers processes sharing a disk. Reuses LeaderElector's
    acquire/renew loop; only the CAS differs (API-server resourceVersion
    instead of an flock'd file)."""

    def __init__(
        self,
        cluster,
        namespace: str,
        identity: str,
        name: str = "tpu-batch",
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
    ):
        self.cluster = cluster
        self.namespace = namespace
        self.name = name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._renew_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.is_leader = False
        self._lost: Optional[threading.Event] = None
        self.fenced_reason: Optional[str] = None
        # True once this identity has EVER held the lease. release()
        # keys on this, not on the last attempt's is_leader: a transient
        # API failure (or lost CAS) right before shutdown flips
        # is_leader False while the API server still records us as
        # holder — skipping release then forces the successor to wait
        # out the full lease_duration (r2 advisor).
        self.held_at_least_once = False

    def try_acquire(self) -> bool:
        if self._stop.is_set():
            # release() is clearing the lease: an in-flight renew must
            # not re-acquire it for the dying identity.
            return False
        try:
            self.is_leader = self.cluster.try_acquire_lease(
                self.namespace, self.name, self.identity,
                self.lease_duration,
            )
            if self.is_leader:
                self.held_at_least_once = True
        except Exception:
            # Transient API failure: this attempt fails; the renew loop's
            # renew_deadline decides when failing attempts lose leadership.
            logger.exception("lease acquire attempt failed")
            self.is_leader = False
        return self.is_leader

    def release(self) -> None:
        self._stop.set()
        # Drain the renew loop BEFORE clearing the holder: a renew whose
        # API call straddles the release would otherwise re-write
        # holderIdentity after we cleared it, re-pinning the lease to a
        # dying process for the full lease_duration.
        if self._renew_thread is not None:
            self._renew_thread.join(timeout=10.0)
        if self.held_at_least_once:
            # release_lease clears the holder only if it is still this
            # identity, so releasing after a genuine takeover is a no-op.
            self.cluster.release_lease(
                self.namespace, self.name, self.identity
            )
            self.is_leader = False


def run(opt: ServerOption, cluster: Optional[ClusterAPI] = None,
        stop_event: Optional[threading.Event] = None) -> None:
    """reference app/server.go:63-141 Run."""
    register_options(opt)

    # Resolve the device ONCE, before the cluster, the cache or the
    # first cycle, and only for a policy that solves on it (the
    # reference probes its backend under the same condition). No CUDA
    # under the default --device cuda is a startup error, never a quiet
    # CPU run; a policy without allocate_tpu touches no device.
    from .. import actions as _actions  # noqa: F401 (registers actions)

    confstr = opt.scheduler_conf or DEFAULT_SCHEDULER_CONF
    if "\n" not in confstr and confstr.endswith((".yaml", ".yml")):
        with open(confstr) as f:
            confstr = f.read()
    actions, _ = load_scheduler_conf(confstr)
    device = "cpu"
    if any(a.name() == "allocate_tpu" for a in actions):
        try:
            device = resolve_device(opt.device)
        except RuntimeError as exc:
            raise StartupError(
                f"--device {opt.device}: no CUDA device is available; "
                f"pass --device cpu to run the plain versions on the CPU"
            ) from exc
        logger.info("allocate_tpu solves on %s%s", device, (
            f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""
        ))

    kube = None
    if cluster is None:
        if opt.master or opt.kubeconfig:
            # Real-cluster mode (reference server.go:56-61 buildConfig).
            from ..cluster.kube import KubeCluster, KubeConfig

            try:
                config = KubeConfig.resolve(
                    kubeconfig=opt.kubeconfig, master=opt.master
                )
            except (OSError, ValueError) as exc:
                raise StartupError(f"cluster config: {exc}") from exc
            cluster = kube = KubeCluster(config)
        elif opt.cluster_state:
            cluster = load_cluster_state(
                opt.cluster_state, simulate_kubelet=opt.simulate_kubelet
            )
        else:
            cluster = InProcessCluster(simulate_kubelet=opt.simulate_kubelet)

    cache = new_scheduler_cache(
        cluster, opt.scheduler_name, opt.default_queue,
        enable_priority_class=opt.enable_priority_class,
    )
    sched = Scheduler(
        cache,
        scheduler_conf=confstr,
        schedule_period=opt.schedule_period,
        device=device,
    )

    http_server, _ = start_metrics_server(opt.listen_address)
    # SIGUSR1 → flight-recorder dump. Installed HERE (cli.run is always
    # on the main thread) as well as in Scheduler.run, because signal
    # handlers cannot be installed from the worker thread an embedder
    # may drive the loop on.
    from ..obs import install_sigusr1

    install_sigusr1()
    stop = stop_event or threading.Event()

    def run_scheduler(lost_leadership: Optional[threading.Event] = None):
        if opt.once:
            cache.run(stop)
            cache.wait_for_cache_sync(stop)
            # Same recovery discipline as the loop: a --once run on a
            # cluster with surviving bind intents reconciles them
            # before its single cycle plans on top.
            try:
                sched.recover_from_journal()
            except Exception:
                logger.exception("--once journal recovery failed")
            sched.run_once()
            # Binds/evicts execute on the cache's async pool; barrier so
            # callers observe the fully-applied schedule after run().
            cache.wait_for_side_effects()
            return
        if lost_leadership is not None:
            # Chain: leadership loss stops the scheduling loop.
            def watch():
                lost_leadership.wait()
                stop.set()
            threading.Thread(target=watch, daemon=True).start()
        sched.run(stop)

    try:
        if not opt.enable_leader_election:
            run_scheduler()
            return

        opt.check_option_or_die()
        identity = f"{os.uname().nodename}-{os.getpid()}"
        # Journal records carry the elector identity, so a successor's
        # recovery can tell a dead predecessor's intents from its own;
        # the real-cluster journal Lease co-lives with the leader lock.
        cache.leader_identity = identity
        if getattr(cluster, "supports_lease_election", False):
            # Real-cluster journal Lease co-lives with the leader lock
            # (lock_object_namespace is a k8s namespace here; for the
            # file elector below it is a directory path).
            if hasattr(cluster, "journal_namespace"):
                cluster.journal_namespace = opt.lock_object_namespace
            # Real-cluster mode: the lock object lives in the API server
            # (coordination/v1 Lease — the reference's ConfigMap
            # resourcelock analog, server.go:113-141), so failover works
            # across hosts, not just processes on one machine.
            elector = KubeLeaseElector(
                cluster, opt.lock_object_namespace, identity=identity
            )
        else:
            elector = LeaderElector(
                opt.lock_object_namespace, identity=identity
            )
        # Zombie-leader fencing: a loop-watchdog trip (cycle hung past
        # its no-progress budget) stops lease renewal and releases it,
        # so a healthy instance can take over while the cache fence
        # keeps this process's side-effect threads from issuing binds.
        sched.fence_hooks.append(elector.fence)
        # Lease-TTL sanity: warn (and export at /debug/vars) when the
        # lease can expire under a healthy-but-slow leader before the
        # watchdog would fence it.
        sched.check_lease_ttl(elector.lease_duration)
        try:
            elector.run(
                on_started_leading=run_scheduler,
                on_stopped_leading=lambda: logger.error(
                    "lost leadership; stopping scheduling loop"
                ),
            )
        finally:
            elector.release()
    finally:
        stop.set()
        http_server.shutdown()
        if kube is not None:
            # The adapter this run built stops its watch threads with it.
            kube.stop()
