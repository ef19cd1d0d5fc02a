"""Process flags.

Mirrors reference cmd/kube-batch/app/options/options.go (:33 ServerOption,
:59 AddFlags, :83 CheckOptionOrDie, :91 RegisterOptions → global ServerOpts
:48). The kubeconfig/master flags become --cluster-state (the standalone
substrate: a YAML snapshot loaded into the in-process cluster).

A copy of the JAX package's ``cli/options.py`` with one flag swapped:
``--device`` (``cuda`` by default, ``cpu`` on request) takes the place of
``--backend-probe-timeout``. The JAX package probes its accelerator
backend in a bounded subprocess and routes a wedged one to the CPU; the
port names its device and raises where CUDA is absent.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import List, Optional

from ..api.objects import DEFAULT_SCHEDULER_NAME
DEFAULT_SCHEDULER_PERIOD = 1.0  # seconds (reference options.go:29)
DEFAULT_QUEUE = "default"       # reference options.go:30
DEFAULT_LISTEN_ADDRESS = ":8080"  # reference options.go:31

# Leader-election lease timings (reference app/server.go:49-53).
LEASE_DURATION = 15.0
RENEW_DEADLINE = 10.0
RETRY_PERIOD = 5.0


@dataclass
class ServerOption:
    """reference options.go:33-56"""

    cluster_state: str = ""          # standalone in-process cluster seed
    master: str = ""                 # k8s API server URL (reference --master)
    kubeconfig: str = ""             # kubeconfig path (reference --kubeconfig)
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    scheduler_conf: str = ""
    schedule_period: float = DEFAULT_SCHEDULER_PERIOD
    # Matches the --leader-elect flag default (standalone single-process is
    # the common case); the reference's flag also defaults to false.
    enable_leader_election: bool = False
    lock_object_namespace: str = ""
    default_queue: str = DEFAULT_QUEUE
    listen_address: str = DEFAULT_LISTEN_ADDRESS
    enable_priority_class: bool = True
    print_version: bool = False
    simulate_kubelet: bool = True
    once: bool = False               # run one cycle and exit (debugging aid)
    # Where allocate_tpu solves: "cuda" (default) or "cpu". Resolved once
    # before the first cycle, and only when the policy names allocate_tpu.
    device: str = "cuda"

    def check_option_or_die(self) -> None:
        """reference options.go:83-89"""
        if self.enable_leader_election and not self.lock_object_namespace:
            raise ValueError(
                "lock-object-namespace must not be nil when LeaderElection is enabled"
            )


# Global registered options (reference options.go:46-48 ServerOpts; read by
# the cache for EnablePriorityClass, cache.go:369,384).
ServerOpts: Optional[ServerOption] = None


def register_options(opt: ServerOption) -> None:
    """reference options.go:91-95"""
    global ServerOpts
    ServerOpts = opt


def add_flags(parser: argparse.ArgumentParser) -> None:
    """reference options.go:59-80"""
    parser.add_argument(
        "--cluster-state", default="",
        help="YAML file describing nodes/queues/podgroups/pods to load into "
             "the in-process cluster (standalone mode)")
    parser.add_argument(
        "--master", default="",
        help="The address of the Kubernetes API server (overrides any "
             "value in kubeconfig)")
    parser.add_argument(
        "--kubeconfig", default="",
        help="Path to kubeconfig file with authorization and master "
             "location information; enables real-cluster mode")
    parser.add_argument(
        "--scheduler-name", default=DEFAULT_SCHEDULER_NAME,
        help="tpu-batch will handle pods whose .spec.SchedulerName is same as "
             "scheduler-name")
    parser.add_argument(
        "--scheduler-conf", default="",
        help="The absolute path of scheduler configuration file")
    parser.add_argument(
        "--schedule-period", type=float, default=DEFAULT_SCHEDULER_PERIOD,
        help="The period between each scheduling cycle, seconds")
    parser.add_argument(
        "--default-queue", default=DEFAULT_QUEUE,
        help="The default queue name of the job")
    parser.add_argument(
        "--leader-elect", action="store_true", default=False,
        help="Start a leader election client and gain leadership before "
             "executing the main loop")
    parser.add_argument(
        "--lock-object-namespace", default="",
        help="Define the namespace (lock directory) of the lock object")
    parser.add_argument(
        "--listen-address", default=DEFAULT_LISTEN_ADDRESS,
        help="The address to listen on for HTTP requests (/metrics)")
    parser.add_argument(
        "--priority-class", dest="priority_class", action="store_true",
        default=True,
        help="Enable PriorityClass to provide the capacity of preemption at "
             "pod group level")
    parser.add_argument(
        "--no-priority-class", dest="priority_class", action="store_false")
    parser.add_argument(
        "--no-simulate-kubelet", dest="simulate_kubelet", action="store_false",
        default=True,
        help="Disable the hollow-kubelet simulation (bound pods will stay "
             "Pending until an external agent runs them)")
    parser.add_argument(
        "--once", action="store_true", default=False,
        help="Run a single scheduling cycle and exit")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="Device the allocate_tpu solve runs on; cuda exits with an "
             "error where no CUDA device is present, cpu runs the plain "
             "versions of the kernels")
    parser.add_argument(
        "--version", action="store_true", default=False,
        help="Show version and quit")


def parse_options(argv: Optional[List[str]] = None) -> ServerOption:
    parser = argparse.ArgumentParser(prog="tpu-batch")
    add_flags(parser)
    ns = parser.parse_args(argv)
    return ServerOption(
        cluster_state=ns.cluster_state,
        master=ns.master,
        kubeconfig=ns.kubeconfig,
        scheduler_name=ns.scheduler_name,
        scheduler_conf=ns.scheduler_conf,
        schedule_period=ns.schedule_period,
        enable_leader_election=ns.leader_elect,
        lock_object_namespace=ns.lock_object_namespace,
        default_queue=ns.default_queue,
        listen_address=ns.listen_address,
        enable_priority_class=ns.priority_class,
        print_version=ns.version,
        simulate_kubelet=ns.simulate_kubelet,
        once=ns.once,
        device=ns.device,
    )
