"""Process layer: flags, metrics server, leader election, main entry.

Mirrors reference cmd/kube-batch/ (main.go, app/server.go, app/options).

A copy of the JAX package's ``cli``: ``python -m kube_batch_tpu_torch``
runs the same process on the port (``--device`` picks ``cuda`` or
``cpu``), and ``sim`` and ``sim-study`` run the port's simulator.
"""

from .options import (
    DEFAULT_LISTEN_ADDRESS,
    DEFAULT_QUEUE,
    DEFAULT_SCHEDULER_NAME,
    DEFAULT_SCHEDULER_PERIOD,
    ServerOption,
    ServerOpts,
    add_flags,
    parse_options,
    register_options,
)
from .server import LeaderElector, StartupError, run, start_metrics_server
from .state import build_cluster_from_dict, load_cluster_state

__all__ = [
    "DEFAULT_LISTEN_ADDRESS",
    "DEFAULT_QUEUE",
    "DEFAULT_SCHEDULER_NAME",
    "DEFAULT_SCHEDULER_PERIOD",
    "LeaderElector",
    "ServerOption",
    "ServerOpts",
    "StartupError",
    "add_flags",
    "build_cluster_from_dict",
    "load_cluster_state",
    "parse_options",
    "register_options",
    "run",
    "start_metrics_server",
]


def main(argv=None) -> None:
    """reference cmd/kube-batch/main.go:38."""
    import logging
    import sys

    from ..version import print_version_and_exit

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    # Blank-import analog: populate action/plugin registries
    # (reference main.go:33-35).
    from .. import actions as _actions  # noqa: F401
    from .. import plugins as _plugins  # noqa: F401

    args = sys.argv[1:] if argv is None else list(argv)
    if args and args[0] == "sim":
        # Subcommand: the deterministic cluster simulator
        # (kube_batch_tpu_torch/sim). `python -m kube_batch_tpu_torch sim
        # --help`.
        from ..sim.cli import main as sim_main

        sys.exit(sim_main(args[1:]))
    if args and args[0] == "sim-study":
        # Subcommand: multi-seed paired A/B placement-quality study
        # (kube_batch_tpu_torch/sim/study.py). `sim-study --help`.
        from ..sim.study import main as study_main

        sys.exit(study_main(args[1:]))
    if args and args[0] == "explain":
        # Subcommand: pending-gang explainability
        # (`python -m kube_batch_tpu_torch explain <ns>/<job>`).
        from ..obs.explain import cli_main as explain_main

        sys.exit(explain_main(args[1:]))

    opt = parse_options(argv)
    if opt.print_version:
        print_version_and_exit()
    try:
        run(opt)
    except StartupError as exc:
        print(f"tpu-batch: {exc}", file=sys.stderr)
        sys.exit(2)
