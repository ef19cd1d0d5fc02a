"""Scheduler policy configuration.

Mirrors reference pkg/scheduler/conf/scheduler_conf.go (:20
SchedulerConfiguration, :28 Tier, :33 PluginOption with per-callback enable
flags :36-55) and the YAML policy format of config/kube-batch-conf.yaml:

    actions: "allocate, backfill"
    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: drf
      - name: predicates
      - name: proportion
      - name: nodeorder

Per-plugin defaults are all-on (reference plugins/defaults.go:23
ApplyPluginConfDefaults).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class PluginOption:
    """reference scheduler_conf.go:33-57"""

    name: str
    enabled_job_order: Optional[bool] = None
    enabled_job_ready: Optional[bool] = None
    enabled_job_pipelined: Optional[bool] = None
    enabled_task_order: Optional[bool] = None
    enabled_preemptable: Optional[bool] = None
    enabled_reclaimable: Optional[bool] = None
    enabled_queue_order: Optional[bool] = None
    enabled_predicate: Optional[bool] = None
    enabled_node_order: Optional[bool] = None
    arguments: Dict[str, str] = field(default_factory=dict)


@dataclass
class Tier:
    """reference scheduler_conf.go:28-31"""

    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConfiguration:
    """reference scheduler_conf.go:20-26"""

    actions: str = ""
    tiers: List[Tier] = field(default_factory=list)


# Reference-compatible enable keys (scheduler_conf.go:37-54 yaml tags).
_ENABLE_FIELDS = {
    "enableJobOrder": "enabled_job_order",
    "enableJobReady": "enabled_job_ready",
    "enableJobPipelined": "enabled_job_pipelined",
    "enableTaskOrder": "enabled_task_order",
    "enablePreemptable": "enabled_preemptable",
    "enableReclaimable": "enabled_reclaimable",
    "enableQueueOrder": "enabled_queue_order",
    "enablePredicate": "enabled_predicate",
    "enableNodeOrder": "enabled_node_order",
}
# Alias spelling: <fn>Disabled: true ≡ enable<Fn>: false.
_DISABLE_FIELDS = {
    "jobOrderDisabled": "enabled_job_order",
    "jobReadyDisabled": "enabled_job_ready",
    "jobPipelinedDisabled": "enabled_job_pipelined",
    "taskOrderDisabled": "enabled_task_order",
    "preemptableDisabled": "enabled_preemptable",
    "reclaimableDisabled": "enabled_reclaimable",
    "queueOrderDisabled": "enabled_queue_order",
    "predicateDisabled": "enabled_predicate",
    "nodeOrderDisabled": "enabled_node_order",
}


def apply_plugin_conf_defaults(option: PluginOption) -> None:
    """Everything defaults to enabled (reference plugins/defaults.go:23-52)."""
    for attr in (
        "enabled_job_order",
        "enabled_job_ready",
        "enabled_job_pipelined",
        "enabled_task_order",
        "enabled_preemptable",
        "enabled_reclaimable",
        "enabled_queue_order",
        "enabled_predicate",
        "enabled_node_order",
    ):
        if getattr(option, attr) is None:
            setattr(option, attr, True)


def parse_scheduler_conf(confstr: str) -> SchedulerConfiguration:
    """Parse YAML policy (reference scheduler/util.go:44-72 loadSchedulerConf).

    Accepts the reference YAML schema: plugin entries carry ``name``, optional
    ``*Disabled`` booleans, and free-form string ``arguments``.
    """
    import yaml

    data = yaml.safe_load(confstr) or {}
    conf = SchedulerConfiguration(actions=data.get("actions", ""))
    for tier_data in data.get("tiers", []) or []:
        tier = Tier()
        for p in tier_data.get("plugins", []) or []:
            opt = PluginOption(name=p["name"])
            for yaml_key, attr in _ENABLE_FIELDS.items():
                if yaml_key in p:
                    setattr(opt, attr, bool(p[yaml_key]))
            for yaml_key, attr in _DISABLE_FIELDS.items():
                if yaml_key in p:
                    setattr(opt, attr, not bool(p[yaml_key]))
            raw_args = p.get("arguments") or {}
            opt.arguments = {str(k): str(v) for k, v in raw_args.items()}
            apply_plugin_conf_defaults(opt)
            tier.plugins.append(opt)
        conf.tiers.append(tier)
    return conf


# Default policy (reference scheduler/util.go:32-42 defaultSchedulerConf).
DEFAULT_SCHEDULER_CONF = """
actions: "allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""
