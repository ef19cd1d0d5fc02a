"""Conformance plugin (reference plugins/conformance/conformance.go:40-65):
never evict system-critical PriorityClass pods or kube-system pods during
preempt/reclaim."""

from __future__ import annotations

from ..framework import Plugin, register_plugin_builder

SYSTEM_CLUSTER_CRITICAL = "system-cluster-critical"
SYSTEM_NODE_CRITICAL = "system-node-critical"
KUBE_SYSTEM_NAMESPACE = "kube-system"


class ConformancePlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "conformance"

    def on_session_open(self, ssn) -> None:
        def evictable_fn(evictor, evictees):
            victims = []
            for evictee in evictees:
                class_name = evictee.pod.spec.priority_class_name
                if (
                    class_name in (SYSTEM_CLUSTER_CRITICAL, SYSTEM_NODE_CRITICAL)
                    or evictee.namespace == KUBE_SYSTEM_NAMESPACE
                ):
                    continue
                victims.append(evictee)
            return victims

        ssn.add_preemptable_fn(self.name(), evictable_fn)
        ssn.add_reclaimable_fn(self.name(), evictable_fn)


register_plugin_builder("conformance", lambda args: ConformancePlugin(args))
