"""Shared plugin utilities.

Mirrors reference pkg/scheduler/plugins/util/util.go: the PodLister analog
(session pods with session-assigned node names projected on, :31-85) used by
pod-(anti)affinity evaluation, plus the predicate failure type.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api import TaskInfo, TaskStatus


class PredicateError(Exception):
    """A predicate rejection; carries a machine-readable reason."""

    def __init__(self, reason: str, message: str = ""):
        self.reason = reason
        self.message = message or reason
        super().__init__(self.message)


# Statuses that make a task "present" for (anti-)affinity evaluation: on a
# node now or headed there this session (includes PIPELINED, unlike
# api.allocated_status — a pipelined group-mate must anchor affinity).
PLACED_STATUSES = (
    TaskStatus.RUNNING,
    TaskStatus.ALLOCATED,
    TaskStatus.PIPELINED,
    TaskStatus.BINDING,
    TaskStatus.BOUND,
)


class SessionPodLister:
    """Lists session pods with the session's current node assignment
    (reference plugins/util/util.go:31-85: pods whose task moved in-session
    get a copy with NodeName updated)."""

    def __init__(self, ssn):
        self.ssn = ssn

    def tasks(self) -> List[TaskInfo]:
        out = []
        for job in self.ssn.jobs.values():
            out.extend(job.tasks.values())
        return out

    def pods_on_node(self, node_name: str) -> List[TaskInfo]:
        out = []
        for task in self.tasks():
            if task.node_name == node_name and task.status in PLACED_STATUSES:
                out.append(task)
        return out


def match_label_selector(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    """Plain equality-based selector match."""
    return all(labels.get(k) == v for k, v in selector.items())


def match_expressions(expressions: List[Dict], labels: Dict[str, str]) -> bool:
    """Conjunction of match expressions (In/NotIn/Exists/DoesNotExist)."""
    for expr in expressions:
        key = expr.get("key", "")
        op = expr.get("operator", "In")
        values = expr.get("values", []) or []
        if op == "In":
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if labels.get(key) in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            return False
    return True


def match_node_selector_terms(terms: Optional[List], labels: Dict[str, str]) -> bool:
    """Evaluate required node affinity: a pod matches if ANY
    nodeSelectorTerm is satisfied; expressions within one term are a
    conjunction (k8s nodeMatchesNodeSelectorTerms, vendored by reference
    predicates.go PodMatchNodeSelector).

    ``terms`` is a list of terms, each term a list of match-expression
    dicts. A flat list of expression dicts (the pre-term-structure
    representation still used by direct Affinity constructors) is accepted
    as a single term. An individual EMPTY term matches nothing (k8s: "a
    null or empty nodeSelectorTerm matches no objects")."""
    if not terms:
        return True
    if isinstance(terms[0], dict):  # flat: one term of expressions
        terms = [terms]
    return any(bool(term) and match_expressions(term, labels) for term in terms)


def match_affinity_term(term: Dict, labels: Dict[str, str]) -> bool:
    """One pod-(anti)affinity term against a pod's labels: matchLabels
    (equality) AND matchExpressions (set ops) must both hold, per k8s
    metav1.LabelSelector semantics."""
    if not match_label_selector(term.get("label_selector", {}) or {}, labels):
        return False
    exprs = term.get("match_expressions") or []
    return match_expressions(exprs, labels) if exprs else True
