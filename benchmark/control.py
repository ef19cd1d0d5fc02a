"""The control: a plain scheduler in the program's place, with two
guarantees of the configuration broken.

It is a pod-at-a-time scheduler, as a scheduler without gangs or node
scoring is: each cycle places one pending pod, on a node drawn at
random among those where it fits, reading the cache's mirror as the
program does and binding through the cache. It takes no notice of a
gang's minMember, so after the cycle that binds a gang's first pod the
gang is below it whenever its minMember is above one, and none of the
policy's ``nodeorder`` score: the comparison has to count
``gang_below_min`` and a ``score_gap`` over its limit, and call the run
not correct.
"""

from __future__ import annotations

import threading

import numpy as np

POLL_S = 0.001


class ControlScheduler:
    def __init__(self, cache):
        from kube_batch_tpu_torch.api import TaskStatus

        self.cache = cache
        self.pending = TaskStatus.PENDING
        self.names: list = []
        self.idle = None
        self.rng = np.random.default_rng(0)

    def sweep(self) -> list:
        """The mirror's nodes and pending pods, read once for a run of
        one-pod cycles."""
        cache = self.cache
        with cache.mutex:
            self.names = list(cache.nodes)
            nodes = [cache.nodes[n] for n in self.names]
            self.idle = np.array(
                [[n.idle.milli_cpu, n.idle.memory / (1 << 20),
                  n.allocatable.max_task_num - len(n.tasks)] for n in nodes],
                dtype=np.float64)
            return [t for job in cache.jobs.values()
                    for t in job.tasks.values()
                    if t.status == self.pending and not t.node_name]

    def run_once(self, task) -> None:
        """One cycle: one pod."""
        idle = self.idle
        req = np.array([task.resreq.milli_cpu, task.resreq.memory / (1 << 20)])
        fits = (idle[:, :2] >= req).all(axis=1) & (idle[:, 2] >= 1)
        if not fits.any():
            return
        j = int(self.rng.choice(np.flatnonzero(fits)))
        idle[j, :2] -= req
        idle[j, 2] -= 1
        self.cache.bind(task, self.names[j])

    def run_micro(self) -> None:
        return None

    def run(self, stop: threading.Event) -> None:
        self.cache.run(stop)
        while not stop.is_set():
            for task in self.sweep():
                if stop.is_set():
                    break
                self.run_once(task)
            stop.wait(POLL_S)


def factory(cache, conf, period, device):
    return ControlScheduler(cache)
