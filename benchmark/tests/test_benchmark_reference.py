"""The reference's arithmetic on hand-made logs."""

import math

import numpy as np

from benchmark import reference as R


def test_unbound_pod_counts_as_missing_every_limit():
    lat = R.latencies_ms(np.zeros(100), np.r_[np.full(94, 0.5),
                                               np.full(6, np.nan)])
    assert np.isinf(lat).sum() == 6
    assert R.percentile(lat, 50) == 500.0
    assert math.isinf(R.percentile(lat, 95))
    lat = R.latencies_ms(np.zeros(100), np.r_[np.full(96, 0.5),
                                               np.full(4, np.nan)])
    assert R.percentile(lat, 95) == 500.0


def test_percentile_is_nearest_rank_over_all_pods():
    assert R.percentile(np.arange(1, 101, dtype=float), 95) == 95.0
    assert R.percentile([3.0], 95) == 3.0


def _world():
    # 2 nodes of 4 CPU, 4 GiB, 3 pods; pods 0-1 running on node 0.
    alloc = np.array([[4000, 4096, 3], [4000, 4096, 3]])
    req = np.array([[1000, 1024]] * 6)
    gang = np.array([0, 0, 1, 1, 1, 2])
    gmin = np.array([1, 3, 1])
    initial = np.array([0, 0, -1, -1, -1, -1])
    return R.World(alloc, req, gang, gmin, initial)


def _mirror(rows):
    return np.array(rows)


def test_a_sound_log_reads_zero_everywhere():
    log = [("dispatch", 1.0, 0, 2, 1), ("dispatch", 1.0, 0, 3, 1),
           ("dispatch", 1.0, 0, 4, 1), ("cycle_end", 1.1, 0),
           ("ack", 1.2, 2, 1), ("ack", 1.2, 3, 1), ("ack", 1.3, 4, 1),
           ("delete", 2.0, 0)]
    counts = R.replay(_world(), log, np.array([2, 3, 4]),
                      _mirror([[1000, 1024, 1], [3000, 3072, 3]]))
    counts["event_errors"] = 0
    assert counts == dict.fromkeys(R.LIMITS, 0)
    assert R.correct(R.judge(counts))


def test_each_breach_is_counted():
    log = [("dispatch", 1.0, 0, 2, 0), ("dispatch", 1.0, 0, 3, 0),
           ("cycle_end", 1.1, 0),                 # gang 1: 2 of min 3
           ("ack", 1.2, 2, 0), ("ack", 1.2, 3, 0),
           ("ack", 1.3, 3, 0),                    # a second bind
           ("dispatch", 1.4, 1, 5, 1), ("cycle_end", 1.5, 1),
           ("ack", 1.6, 5, 0)]                    # another node
    counts = R.replay(_world(), log, np.array([2, 3, 4, 5]),
                      _mirror([[4000, 4096, 4], [0, 0, 0]]))
    assert counts["gang_below_min"] == 1
    assert counts["apply_mismatch"] == 2
    assert counts["unbound"] == 1                  # pod 4
    assert counts["overcommit"] == 2               # node 0: 4 pods > 3, then 5
    assert counts["mirror_mismatch"] == 1
    counts["event_errors"] = 0
    assert not R.correct(R.judge(counts))


def test_an_assignment_no_bind_followed_is_a_mismatch():
    log = [("dispatch", 1.0, 0, 5, 1), ("cycle_end", 1.1, 0)]
    counts = R.replay(_world(), log, np.array([], dtype=np.int64),
                      _mirror([[2000, 2048, 2], [0, 0, 0]]))
    assert counts["apply_mismatch"] == 1


def test_scores_prefer_the_emptier_and_balanced_node():
    idle = np.array([[8000.0, 8192.0], [30000.0, 120000.0], [30000.0, 30000.0]])
    cap = np.array([[32000.0, 131072.0]] * 3)
    s = R.scores(np.array([1000.0, 1024.0]), idle, cap)
    assert s.argmax() == 1
    assert (s >= 0).all() and (s <= 20).all()


def test_score_gap_is_read_against_the_cycle_start():
    # Node 0 holds pods 0-1 (2 CPU of 4 used), node 1 is empty: node 1 is
    # the best for any pod, and stays the reference's best for a cycle's
    # later assignments, whatever the cycle gave away before them.
    world = _world()
    cap = world.alloc[:, :2].astype(float)
    best = R.scores(np.array([1000.0, 1024.0]),
                    np.array([[2000.0, 2048.0], [4000.0, 4096.0]]), cap)
    to_best = [("cycle_start", 0.9, 0), ("dispatch", 1.0, 0, 2, 1),
               ("dispatch", 1.0, 0, 3, 1), ("cycle_end", 1.1, 0)]
    counts = R.replay(world, to_best, np.array([], dtype=np.int64),
                      _mirror([[2000, 2048, 2], [0, 0, 0]]))
    assert counts["score_gap"] == 0.0
    off = [("cycle_start", 0.9, 0), ("dispatch", 1.0, 0, 2, 1),
           ("dispatch", 1.0, 0, 3, 0), ("cycle_end", 1.1, 0)]
    counts = R.replay(world, off, np.array([], dtype=np.int64),
                      _mirror([[2000, 2048, 2], [0, 0, 0]]))
    assert np.isclose(counts["score_gap"], (best[1] - best[0]) / 2)
    assert counts["score_gap"] > 0


def test_a_later_cycle_starts_from_what_the_earlier_one_assigned():
    # Cycle 0 assigns two pods to node 1 (not yet bound); cycle 1 starts
    # with node 1 at 2 CPU used, so node 0 and node 1 tie for its pod.
    world = _world()
    log = [("cycle_start", 0.9, 0), ("dispatch", 1.0, 0, 2, 1),
           ("dispatch", 1.0, 0, 3, 1), ("cycle_end", 1.1, 0),
           ("cycle_start", 1.2, 1), ("dispatch", 1.3, 1, 5, 0),
           ("cycle_end", 1.4, 1)]
    counts = R.replay(world, log, np.array([], dtype=np.int64),
                      _mirror([[2000, 2048, 2], [0, 0, 0]]))
    assert counts["score_gap"] == 0.0
