"""Pure-hash determinism helpers.

One implementation of the hash-to-[0,1) draw both determinism regimes
rely on — the simulator's per-identity fault decisions
(sim/faults._hash01) and the cluster retry policy's jitter
(cluster/errors.deterministic_jitter). Keyed on stable identities, the
draw is independent of PYTHONHASHSEED and thread timing, so concurrent
callers decide identically at record and replay. Two drifting copies
of this function would silently desynchronize those regimes.
"""

from __future__ import annotations

import hashlib


def hash01(*parts: object) -> float:
    """Stable uniform [0, 1) from identity parts."""
    digest = hashlib.blake2b(
        "\x1f".join(str(p) for p in parts).encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2**64
