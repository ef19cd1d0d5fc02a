"""Typed cluster-API error taxonomy + deterministic retry.

The resync/relist paths used to catch blanket ``Exception`` and apply
ad-hoc backoff, which conflates "the API server briefly told us to go
away" (retry in place, cheaply) with "this object/request is broken"
(requeue or drop — retrying a malformed request forever is how a
poisoned task spins a queue). The taxonomy makes the distinction a
type, and :func:`retry_transient` gives every list/relist call site
one retry policy: capped exponential backoff with DETERMINISTIC jitter
(a blake2b hash of the salt + attempt, never a shared RNG), so the sim
can inject transient failures (``relist-fail``) and the run still
replays bit-identically — the retry *decisions* are pure functions,
only their wall-clock sleep cost is real.

| error | meaning | retry? |
|---|---|---|
| ``TransientClusterError`` | timeout / throttle / conflict analog — the request was fine, the moment was not | yes, in place |
| ``ClusterUnavailableError`` | the whole endpoint is briefly gone (connection refused, 5xx storm) | yes, in place |
| ``TerminalClusterError`` | the request itself can never succeed (schema, permissions) | no — surface it |
| ``ObjectGoneError`` | the named object no longer exists | no — reconcile as a delete |
"""

from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


class ClusterAPIError(Exception):
    """Base of the typed cluster-API error taxonomy."""


class TransientClusterError(ClusterAPIError):
    """Retryable: the request was valid but the moment was not
    (timeout, throttle, optimistic-concurrency conflict)."""


class ClusterUnavailableError(TransientClusterError):
    """The endpoint itself is briefly unreachable; retryable."""


class TerminalClusterError(ClusterAPIError):
    """Non-retryable: the request can never succeed as issued."""


class ObjectGoneError(TerminalClusterError):
    """The named object no longer exists — reconcile it as deleted
    rather than retrying the read."""


def deterministic_jitter(salt: str, attempt: int) -> float:
    """Uniform [0, 1) drawn from a pure hash of (salt, attempt): every
    retry ladder gets spread (no thundering relist herd after an
    API-server blip) without a shared RNG stream whose draw ORDER would
    depend on thread timing — the same determinism regime (and the
    same helper) as the sim's per-bind fault hash."""
    from ..utils.determinism import hash01

    return hash01(salt, attempt)


def backoff_delay(
    attempt: int, base: float, cap: float, salt: str
) -> float:
    """Capped exponential with deterministic jitter: ``base * 2^attempt``
    capped at ``cap``, scaled by a hash-drawn factor in [0.5, 1.0]."""
    raw = min(base * (2.0 ** attempt), cap)
    return raw * (0.5 + 0.5 * deterministic_jitter(salt, attempt))


def retry_transient(
    fn: Callable[[], T],
    *,
    attempts: int = 4,
    base: float = 0.05,
    cap: float = 2.0,
    salt: str = "cluster-op",
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``fn`` retrying ONLY :class:`TransientClusterError` (and its
    subclasses), up to ``attempts`` total tries with
    :func:`backoff_delay` between them. Terminal errors and foreign
    exceptions surface immediately — classification is the caller's
    contract with its cluster backend, not something to guess here."""
    last: Exception
    for attempt in range(attempts):
        try:
            return fn()
        except TransientClusterError as exc:
            last = exc
            if attempt + 1 >= attempts:
                break
            delay = backoff_delay(attempt, base, cap, salt)
            logger.warning(
                "transient cluster error (%s); retry %d/%d in %.3fs",
                exc, attempt + 1, attempts - 1, delay,
            )
            sleep(delay)
    raise last
