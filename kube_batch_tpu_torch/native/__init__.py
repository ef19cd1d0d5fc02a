"""ctypes bindings for the native (C++) components under native/.

The native greedy allocator is both the measured baseline for bench.py
(the fair stand-in for the reference's compiled Go loop — see
native/greedy.cpp) and a CPU fallback path. The shared library is built
on demand with the system toolchain; callers must handle
:class:`NativeUnavailable` when no compiler is present.
"""

from .greedy import (
    NativeUnavailable,
    greedy_allocate,
    last_solve_stats,
    native_available,
    solve_native,
)

__all__ = [
    "NativeUnavailable",
    "greedy_allocate",
    "last_solve_stats",
    "native_available",
    "solve_native",
]
