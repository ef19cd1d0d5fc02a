from .gc_guard import deferred_gc
