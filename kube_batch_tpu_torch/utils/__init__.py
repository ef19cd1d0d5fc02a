from .gc_guard import deferred_gc
from .priority_queue import PriorityQueue
