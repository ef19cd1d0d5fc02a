"""Share of the window's solving cycles whose solve took the full dense
path: the program's own count of the solver that produced each cycle's
result (``allocate_tpu.last_stats["solve_path"]``: ``sparse``,
``dense``, ``staged`` or ``native``), over every cycle that solved."""


def read(ctx):
    paths = [c["stats"].get("solve_path") for c in ctx.cycles
             if ctx.in_window(c["t0"]) and "rounds" in c.get("stats", {})]
    if not any(p is not None for p in paths):
        return None
    return 100.0 * paths.count("dense") / len(paths)
