"""Median over the pods the window's cycles placed of the time each
waited for the cycle that placed it to start: the program's own count
(``allocate_tpu.last_stats["job_waits"]``, per job its pods and their
mean wait), weighted by pods, each program cycle counted once even when
its record is seen again in a later cycle's stats."""


def read(ctx):
    seen = set()
    pairs = []
    for c in ctx.cycles:
        rec = c.get("stats", {}).get("job_waits")
        if not rec or not ctx.in_window(c["t0"]) or rec["cycle"] in seen:
            continue
        seen.add(rec["cycle"])
        pairs.extend(rec["waits"])
    total = sum(n for n, _ in pairs)
    if not total:
        return None
    count = 0
    for n, ms in sorted(pairs, key=lambda p: p[1]):
        count += n
        if 2 * count >= total:
            return ms
