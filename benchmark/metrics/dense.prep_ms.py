"""Mean time of the full dense solve's ``solve.prep`` span (the [T, N]
feasibility and static score matrices and the Releasing-capacity
escape, before the first round) per solving cycle of the window whose
solve took that path; a program without the span gives ``None``."""

from benchmark.readings import mean
from benchmark.work_dense import dense_solves


def read(ctx):
    return mean(sum(t1 - t0 for t0, t1 in spans["solve.prep"]) * 1e3
                for spans, _, _, _ in dense_solves(ctx)
                if spans.get("solve.prep"))
