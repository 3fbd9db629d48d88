"""The program's protection kernels in the traced window: the sum of each
launch's least time (the frozen yardstick's bytes at 3.35 TB/s, or its
int32 ops where those bind, worked out from the operand's shape) over
their device time in the trace.  Nothing where a launch is of an entry
point the yardstick has no count for."""
from portbench.reference import yardstick


def read(run):
    tr, launches = run.get("trace"), run["launches"]
    if not tr or not tr["protection_s"] or not launches:
        return None
    if any(name not in yardstick.BASE_OPS for name, _, _ in launches):
        return None
    least = sum(yardstick.launch_bound_s(name, shape, r)[2]
                for name, shape, r in launches)
    return yardstick.share(least, tr["protection_s"])
