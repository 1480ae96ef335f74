"""``launch_us``: the kernel launch's host time a command, in us: the mean
over the traced slice's completed commands of their ``tier.launch`` spans
(``JittedProgram.launch``; on the kernel tier the zone filter's wrapper,
which enqueues the kernel and returns)."""
from zcsd_bench import spans


def read(td):
    v = spans.mean_of(td, "tier.launch")
    return None if v is None else v * 1e6
