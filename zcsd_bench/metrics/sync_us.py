"""``sync_us``: the result's return a command, in us: the mean over the
traced slice's completed commands of their ``tier.result`` spans
(``JittedProgram.to_host``: the wait for the card and the card-to-host
copy of the result)."""
from zcsd_bench import spans


def read(td):
    v = spans.mean_of(td, "tier.result")
    return None if v is None else v * 1e6
