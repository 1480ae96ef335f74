"""``frontend_us``: the command front end's own host time a command, in us:
the mean over the traced slice's completed commands of their
``csd.command`` span less what the union of their spans of layers with
metrics of their own covers (``csd.verify``, ``tier.read``, ``tier.stage``,
``tier.launch``, ``tier.result``, ``py.gc``). What is left is
``nvm_cmd_bpf_run``'s Python: ``csd.prepare``, the stats and the rest of
its bookkeeping."""
from zcsd_bench import spans

OWN_METRICS = ("csd.verify", "tier.read", "tier.stage", "tier.launch",
               "tier.result", spans.GC)


def read(td):
    cmds = spans.commands(td)
    if not cmds:
        return None
    own = [root["dur"] - spans.covered(root, [s for s in inside
                                              if s["name"] in OWN_METRICS])
           for root, inside in cmds]
    return sum(own) / len(own) * 1e6
