"""``tests/test_health.py`` held against the port.

The reference's event-log, SMART-monitor and alert-engine tests run here as
they are written, except that every ``from repro.`` import names
``repro_torch.``: the port's copies of ``telemetry.health`` and
``telemetry.alerts`` (with the event log, metrics, zns device and array
queues those tests reach) must pass the reference's own assertions.
"""
from pathlib import Path

_REFERENCE = Path(__file__).with_name("test_health.py")
exec(compile(_REFERENCE.read_text().replace("from repro.", "from repro_torch."),
             str(_REFERENCE), "exec"))
