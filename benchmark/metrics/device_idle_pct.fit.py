"""``device_idle_pct.fit``: the device's idle share over traced fit steps
(``_idle``)."""

from benchmark.metrics._idle import idle_pct as read  # noqa: F401
