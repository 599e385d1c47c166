"""``device_idle_pct.render``: the device's idle share while
``render.render`` runs image after image (``_idle``)."""

from benchmark.metrics._idle import idle_pct as read  # noqa: F401
