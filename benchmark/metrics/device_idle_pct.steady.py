"""device_idle_pct.steady: the share of the profiled fold steps in which
nothing ran on the device, in %."""

from harness.readers import idle_pct as read  # noqa: F401
