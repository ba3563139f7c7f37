"""device_idle_pct.proofs: the share of the profiled proof in which nothing
ran on the device, in %."""

from harness.readers import idle_pct as read  # noqa: F401
