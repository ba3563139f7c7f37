"""device_busy_ms.steady: milliseconds a fold step in which something ran
on the device (the union of kernel, copy and fill intervals of the
profiled steps): the step's device work, steady where the host's speed
is not."""

from harness.readers import busy_ms as read  # noqa: F401
