"""instance_fold_ms.steady: milliseconds a fold step of the program's span
`instance_fold` (NIFS fold: host curve arithmetic on the instances'
commitments)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "instance_fold")
