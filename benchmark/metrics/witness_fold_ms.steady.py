"""witness_fold_ms.steady: milliseconds a fold step of the program's span
`witness_fold` (NIFS fold)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "witness_fold")
