"""synthesize_ms.steady: milliseconds a fold step of the program's span
`synthesize` (witness synthesis, both sides summed)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "synthesize")
