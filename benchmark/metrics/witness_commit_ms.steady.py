"""witness_commit_ms.steady: milliseconds a fold step of the program's span
`witness_commit` (the SPS rounds and the delta commit, fenced)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "witness_commit")
