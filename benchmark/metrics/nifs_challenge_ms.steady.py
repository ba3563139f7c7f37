"""nifs_challenge_ms.steady: milliseconds a fold step of the program's span
`nifs_challenge` (NIFS prove: the host transcript over the pp digest, both
instances and the cross-term commitments)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "nifs_challenge")
