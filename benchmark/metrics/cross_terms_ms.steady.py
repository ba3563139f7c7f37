"""cross_terms_ms.steady: milliseconds a fold step of the program's span
`VanillaFS.commit_cross_terms` (NIFS prove)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "VanillaFS.commit_cross_terms")
