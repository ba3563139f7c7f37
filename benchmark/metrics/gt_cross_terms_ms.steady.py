"""gt_cross_terms_ms.steady: milliseconds a fold step of the program's span
`gt_cross_terms` (NIFS prove: the host pairings of the Gt cross terms of
the Groth16 proofs carried by the folded instances)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "gt_cross_terms")
