"""ivc_zero_step_ms.proofs: milliseconds a proof of the program's span
`IVC.zero_step` (the IVC constructor's zero step: both sides' synthesis and
first trace), with the fenced spans inside it."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "IVC.zero_step")
