"""step_inputs_ms.steady: milliseconds a fold step of the program's span
`step_inputs` (witness synthesis: the step's inputs flattened for the tape
VM)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "step_inputs")
