"""tape_vm_ms.steady: milliseconds a fold step of the program's span
`tape_vm` (witness synthesis: the inputs bound to the tape and the native
VM's run)."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "tape_vm")
