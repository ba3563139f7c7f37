"""zero_step_ms.proofs: milliseconds a proof of the IVC constructor (the
zero step), timed by the harness to torch.cuda.synchronize()."""

from harness.readers import harness_ms


def read(run):
    return harness_ms(run, "zero_step_s")
