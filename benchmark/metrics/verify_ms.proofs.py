"""verify_ms.proofs: milliseconds a proof of the program's
verify(strict=True), timed by the harness to torch.cuda.synchronize()."""

from harness.readers import harness_ms


def read(run):
    return harness_ms(run, "verify_s")
