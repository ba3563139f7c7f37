"""proof_s: the timed interval over the proofs completed in it (zero step,
fold steps, strict verify each)."""


def read(run):
    return run.window.per_unit_s()
