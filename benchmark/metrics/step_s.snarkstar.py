"""step_s.snarkstar: step_s read per layer, in the cells whose host-bound
steps run too unevenly from run to run for an end-to-end bound: the fold
steps after the profiled ones, their seconds over their count."""


def read(run):
    if not run.span_units:
        return None
    xs = run.window.unit_s[run.span_units_from:]
    return sum(xs) / len(xs)
