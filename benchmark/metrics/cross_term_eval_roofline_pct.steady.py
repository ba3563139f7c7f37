"""cross_term_eval_roofline_pct.steady: the least time of the cross terms'
problem (harness/counts.py `cross_terms_bound_s`) over the device time of
every kernel launched under the program's span `cross_term_eval`, in %."""

from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "cross_terms_s", "cross_term_eval",
                        "cross_term_eval_roofline_pct.steady")
