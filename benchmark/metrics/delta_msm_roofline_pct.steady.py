"""delta_msm_roofline_pct.steady: the least time of the delta commit's
problem (harness/counts.py `msm_bound_s`) over the device time of every
kernel launched under the program's span `delta_msm`, in %."""

from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "delta_msm_s", "delta_msm", "delta_msm_roofline_pct.steady")
