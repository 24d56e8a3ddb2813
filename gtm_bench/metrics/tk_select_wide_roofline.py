"""tk_select_wide_roofline (%; layer kernels): the wide dither kernel's
(S = 33..256) least time on the timed encode's own inputs
(roofline.tk_bound: operations or bytes at the published H100 SXM peaks)
times its launches, over its device time in the traced window."""

from gtm_bench import roofline

KERNEL = ("tk_select_wide_kernel",)


def read(run):
    if run.trace is None or run.capture.tk is None:
        return None
    seconds, launches = run.trace.seconds_matching(*KERNEL)
    if not launches:
        return None
    bound, _ = roofline.tk_bound(*run.capture.tk[:4])
    return 100.0 * bound * launches / seconds
