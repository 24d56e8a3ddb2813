"""yl2_select_roofline (%; layer kernels): the Yliluoma2 kernel's least
time from the timed encode's shapes (yl2_roofline.bound_s: the corpus's
pixels and the valid colors of their palettes, the program's counters
step_stats["corpus_tiles"] and ["dither_colors"] of the window's first
encode, and the plan size its stream's settings state) times its
launches, over its device time in the traced window."""

from gtm_bench import yl2_roofline

KERNEL = ("yl2_select_kernel",)


def read(run):
    if run.trace is None or not run.encodes or not run.window.first_sha:
        return None
    stats = run.encodes[0].step_stats
    if "dither_colors" not in stats:
        return None
    seconds, launches = run.trace.seconds_matching(*KERNEL)
    mixed = yl2_roofline.stream_mixed(run.window.streams[run.window.first_sha])
    if not launches or mixed is None:
        return None
    bound, _ = yl2_roofline.bound_s(64 * stats["corpus_tiles"], stats["dither_colors"], mixed)
    return 100.0 * bound * launches / seconds
