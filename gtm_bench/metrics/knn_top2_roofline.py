"""knn_top2_roofline (%; layer kernels): the B2 top-k kernel's least time
over every launch of the window's first encode (roofline.knn_bound on each
launch's real cells and the corpus's T tiles, the program's counter
step_stats["corpus_tiles"]), times the traced encodes, over its device
time in the traced window."""

from gtm_bench import roofline

KERNEL = ("knn_top2_wgmma", "false")
DEPTH = 208  # the folded operands' depth


def read(run):
    if run.trace is None or not run.capture.knn_launches or not run.encodes:
        return None
    seconds, launches = run.trace.seconds_matching(*KERNEL)
    if not launches:
        return None
    tiles = run.encodes[0].step_stats["corpus_tiles"]
    per_encode = sum(roofline.knn_bound(int(real), tiles, DEPTH, padded)[0]
                     for _, padded, real in run.capture.knn_launches)
    return 100.0 * per_encode * len(run.encodes) / seconds
