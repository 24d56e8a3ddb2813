"""yl2_candidates (trials; layer dither and reconstruct): the (color,
total) trials of the Yliluoma2 plan search in an encode, the program's
counter step_stats["yl2_candidates"] of the window's first encode."""


def read(run):
    enc = run.encodes
    return enc[0].step_stats.get("yl2_candidates") if enc else None
