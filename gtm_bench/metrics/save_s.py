"""save_s (s an encode; layer save and host: bitstream/, native LZMA): the
spans around reindex and save, mean over the encodes; paced by the host."""


def read(run):
    return run.span_mean("reindex", "save")
