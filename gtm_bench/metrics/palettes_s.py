"""palettes_s (s an encode; layer tiling: pipeline/reduce.py, palettes.py,
cluster/): the span around prepare_palettes, mean over the encodes."""


def read(run):
    return run.span_mean("prepare_palettes")
