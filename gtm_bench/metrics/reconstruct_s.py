"""reconstruct_s (s an encode; layer dither and reconstruct:
pipeline/dither.py, reconstruct.py, ivf.py): the spans around dither and
reconstruct, mean over the encodes."""


def read(run):
    return run.span_mean("dither", "reconstruct")
