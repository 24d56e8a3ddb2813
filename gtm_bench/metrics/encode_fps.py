"""encode_fps (frames/s, end to end, host clock): frames of every encode
the window ran, over the seconds from its start to its last encode's end."""


def read(run):
    n = len(run.encodes)
    return n * run.frames / run.window.seconds if n else None
