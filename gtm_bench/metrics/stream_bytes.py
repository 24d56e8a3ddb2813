"""stream_bytes (bytes, end to end): size of the window's first .gtm."""


def read(run):
    return run.quality.get("stream_bytes")
