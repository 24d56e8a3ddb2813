"""stream_bytes.wide (bytes, end to end): stream_bytes in the 16 x
256-colour cell, whose size varies with the seed several times as much as
the 16-colour cells' and so takes a bound of its own."""


def read(run):
    return run.quality.get("stream_bytes")
