"""psnr_hvs_db (dB, end to end): PSNR-HVS of the window's first stream as
the plain decoder rebuilds it, against the source clip
(reference/psnr_hvs.py)."""


def read(run):
    return run.quality.get("psnr_hvs_db")
