"""psnr_hvs_db.wide (dB, end to end): psnr_hvs_db in the 16 x 256-colour
cell, whose quality varies with the seed several times as much as the
16-colour cells' and so takes a bound of its own."""


def read(run):
    return run.quality.get("psnr_hvs_db")
