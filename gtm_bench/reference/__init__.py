"""The plain reference the benchmark judges tiler_tpu_torch's output by: a
GTM decoder (``gtm_decode.py`` with the LZMA decoder of ``lzma_dec.c``),
PSNR-HVS (``psnr_hvs.py``), Thomas Knoll's slot choice (``tk.py``) and
float64 distances for the top-k kernel (``knn.py``). It imports nothing of
tiler_tpu_torch, tiler_tpu or jax, and takes nothing the program made but
the outputs it judges and, for the kernels, the inputs they were given."""
