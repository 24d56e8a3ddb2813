"""The plain reference the benchmark judges tiler_tpu_torch's output by: a
GTM decoder (``gtm_decode.py`` with the LZMA decoder of ``lzma_dec.c``),
PSNR-HVS (``psnr_hvs.py``), Thomas Knoll's slot choice (``tk.py``),
float64 distances for the top-k kernel and the mesh's sharded top-k
(``knn.py``) and float64 EPU pair errors (``epu.py``). It imports nothing of
tiler_tpu_torch, tiler_tpu or jax, and takes nothing the program made but
the outputs it judges and, for the kernels and the sharded top-k, the
inputs they were given."""
