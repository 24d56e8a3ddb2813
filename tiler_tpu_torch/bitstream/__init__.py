"""The GTM bitstream writer and decoder, and the LZMA codec of its
keyframe streams (the port's own copies of ``tiler_tpu/bitstream``)."""
