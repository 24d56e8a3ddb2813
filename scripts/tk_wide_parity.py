#!/usr/bin/env python3
"""tk_select's plain version (the port's reference for its wide CUDA
kernel) against the JAX package's Pallas kernel in interpret mode, on
the CPU, at palette sizes the test suite leaves out for time.

    JAX_PLATFORMS=cpu python3 scripts/tk_wide_parity.py 256 [128 ...]

For each S: the adversarial tiles of ``kernels/tk_dither.py::
adversarial_case(S, seed=S, reps=1)`` through both, bit-identical or
exit 1; prints the seconds the Pallas kernel took (its interpret-mode
compile unrolls the color scan over S and dominates) and the plain
version's. Imports both packages, as the tests do.
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
from tiler_tpu.kernels import tk_dither as j_tk  # noqa: E402
from tiler_tpu.pipeline import dither as j_dither  # noqa: E402
from tiler_tpu_torch.kernels import tk_dither as t_tk  # noqa: E402


def check(S: int) -> bool:
    pix, mirror, pidx, pal, valid = t_tk.adversarial_case(S, seed=S, reps=1)
    T = len(pix)
    hm, vm = (mirror & 1) != 0, (mirror & 2) != 0
    bay = np.broadcast_to(j_dither.BAYER8, (T, 8, 8))
    bay = np.where(hm[:, None, None], bay[:, :, ::-1], bay)
    bay = np.where(vm[:, None, None], bay[:, ::-1, :], bay)
    t0 = time.monotonic()
    with jax.enable_x64(False):
        want = np.asarray(j_tk.tk_dither_pallas(
            jnp.asarray(pix.reshape(T, 8, 8, 3)), jnp.asarray(pidx), jnp.asarray(pal),
            jnp.asarray(valid), jnp.asarray(bay), interpret=True)).reshape(T, 64)
    t1 = time.monotonic()
    table = t_tk.pal_table(torch.as_tensor(pal), torch.as_tensor(valid))
    got = t_tk.tk_select_plain(torch.as_tensor(pix), torch.as_tensor(mirror),
                               torch.as_tensor(pidx), table).numpy()
    t2 = time.monotonic()
    same = np.array_equal(got, want)
    print(f"S={S}: {T} adversarial tiles, Pallas (interpret) {t1 - t0:.1f} s, plain "
          f"{t2 - t1:.2f} s: {'bit-identical' if same else 'DIFFERENT'}", flush=True)
    return same


if __name__ == "__main__":
    sizes = [int(a) for a in sys.argv[1:]] or [256]
    sys.exit(0 if all([check(S) for S in sizes]) else 1)
