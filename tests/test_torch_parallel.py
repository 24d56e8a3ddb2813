"""tiler_tpu_torch.parallel and the mesh encode against tiler_tpu's, on
the CPU.

The JAX side runs on 4 of the 8 virtual CPU devices that
tests/conftest.py forces (``tiler_tpu.parallel.make_mesh(4, ...)``); the
port's side on one local group of 4 gloo ranks, spawned once for the
module: every rank runs all the port's cases (:func:`_rank_cases`) and
sends its results back, while this process computes the JAX side. The
inputs come from numpy seeds. The children import this module, so jax
is imported only inside the fixtures here.

- sharded_topk: indices equal to the JAX package's except at float32
  near-ties, errors within 1e-4 relative; duplicated corpus rows across
  shards go to the lower global index in both.
- sharded_lloyd_step within 1e-5 relative of the JAX step; sharded_lloyd
  at 3 and 50 iterations equal to the port's own steps, bit for bit, on
  every rank; sharded_kmeans' centroids within 1e-5 relative of the JAX
  package's and its assignment equal but at near-ties.
- The data-parallel predict on a (2, 2) mesh (a 5-frame clip, so the
  frames pad) bit-identical to the single-device predict, with the frames
  on the device and on the host.
- Encodes on a (2, 2) mesh, default and epu_two_stage, within the
  end-to-end gate of the JAX package's encode on its (2, 2) mesh
  (docs/DETERMINISM.md: 0.1 dB RGB-PSNR, 2% bytes, every frame), every
  rank ending with the same state and the same stream statistics; a
  checkpoint after dither, written by rank 0 alone, resumes on every
  rank to the whole encode's stream.
- The CLI under torchrun (two CPU ranks, ``--mesh auto``).
"""
import multiprocessing
import subprocess
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tiler_tpu_torch.bitstream.gtm import GTMDecoder
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.models.convert import state_digest
from tiler_tpu_torch.parallel import kmeans as t_kmeans
from tiler_tpu_torch.parallel import mesh as t_mesh
from tiler_tpu_torch.parallel.knn import sharded_topk
from tiler_tpu_torch.pipeline import predict as t_predict
from tiler_tpu_torch.pipeline.encoder import Encoder, resolve_mesh
from tiler_tpu_torch.utils.clips import synthetic_clip

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
GROUP_TIMEOUT = 170.0  # seconds the group has for every case
CLIP = synthetic_clip(6, 64, 96, seed=0)
FPS = 25.0
SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)
ENCODES = {"default": {}, "two_stage": {"epu_two_stage": True}}
TOPK_K = 6
LLOYD_ITERS = (3, 50)


def _topk_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((40, 32)).astype(np.float32),
            rng.standard_normal((512, 32)).astype(np.float32))


def _tie_inputs():
    """Small integers (every distance exact in float32) with rows of the
    corpus repeated across the four shards of 16: each cell ties."""
    rng = np.random.default_rng(1)
    base = rng.integers(-3, 4, (8, 16)).astype(np.float32)
    ds = rng.integers(-3, 4, (64, 16)).astype(np.float32)
    for shard in range(4):
        ds[16 * shard + 3:16 * shard + 11] = base  # each shard holds all of base
    feats = np.concatenate([base, base + 1.0]).astype(np.float32)
    return feats, ds


def _lloyd_inputs():
    rng = np.random.default_rng(2)
    return (rng.standard_normal((800, 16)).astype(np.float32) * 4,
            rng.random(800).astype(np.float32),
            rng.standard_normal((10, 16)).astype(np.float32))


def _kmeans_inputs():
    """1,001 points (the shards pad to 1,004) in clusters, some weights 0."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((12, 8)).astype(np.float32) * 6
    pts = centers[rng.integers(0, 12, 1001)] + rng.standard_normal((1001, 8)).astype(np.float32)
    w = rng.integers(0, 4, 1001).astype(np.float32)
    return pts.astype(np.float32), w


KMEANS = dict(k=12, iters=20, seed=5)


def _shard(a, mesh, axis="corpus"):
    n = t_mesh.mesh_shape(mesh)[axis]
    per = len(a) // n
    i = mesh.get_local_rank(axis)
    return torch.as_tensor(a[i * per:(i + 1) * per])


def _rank_cases(rank: int, out_dir: str) -> dict:
    """Every port case on this rank of the 4-rank group."""
    res = {}
    mesh1 = t_mesh.make_mesh(WORLD, ("corpus",), device_type="cpu")
    mesh2 = t_mesh.make_mesh(WORLD, ("data", "corpus"), device_type="cpu")
    res["mesh_shapes"] = (t_mesh.mesh_shape(mesh1), t_mesh.mesh_shape(mesh2),
                          t_mesh.mesh_shape(resolve_mesh("auto", "cpu")))

    feats, ds = _topk_inputs()
    idx, err = sharded_topk(torch.as_tensor(feats), _shard(ds, mesh1), TOPK_K, mesh1)
    res["topk"] = (idx.numpy(), err.numpy())
    feats, ds = _tie_inputs()
    res["ties"] = sharded_topk(torch.as_tensor(feats), _shard(ds, mesh1), 4, mesh1)[0].numpy()

    pts, w, c0 = _lloyd_inputs()
    p, wl, c = _shard(pts, mesh1), _shard(w, mesh1), torch.as_tensor(c0)
    res["lloyd_step"] = t_kmeans.sharded_lloyd_step(p, wl, c, mesh1).numpy()
    for iters in LLOYD_ITERS:
        step = c
        for _ in range(iters):
            step = t_kmeans.sharded_lloyd_step(p, wl, step, mesh1)
        res[f"lloyd_{iters}"] = (t_kmeans.sharded_lloyd(p, wl, c, iters, mesh1).numpy(),
                                 step.numpy())
    pts, w = _kmeans_inputs()
    cents, assign, d2 = t_kmeans.sharded_kmeans(torch.as_tensor(pts), KMEANS["k"],
                                                weights=torch.as_tensor(w),
                                                iters=KMEANS["iters"], seed=KMEANS["seed"],
                                                mesh=mesh1)
    res["kmeans"] = (cents.numpy(), assign.numpy(), d2.numpy())

    for where, budget in (("device", 8e9), ("host", 1)):
        enc = Encoder(EncoderSettings(**SMALL, hbm_frames_budget=budget), log=None, mesh=mesh2)
        enc.load_frames(CLIP[:5], FPS)
        t_predict.predict_motion(enc.state, enc.settings, enc.device, mesh=mesh2)
        tm = enc.state.tilemap
        res[f"predict_{where}"] = (isinstance(enc.state.frames_rgb, np.ndarray),
                                   tm.pred_y.copy(), tm.pred_x.copy(), tm.psnr.copy())

    for name, overrides in ENCODES.items():
        path = f"{out_dir}/{name}.gtm"
        enc = Encoder(EncoderSettings(**SMALL, **overrides), log=None, mesh=mesh2)
        enc.run_all(CLIP, fps=FPS, out_path=path)
        res[f"encode_{name}"] = {"hash": state_digest(enc.state), "path": path,
                                 "bytes": enc.stats.total_bytes, "device": str(enc.device),
                                 "knn_kernel_cells": enc.step_stats["knn_kernel_cells"]}

    # a checkpoint after dither (rank 0 writes), resumed on every rank
    ckpt = f"{out_dir}/dither.ckpt"
    enc = Encoder(EncoderSettings(**SMALL), log=None, mesh=mesh2)
    enc.load_frames(CLIP, FPS).predict_motion().reduce().prepare_palettes().dither()
    writes = enc.writes
    enc.save_checkpoint(ckpt)
    enc = Encoder.load_checkpoint(ckpt, log=None, mesh=mesh2)
    enc.reconstruct().reindex().save(f"{out_dir}/resumed.gtm")
    res["resumed"] = {"hash": state_digest(enc.state), "path": f"{out_dir}/resumed.gtm",
                      "writes": writes}
    return res


def _rank_main(rank: int, port: int, out_dir: str, queue):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=WORLD, rank=rank,
                                timeout=timedelta(seconds=GROUP_TIMEOUT))
        try:
            queue.put((rank, _rank_cases(rank, out_dir), None))
        finally:
            dist.destroy_process_group()
    except Exception:  # the test process reports it
        queue.put((rank, None, traceback.format_exc()))


class _Group:
    """The 4 spawned ranks; :attr:`results` waits for them (once)."""

    def __init__(self, out_dir):
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        port = t_mesh.free_port()
        self.procs = [ctx.Process(target=_rank_main, args=(r, port, out_dir, self.queue))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self._results = None

    @property
    def results(self) -> list:
        if self._results is None:
            got = {}
            try:
                for _ in range(WORLD):
                    rank, res, err = self.queue.get(timeout=GROUP_TIMEOUT)
                    assert err is None, f"rank {rank} failed:\n{err}"
                    got[rank] = res
            finally:
                self.close()
            self._results = [got[r] for r in range(WORLD)]
        return self._results

    def close(self):
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = _Group(str(tmp_path_factory.mktemp("mesh")))
    yield g
    g.close()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's cases on its 4-device meshes."""
    import jax
    import jax.numpy as jnp

    from tiler_tpu.config import EncoderSettings as JaxSettings
    from tiler_tpu.parallel import make_mesh, sharded_lloyd_step
    from tiler_tpu.parallel import sharded_topk as j_topk
    from tiler_tpu.parallel.kmeans import sharded_kmeans
    from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder

    out = {}
    with jax.enable_x64(False):
        mesh1 = make_mesh(WORLD, ("corpus",))
        feats, ds = _topk_inputs()
        out["topk"] = tuple(np.asarray(a) for a in j_topk(jnp.asarray(feats), jnp.asarray(ds),
                                                          TOPK_K, mesh1))
        feats, ds = _tie_inputs()
        out["ties"] = np.asarray(j_topk(jnp.asarray(feats), jnp.asarray(ds), 4, mesh1)[0])
        pts, w, c0 = _lloyd_inputs()
        out["lloyd_step"] = np.asarray(sharded_lloyd_step(jnp.asarray(pts), jnp.asarray(w),
                                                          jnp.asarray(c0), mesh1))
        pts, w = _kmeans_inputs()
        out["kmeans"] = tuple(np.asarray(a) for a in sharded_kmeans(
            jnp.asarray(pts), KMEANS["k"], weights=jnp.asarray(w), iters=KMEANS["iters"],
            seed=KMEANS["seed"], mesh=mesh1))
        mesh2 = make_mesh(WORLD, ("data", "corpus"))
        d = tmp_path_factory.mktemp("jax_mesh")
        for name, overrides in ENCODES.items():
            enc = JaxEncoder(JaxSettings(**SMALL, **overrides), log=None, mesh=mesh2)
            enc.run_all(CLIP, fps=FPS, out_path=str(d / f"{name}.gtm"))
            out[f"encode_{name}"] = {"path": str(d / f"{name}.gtm"),
                                     "bytes": enc.stats.total_bytes}
    return out


def _d2(feats, ds):
    f, d = feats.astype(np.float64), ds.astype(np.float64)
    return (f * f).sum(1)[:, None] - 2 * f @ d.T + (d * d).sum(1)[None]


def _psnr_rgb(path):
    frames = np.stack(GTMDecoder(path).decode_frames())[..., :3]
    assert frames.shape == CLIP.shape  # every frame
    mse = np.mean((frames.astype(np.float64) - CLIP) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("axes", [("corpus",), ("data", "corpus")])
def test_mesh_dims_are_the_jax_split(n, axes):
    from tiler_tpu.parallel import make_mesh

    assert t_mesh.mesh_dims(n, axes) == tuple(make_mesh(n, axes).shape.values())


def test_make_mesh_in_a_group_of_one():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{t_mesh.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = t_mesh.make_mesh(1, ("data", "corpus"), device_type="cpu")
        assert t_mesh.mesh_shape(mesh) == {"data": 1, "corpus": 1}
        assert resolve_mesh("auto", "cpu") is None  # one rank: no mesh
        with pytest.raises(ValueError, match="every rank is one device"):
            t_mesh.make_mesh(4, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_auto_mesh_is_none_without_a_group():
    enc = Encoder(EncoderSettings(**SMALL), log=None, device="cpu", mesh="auto")
    assert enc.mesh is None and enc.device.type == "cpu"


def test_make_mesh_in_the_group(group):
    for res in group.results:
        assert res["mesh_shapes"] == ({"corpus": 4}, {"data": 2, "corpus": 2}, {"corpus": 4})


def test_sharded_topk_matches_jax(group, jax_ref):
    feats, ds = _topk_inputs()
    d2 = _d2(feats, ds)
    want_idx, want_err = jax_ref["topk"]
    for res in group.results:
        idx, err = res["topk"]
        np.testing.assert_allclose(err, want_err, rtol=1e-4, atol=1e-4)
        rows, cols = np.nonzero(idx != want_idx)
        # where the picks differ, they are float32 near-ties
        gap = np.abs(d2[rows, idx[rows, cols]] - d2[rows, want_idx[rows, cols]])
        assert np.all(gap <= 1e-4 * np.abs(d2[rows]).max(axis=1)), (rows, cols)
        assert np.array_equal(res["topk"][0], group.results[0]["topk"][0])


def test_sharded_topk_ties_go_to_the_lower_index(group, jax_ref):
    for res in group.results:
        assert np.array_equal(res["ties"], jax_ref["ties"])
    # the first 8 cells each equal one row that every shard holds
    assert np.array_equal(jax_ref["ties"][:8, 0], np.arange(8) + 3)


def test_sharded_lloyd_step_matches_jax(group, jax_ref):
    want = jax_ref["lloyd_step"]
    for res in group.results:
        np.testing.assert_allclose(res["lloyd_step"], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("iters", LLOYD_ITERS)
def test_sharded_lloyd_equals_its_steps_on_every_rank(group, iters):
    """Past convergence too (50): the early exit is in step on every rank."""
    fused0 = group.results[0][f"lloyd_{iters}"][0]
    for res in group.results:
        fused, steps = res[f"lloyd_{iters}"]
        assert np.array_equal(fused, steps) and np.array_equal(fused, fused0)


def test_sharded_kmeans_matches_jax(group, jax_ref):
    pts, _ = _kmeans_inputs()
    want_c, want_a, _ = jax_ref["kmeans"]
    for res in group.results:
        cents, assign, d2 = res["kmeans"]
        np.testing.assert_allclose(cents, want_c, rtol=1e-5, atol=1e-5 * np.abs(want_c).max())
        dist64 = _d2(pts, want_c)
        rows = np.flatnonzero(assign != want_a)
        gap = np.abs(dist64[rows, assign[rows]] - dist64[rows, want_a[rows]])
        assert np.all(gap <= 1e-4 * dist64[rows].max(axis=1)), rows
        assert assign.shape == d2.shape == (len(pts),)
        assert np.array_equal(assign, group.results[0]["kmeans"][1])


@pytest.mark.parametrize("where", ["device", "host"])
def test_predict_dp_is_bitwise_the_single_device_predict(group, where):
    enc = Encoder(EncoderSettings(**SMALL), log=None, device="cpu")
    enc.load_frames(CLIP[:5], FPS).predict_motion()
    tm = enc.state.tilemap
    for res in group.results:
        host, y, x, psnr = res[f"predict_{where}"]
        assert host == (where == "host")
        assert np.array_equal(y, tm.pred_y) and np.array_equal(x, tm.pred_x)
        assert np.array_equal(psnr.view(np.int32), tm.psnr.view(np.int32))


@pytest.mark.parametrize("name", list(ENCODES))
def test_mesh_encode_within_the_gate_of_the_jax_mesh_encode(group, jax_ref, name):
    got, want = group.results[0][f"encode_{name}"], jax_ref[f"encode_{name}"]
    assert got["device"] == "cpu" and got["knn_kernel_cells"] == 0
    assert abs(_psnr_rgb(got["path"]) - _psnr_rgb(want["path"])) <= 0.1
    assert abs(got["bytes"] - want["bytes"]) <= 0.02 * want["bytes"]


@pytest.mark.parametrize("name", list(ENCODES))
def test_every_rank_ends_with_the_same_state(group, name):
    runs = [res[f"encode_{name}"] for res in group.results]
    assert len({r["hash"] for r in runs}) == 1
    assert len({r["bytes"] for r in runs}) == 1  # rank 0's statistics everywhere


def test_mesh_checkpoint_resumes_on_every_rank(group):
    """A checkpoint after dither, written by rank 0 alone and resumed on
    every rank of the mesh: the stream of the whole mesh encode."""
    whole = group.results[0]["encode_default"]
    assert [res["resumed"]["writes"] for res in group.results] == [True, False, False, False]
    for res in group.results:
        assert res["resumed"]["hash"] == whole["hash"]
    with open(group.results[0]["resumed"]["path"], "rb") as a, open(whole["path"], "rb") as b:
        assert a.read() == b.read()


def test_cli_under_torchrun_on_the_cpu(tmp_path):
    """The launch a node of several cards uses, on two CPU ranks:
    torchrun starts the CLI with --mesh auto, the group comes from
    torchrun's environment, rank 0 alone writes the stream and the
    checkpoint, and both ranks report the same statistics."""
    from tiler_tpu_torch.io.export import write_y4m

    src, out, ck = tmp_path / "clip.y4m", tmp_path / "out.gtm", tmp_path / "out.ckpt"
    write_y4m(str(src), list(CLIP), FPS)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tiler_tpu_torch", "encode", "-i", str(src), "-o", str(out), "--device", "cpu",
         "--mesh", "auto", "--palette-count", "8", "--radius", "4", "--checkpoint", str(ck)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    written = [line for line in run.stdout.splitlines() if line.startswith("written ")]
    assert len(written) == 2 and written[0] == written[1]
    assert f"written {out.stat().st_size} bytes" in written[0]
    assert len(GTMDecoder(str(out)).decode_frames()) == len(CLIP)
    assert ck.stat().st_size > 0
