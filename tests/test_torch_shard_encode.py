"""The mesh-sharded slice on the CPU: hevc_hop_torch.parallel against
hevc_hop_tpu.parallel.

- build_banded_schedule's arrays equal the reference's (numpy both sides);
- MeshIntraEncoder on a virtual (2 frames, 4 bands) mesh writes the
  reference MeshIntraEncoder's streams (make_mesh(8) on the 8 virtual host
  devices of tests/conftest.py) byte for byte, with equal recon, equal to
  the port's single-device IntraEncoder, decoded by the port's Decoder
  with hash_ok;
- the process mesh: four gloo ranks spawned with torch.multiprocessing
  (file:// rendezvous, no network) in the layouts (2, 2) and (1, 4) write
  the virtual mesh's streams, and every band below the first received one
  halo per level;
- sao=True and wpp=True are refused, where the reference writes a stream
  its own decoder rejects (R7, R8);
- mesh.py: the plain analysis_costs equals the reference's, and
  analysis_step_sharded on a virtual (4, 2) mesh and over two gloo ranks
  equals the reference's on make_mesh(8).
"""
import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax.numpy as jnp
from hevc_hop_tpu.models import wavefront as jwf
from hevc_hop_tpu.models.decoder import Decoder as JaxDecoder
from hevc_hop_tpu.models.encoder import EncoderConfig as JaxConfig
from hevc_hop_tpu.parallel import mesh as jmesh
from hevc_hop_tpu.parallel import shard_encode as jshard
from hevc_hop_torch.models import wavefront
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
from hevc_hop_torch.parallel import mesh, shard_encode

W, H = 64, 128
BASE = dict(width=W, height=H, qp=30, cu_log2=4, sao=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(count, bit_depth=8, seed=7, w=W, h=H):
    rng = np.random.default_rng(seed)
    top = 1 << bit_depth
    return [(rng.integers(0, top, (h, w)).astype(np.int32),
             rng.integers(0, top, (h // 2, w // 2)).astype(np.int32),
             rng.integers(0, top, (h // 2, w // 2)).astype(np.int32))
            for _ in range(count)]


# ---------------------------------------------------------------------------
# The banded schedule.

@pytest.mark.parametrize("w,h,cu,bands", [
    (64, 128, 4, 4), (64, 128, 3, 2), (1920, 1088, 4, 2),
    (1920, 1088, 4, 17)], ids=["64x128-cu16-4bands", "64x128-cu8-2bands",
                               "1080p-cu16-2bands", "1080p-cu16-17bands"])
def test_banded_schedule_matches_reference(w, h, cu, bands):
    depth8 = np.full((h // 8, w // 8), 5 - cu, np.uint8)
    leaves = wavefront.leaves_from_depth(depth8, w, h, 5)
    assert leaves == jwf.leaves_from_depth(depth8, w, h, 5)
    got = shard_encode.build_banded_schedule(leaves, w, h, 5, bands)
    want = jshard.build_banded_schedule(leaves, w, h, 5, bands)
    assert got[0] == want[0] and got[2:] == want[2:]
    for log2 in want[0]:
        assert got[1][log2].keys() == want[1][log2].keys()
        for k, v in want[1][log2].items():
            np.testing.assert_array_equal(got[1][log2][k], v, err_msg=k)


def test_bands_must_be_whole_ctu_rows():
    depth8 = np.full((H // 8, W // 8), 1, np.uint8)
    leaves = wavefront.leaves_from_depth(depth8, W, H, 5)
    with pytest.raises(ValueError, match="CTU-row"):
        shard_encode.build_banded_schedule(leaves, W, H, 5, 3)
    with pytest.raises(ValueError, match="CTU rows"):
        shard_encode.MeshIntraEncoder(
            EncoderConfig(**dict(BASE, height=96)),
            shard_encode.make_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="cu_log2"):
        shard_encode.MeshIntraEncoder(
            EncoderConfig(**dict(BASE, cu_log2=None)),
            shard_encode.make_mesh(8, device="cpu"))


# ---------------------------------------------------------------------------
# The virtual mesh against the reference.

CASES = {"base": {}, "no-rdoq": dict(rdoq=False),
         "10bit": dict(bit_depth=10), "no-deblocking": dict(deblocking=False)}


@pytest.mark.parametrize("case", list(CASES))
def test_virtual_mesh_matches_reference(case):
    kw = dict(BASE, **CASES[case])
    frames = _frames(2, kw.get("bit_depth", 8))
    ref = jshard.MeshIntraEncoder(JaxConfig(**kw), jshard.make_mesh(8))
    want = ref.encode_frames(frames)
    mesh_ = shard_encode.make_mesh(8, device="cpu")
    assert mesh_.shape == (2, 4) and mesh_.virtual
    enc = shard_encode.MeshIntraEncoder(EncoderConfig(**kw), mesh_)
    got = enc.encode_frames(frames)
    single = IntraEncoder(EncoderConfig(**kw), device="cpu")
    for f, frame in enumerate(frames):
        assert got[f] == want[f], f"frame {f}"
        for g, r, nm in zip(enc.last_recons[f], ref.last_recons[f],
                            ("y", "cb", "cr")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=nm)
        assert single.encode_frame(*frame) == got[f]
        dec = Decoder(device="cpu")
        (pic,) = dec.decode_stream(got[f])
        assert dec.hash_ok == [True]
        for a, b in zip(pic, enc.last_recons[f]):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("flag", ["sao", "wpp"])
def test_refused_where_reference_stream_fails_its_decoder(flag):
    """R7 (sao=True) and R8 (wpp=True): the reference's mesh encoder
    writes a stream its own decoder rejects; the port refuses both."""
    kw = dict(BASE, **{flag: True})
    with pytest.raises(ValueError, match=flag):
        shard_encode.MeshIntraEncoder(EncoderConfig(**kw),
                                      shard_encode.make_mesh(8, device="cpu"))
    stream = jshard.MeshIntraEncoder(
        JaxConfig(**kw), jshard.make_mesh(8)).encode_frames(_frames(2))[0]
    with pytest.raises((RuntimeError, AssertionError),
                       match="desync" if flag == "sao" else "entry point"):
        JaxDecoder().decode_stream(stream)


def test_mesh_writes_the_checksum_sei_whatever_hash_type():
    """R9: the reference's mesh encoder ignores hash_type and writes the
    checksum SEI; the port does the same, which byte identity needs."""
    kw = dict(BASE, hash_type=0)               # MD5 asked for
    frames = _frames(2)
    want = jshard.MeshIntraEncoder(
        JaxConfig(**kw), jshard.make_mesh(8)).encode_frames(frames)
    got = shard_encode.MeshIntraEncoder(
        EncoderConfig(**kw),
        shard_encode.make_mesh(8, device="cpu")).encode_frames(frames)
    assert got == want
    assert got == shard_encode.MeshIntraEncoder(
        EncoderConfig(**BASE),
        shard_encode.make_mesh(8, device="cpu")).encode_frames(frames)


# ---------------------------------------------------------------------------
# The process mesh: gloo ranks on the CPU.

SPAWN_TIMEOUT_S = 180


def _spawn(fn, world, tmp_path, *args):
    """Run fn(rank, world, rendezvous, out_dir, *args) on ``world`` spawned
    processes, killed after SPAWN_TIMEOUT_S; returns each rank's pickled
    result."""
    rdzv = tmp_path / "rdzv"
    ctx = mp.spawn(fn, args=(world, str(rdzv), str(tmp_path)) + args,
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the ranks did not finish in {SPAWN_TIMEOUT_S} s")
    assert not any(proc.is_alive() for proc in ctx.processes)
    out = []
    for rank in range(world):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _init(rank, world, rdzv):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def _encode_worker(rank, world, rdzv, out_dir, shape, cfg_kw, frames):
    _init(rank, world, rdzv)
    try:
        mesh_ = shard_encode.make_mesh(band_par=shape[1], device="cpu")
        assert mesh_.shape == tuple(shape) and not mesh_.virtual
        enc = shard_encode.MeshIntraEncoder(EncoderConfig(**cfg_kw), mesh_)
        streams = enc.encode_frames(frames)
        recons = [None if r is None else [p.numpy() for p in r]
                  for r in enc.last_recons]
        result = dict(cell=mesh_.cell, streams=streams, recons=recons,
                      halo=enc.last_halo_rows, nsteps=enc._built[3])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_process_mesh_matches_virtual_mesh(shape, tmp_path):
    frames = _frames(shape[0])
    virt = shard_encode.MeshIntraEncoder(
        EncoderConfig(**BASE),
        shard_encode.make_mesh(shape[0] * shape[1], band_par=shape[1],
                               device="cpu"))
    want = virt.encode_frames(frames)
    results = _spawn(_encode_worker, 4, tmp_path, shape, BASE, frames)
    cells = set()
    for res in results:
        f, r = res["cell"]
        cells.add((f, r))
        assert res["streams"] == want
        assert res["halo"] == {(f, r): res["nsteps"] if r else 0}
        assert res["nsteps"] > 0
        if r == 0:
            for g, v in zip(res["recons"][f], virt.last_recons[f]):
                np.testing.assert_array_equal(g, v.numpy())
        else:
            assert all(x is None for x in res["recons"])
    assert cells == {(f, r) for f in range(shape[0]) for r in range(shape[1])}


# ---------------------------------------------------------------------------
# mesh.py: the dense analysis.

@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_analysis_costs_match_reference(n, bit_depth):
    rng = np.random.default_rng(n + bit_depth)
    frame = rng.integers(0, 1 << bit_depth, (64, 96)).astype(np.int32)
    halo = rng.integers(0, 1 << bit_depth, 96).astype(np.int32)
    for top in (None, halo):
        want = jmesh.analysis_costs(
            jnp.asarray(frame), n, bit_depth,
            None if top is None else jnp.asarray(top))
        got = mesh.analysis_costs(
            torch.as_tensor(frame), n, bit_depth,
            None if top is None else torch.as_tensor(top))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _analysis_frames(bit_depth=8):
    rng = np.random.default_rng(3)
    return rng.integers(0, 1 << bit_depth, (4, 64, 64)).astype(np.int32)


@pytest.mark.parametrize("n", [4, 16])
def test_analysis_step_sharded_matches_reference(n):
    frames = _analysis_frames()
    want = jmesh.analysis_step_sharded(jnp.asarray(frames),
                                       jmesh.make_mesh(8), n)
    mesh_ = mesh.make_mesh(8, device="cpu")
    assert mesh_.shape == (4, 2) and mesh_.axis_names == ("frame", "row")
    got = mesh.analysis_step_sharded(frames, mesh_, n)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _analysis_worker(rank, world, rdzv, out_dir, frames, n):
    _init(rank, world, rdzv)
    try:
        try:
            shard_encode.make_mesh(2 * world, device="cpu")
            refused = False
        except ValueError:       # a process mesh has one cell per rank
            refused = True
        mesh_ = mesh.make_mesh(row_par=2, device="cpu")
        got = mesh.analysis_step_sharded(frames, mesh_, n)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((refused, mesh_.cell, [g.numpy() for g in got]), f)
    finally:
        dist.destroy_process_group()


def test_analysis_step_sharded_over_two_ranks(tmp_path):
    """(1 frame group, 2 row bands) over two gloo ranks: each rank's band
    equals that band of the reference's result on make_mesh(8), whose
    row bands split the frames the same way. A mesh of more cells than
    ranks is refused."""
    frames = _analysis_frames()
    want = jmesh.analysis_step_sharded(jnp.asarray(frames),
                                       jmesh.make_mesh(8), 8)
    by = frames.shape[1] // 8
    for refused, (f, r), got in _spawn(_analysis_worker, 2, tmp_path,
                                       frames, 8):
        assert refused and f == 0
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(
                g, np.asarray(w_)[:, r * by // 2:(r + 1) * by // 2])


def test_analysis_blocks_checks_shapes():
    frames = torch.zeros((1, 64, 64), dtype=torch.int32)
    halo = mesh.band_halos(frames, 32, 8)
    assert halo.shape == (1, 2, 64)
    with pytest.raises(ValueError):
        mesh.analysis_blocks(frames, halo, 24, 8)
    with pytest.raises(ValueError):
        mesh.analysis_blocks(frames, halo[:, :1], 32, 8)
    assert mesh.make_mesh(device="cpu").shape == (1, 1)
