"""Meshes of frames x row bands, and the sharded dense mode analysis.

Counterpart of hevc_hop_tpu/parallel/mesh.py. The reference lays its work
out on a ``jax.sharding.Mesh``: axis "frame" holds independent frames
(pure data parallelism), the inner axis ("row" here, "band" in
shard_encode.py) horizontal bands of CTU rows of one frame, and
neighbouring bands exchange a one-row halo with ``ppermute``. Here a
:class:`Mesh` is one of two things:

- **virtual**: no process group (or one of one rank). All the mesh's
  (frame, band) cells live in this process on one device, the card unless
  the caller asks for the CPU; a kernel launch serves every cell at once
  and a halo is an indexed copy on that device;
- **process**: a ``torch.distributed`` group of more than one rank, one
  cell per rank, laid out by ``init_device_mesh``; halos travel by
  point-to-point send and receive on the band group (NCCL between cards,
  gloo between CPU processes).

The analysis (:func:`analysis_step_sharded`) scores all 35 intra modes of
every n x n block against predictions from the ORIGINAL samples (the
encoder's dense mode pre-decision), each band seeing only its own rows and
the halo row above it. :func:`analysis_blocks` is the wrapper of kernel
C2's analysis entry (``csrc/intra.cu``, ``hh_intra_analysis``); on a CPU
tensor it runs :func:`analysis_blocks_plain`, a copy of the reference's
``analysis_costs`` math.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from hevc_hop_torch import _cuda
from hevc_hop_torch.device import resolve
from hevc_hop_torch.ops import intra
from hevc_hop_torch.ops.quant import argmin_first

# launches of C2's analysis entry
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (frames, bands) grid of cells. ``dist_mesh`` is the
    ``DeviceMesh`` of a process mesh (this rank holds one cell) and None
    for a virtual mesh (this process holds them all on ``device``)."""
    shape: tuple
    axis_names: tuple
    device: torch.device
    dist_mesh: object = None

    @property
    def virtual(self) -> bool:
        return self.dist_mesh is None

    @property
    def cell(self) -> tuple:
        """(frame, band) of this rank's cell in a process mesh."""
        return tuple(self.dist_mesh.get_local_rank(a)
                     for a in self.axis_names)

    def rank_of(self, frame: int, band: int) -> int:
        """Global rank of the cell (frame, band) in a process mesh."""
        return int(self.dist_mesh.mesh[frame, band])

    def group(self, axis: str):
        return self.dist_mesh.get_group(axis)


def build_mesh(n_devices, inner, default_inner, axis_names,
               device=None) -> Mesh:
    """The mesh of ``n_devices`` cells split ``inner`` ways along the inner
    axis (``default_inner(n)`` when None). With a process group of more
    than one rank the cells are its ranks, which must fill the mesh; with
    none they are virtual cells on ``resolve(device)`` (one cell by
    default)."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        n = dist.get_world_size()
        if n_devices is not None and n_devices != n:
            raise ValueError(f"a process mesh has one cell per rank: "
                             f"{n_devices} cells asked of {n} ranks")
    else:
        n = 1 if n_devices is None else n_devices
    inner = default_inner(n) if inner is None else inner
    if n < 1 or inner < 1 or n % inner:
        raise ValueError(f"{n} cells do not split into bands of {inner}")
    shape = (n // inner, inner)
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return Mesh(shape, tuple(axis_names), resolve(device))
    from torch.distributed.device_mesh import init_device_mesh
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "for a mesh of CPU processes")
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))
    return Mesh(shape, tuple(axis_names), dev, dm)


def make_mesh(n_devices: int | None = None, row_par: int | None = None,
              device=None) -> Mesh:
    """("frame", "row") mesh; by default two row bands where the cells are
    an even number of at least four, else one (the reference's rule)."""
    return build_mesh(n_devices, row_par,
                      lambda n: 2 if n % 2 == 0 and n >= 4 else 1,
                      ("frame", "row"), device)


# ---------------------------------------------------------------------------
# The dense analysis: the reference's math (plain) and kernel C2's entry.
# ---------------------------------------------------------------------------

def _block_chains(tile: torch.Tensor, halo_top: torch.Tensor, n: int,
                  bit_depth: int):
    """Chains [B, 4n+1] of every n x n block of a [H, W] tile, from an ext
    plane with the halo row on top and mid-grey on the left; the left
    column is clipped at the tile's last row and the top row at its last
    column (no substitution)."""
    h, w = tile.shape
    by, bx = h // n, w // n
    dev = tile.device
    ext = torch.full((h + 1, w + 1), 1 << (bit_depth - 1), dtype=tile.dtype,
                     device=dev)
    ext[1:, 1:] = tile
    ext[0, 1:] = halo_top
    ys = (torch.arange(by, device=dev) * n)[:, None].repeat(1, bx).reshape(
        -1) + 1
    xs = (torch.arange(bx, device=dev) * n)[None, :].repeat(by, 1).reshape(
        -1) + 1
    i = torch.arange(2 * n, device=dev)
    cyl = torch.clamp(ys[:, None] + 2 * n - 1 - i[None], max=h)
    cxl = (xs - 1)[:, None].repeat(1, 2 * n)
    cyc = (ys - 1)[:, None]
    cxc = (xs - 1)[:, None]
    cyt = (ys - 1)[:, None].repeat(1, 2 * n)
    cxt = torch.clamp(xs[:, None] + i[None], max=w)
    cy = torch.cat([cyl, cyc, cyt], 1)
    cx = torch.cat([cxl, cxc, cxt], 1)
    return ext[cy, cx]


def analysis_costs(frame: torch.Tensor, n: int = 16, bit_depth: int = 8,
                   halo_top: torch.Tensor | None = None) -> torch.Tensor:
    """SATD cost of each intra mode for every n x n block: [by, bx, 35]
    int32 (plain PyTorch, the reference's function)."""
    h, w = frame.shape
    if halo_top is None:
        halo_top = torch.full((w,), 1 << (bit_depth - 1), dtype=frame.dtype,
                              device=frame.device)
    chains = _block_chains(frame, halo_top, n, bit_depth)
    preds = intra.predict_all_modes(chains, n, 0, bit_depth, False)
    by, bx = h // n, w // n
    blocks = frame.reshape(by, n, bx, n).transpose(1, 2).reshape(-1, n, n)
    return intra.satd(blocks[:, None], preds).reshape(by, bx, 35)


def analysis_blocks_plain(frames, halo, band_h, n, bit_depth=8):
    """Plain version of :func:`analysis_blocks`: the reference's
    analysis_costs on each band of each frame, then the minimum and the
    first mode that reaches it."""
    nf, h, w = frames.shape
    costs = torch.cat([
        torch.stack([analysis_costs(frames[f, b * band_h:(b + 1) * band_h],
                                    n, bit_depth, halo[f, b])
                     for b in range(h // band_h)]).reshape(h // n, w // n,
                                                           35)[None]
        for f in range(nf)])
    return costs.min(-1).values, argmin_first(costs).to(torch.int32)


def analysis_blocks(frames: torch.Tensor, halo: torch.Tensor, band_h: int,
                    n: int, bit_depth: int = 8):
    """Kernel C2, analysis entry: the 35-mode SATD analysis of every n x n
    block of frames [F, H, W] int32 cut into row bands of ``band_h`` rows
    (a multiple of n dividing H), band b's halo being halo [F, H / band_h,
    W] row b. Returns (min cost, first mode reaching it), both [F, H/n,
    W/n] int32. On a CUDA tensor it launches the kernel; on a CPU tensor it
    runs :func:`analysis_blocks_plain`."""
    nf, h, w = frames.shape
    if n not in (4, 8, 16, 32) or band_h % n or h % band_h or w % n:
        raise ValueError("analysis_blocks: n in 4..32 must divide the band "
                         "height and the width, and bands the height")
    if tuple(halo.shape) != (nf, h // band_h, w):
        raise ValueError("analysis_blocks: halo must be [F, H / band_h, W]")
    if not frames.is_cuda:
        return analysis_blocks_plain(frames, halo, band_h, n, bit_depth)
    return _analysis_cuda(frames, halo, band_h, n, bit_depth)


def _analysis_cuda(frames, halo, band_h, n, bit_depth):
    global LAUNCHES
    from hevc_hop_torch.convert import device_tables
    for t, name in ((frames, "frames"), (halo, "halo")):
        if not (t.is_cuda and t.dtype == torch.int32 and t.is_contiguous()):
            raise ValueError(f"analysis_blocks: {name} must be a contiguous "
                             "CUDA int32 tensor")
    nf, h, w = frames.shape
    cost = torch.empty((nf, h // n, w // n), dtype=torch.int32,
                       device=frames.device)
    mode = torch.empty_like(cost)
    if cost.numel() == 0:
        return cost, mode
    ext_idx = device_tables(frames.device)[f"intra{n}_ext_idx"]
    fn = _cuda.bind("intra", "hh_intra_analysis", "pp" "iiiiii" "p" "pp"
                    "p")
    err = fn(frames.data_ptr(), halo.data_ptr(), nf, h, w, band_h, n,
             bit_depth, ext_idx.data_ptr(), cost.data_ptr(),
             mode.data_ptr(), _cuda.stream(frames))
    _cuda.check("intra", err)
    LAUNCHES += 1
    return cost, mode


def band_halos(frames: torch.Tensor, band_h: int,
               bit_depth: int) -> torch.Tensor:
    """[F, H / band_h, W]: each band's halo is the last original row of the
    band above it, and the first band's is mid-grey (the reference's
    cyclic ppermute, masked at band 0)."""
    nf, h, w = frames.shape
    grey = torch.full((nf, 1, w), 1 << (bit_depth - 1), dtype=frames.dtype,
                      device=frames.device)
    return torch.cat([grey, frames[:, band_h - 1:h - band_h:band_h]],
                     1).contiguous()


def analysis_step_sharded(frames, mesh: Mesh, n: int = 16,
                          bit_depth: int = 8):
    """Mesh-sharded mode analysis of frames [F, H, W]: frames split over
    "frame", rows over "row", each band receiving the row above it from
    the band above. Returns per-block (min cost, best mode), each [F, H/n,
    W/n] int32.

    Virtual mesh: one launch over every frame and band. Process mesh:
    ``frames`` is the whole [F, H, W] on every rank; this rank takes its
    cell's [F / frames, H / bands, W] and exchanges one halo with its
    neighbours, then launches on its slab; the result is this cell's
    [F / frames, H / bands / n, W / n] part."""
    frames = torch.as_tensor(frames).to(device=mesh.device,
                                        dtype=torch.int32)
    nf, h, w = frames.shape
    fpar, rpar = mesh.shape
    if nf % fpar or h % (rpar * n):
        raise ValueError(f"[{nf}, {h}, {w}] frames do not split over a "
                         f"{mesh.shape} mesh in blocks of {n}")
    band_h = h // rpar
    if mesh.virtual:
        return analysis_blocks(frames.contiguous(),
                               band_halos(frames, band_h, bit_depth),
                               band_h, n, bit_depth)
    f, r = mesh.cell
    fl = nf // fpar
    local = frames[f * fl:(f + 1) * fl,
                   r * band_h:(r + 1) * band_h].contiguous()
    halo = torch.full((fl, 1, w), 1 << (bit_depth - 1), dtype=torch.int32,
                      device=mesh.device)
    group, ops = mesh.group("row"), []
    if r + 1 < rpar:
        ops.append(dist.P2POp(dist.isend, local[:, -1].contiguous(),
                              mesh.rank_of(f, r + 1), group))
    if r > 0:
        ops.append(dist.P2POp(dist.irecv, halo.view(fl, w),
                              mesh.rank_of(f, r - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return analysis_blocks(local, halo, band_h, n, bit_depth)
