"""CU quadtree partition and mode decision: the RD pre-pass; kernel C5.

Counterpart of hevc_hop_tpu/models/partition.py. For every n x n block of
the ORIGINAL luma plane (n = 4, 8, 16, 32) :func:`rd_costs` predicts all 35
intra modes from original-pixel references, keeps the three lowest-SATD
modes, codes each through transform, quantizer and back, and returns the
lowest cost ``SSE + lambda * bits`` with its mode; :func:`rd_costs_forced`
does the same for one given mode per block (the sub-TU arm of the residual
quadtree). :func:`decide`, :func:`decide_nxn` and :func:`decide_rqt` are the
bottom-up choice over the quadtree, NxN at 8x8 and one TU split at 16x16 and
32x32. On a CUDA tensor each launches kernel C5 (``csrc/partition.cu``); on a
CPU tensor it runs its ``*_plain`` version, which runs on any device.

The pre-pass references are not the scan's: a mid-grey row and column lie
above and to the left of the picture, coordinates clamp at its bottom and
right, every sample counts as available (no substitution) and the smoothing
is never the strong one.

Float rules. The decisions compare float32 costs, so both bodies fix every
rounding, and fix it as the reference's compiled program was measured to
round on the CPU (tests/test_torch_partition.py holds the decision's
expressions against it to the last bit):

- a block's ``bits`` are summed over its samples one after another in
  raster order, starting from the first sample, each sum rounded to
  float32; its ``dist`` (squares of integers, every order exact below
  2**24) in the order of the reference's compiled reduction
  (:func:`block_dist`), which differs between the two arms at 32x32;
- ``dist + lam * bits`` is ONE fused multiply-add (the reference's compiler
  contracts it): ``fmaf`` in the kernel, a float64 product and sum rounded
  once to float32 in the plain version;
- ``log2`` is the correctly rounded one (``torch.log2``, CUDA's ``log2f``);
  the reference's differs from it in the last bit at about a third of the
  integers, which moves a cost by about ``lam * 2**-22``;
- the four costs of a split are added ``((a00 + a01) + a10) + a11``. The
  reference's compiler emits this order for every grid whose width is not a
  power of two (all of 1920x1088's), and ``(a00 + a01) + (a10 + a11)`` where
  it is one (a 64x64 picture): there the two can differ in the last bit;
- Python-float constants (``lam * MODE_BITS``, ...) are computed in double
  and rounded to float32; where the reference adds two of them one after
  the other to an array, its compiler folds them into one float32 constant
  first (``x + c1 + c2`` is ``x + (c1 + c2)``), and so do both bodies;
- the top three keep the lower mode first among equal SATDs, and a cost wins
  only when strictly lower (``<=`` where the reference has ``<=``).
"""
from __future__ import annotations

import math

import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.ops import intra, quant, transform
from hevc_hop_torch.ops.quant import argmin_first
from hevc_hop_torch.ops.ss_search import lane_block_sum

# one count per kernel of csrc/partition.cu
RD_LAUNCHES = 0
DECIDE_LAUNCHES = 0

MODE_BITS = 6.0    # approx: prev_intra_flag + 5-bit rem (MPM ignored here)
SPLIT_BITS = 2.0
TUSPLIT_BITS = 4.0   # split_transform_flag + 3 extra cbf bins
TOP_K = 3

# the plain rd_costs holds [B, 35, n, n] int32 per chunk of B blocks
_PLAIN_CHUNK_ELEMS = 1 << 22


def rmd_lambda(qp: int) -> float:
    return math.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0))


def full_lambda(qp: int) -> float:
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def _f32(v: float) -> float:
    """v rounded to float32 (as a Python float)."""
    return torch.tensor(v, dtype=torch.float32).item()


# ---------------------------------------------------------------------------
# rd_costs: plain version.
# ---------------------------------------------------------------------------

def _chains(y: torch.Tensor, idx: torch.Tensor, n: int, bit_depth: int):
    """[B, 4n+1] reference chains and [B, n, n] samples of the blocks with
    raster index idx [B] of the n x n grid over y [h, w] int32."""
    h, w = y.shape
    dev = y.device
    bx = w // n
    ext = torch.full((h + 1, w + 1), 1 << (bit_depth - 1), dtype=torch.int32,
                     device=dev)
    ext[1:, 1:] = y
    ys = (idx // bx) * n + 1
    xs = (idx % bx) * n + 1
    i = torch.arange(2 * n, device=dev)
    cyl = torch.clamp(ys[:, None] + 2 * n - 1 - i[None], max=h)
    cxl = (xs - 1)[:, None].expand(-1, 2 * n)
    cy = torch.cat([cyl, (ys - 1)[:, None],
                    (ys - 1)[:, None].expand(-1, 2 * n)], 1)
    cx = torch.cat([cxl, (xs - 1)[:, None],
                    torch.clamp(xs[:, None] + i[None], max=w)], 1)
    rows = (ys - 1)[:, None, None] + i[None, :n, None]
    cols = (xs - 1)[:, None, None] + i[None, None, :n]
    return ext[cy, cx], y[rows, cols]


def _tq_cost(resi: torch.Tensor, n: int, qp: int, bit_depth: int,
             arm: str | None = None):
    """float32 RD cost of coding each residual block [B, n, n] int32 as one
    TU: SSE after recon plus lambda times the level-rate proxy; ``arm`` is
    :func:`block_dist`'s."""
    log2 = n.bit_length() - 1
    use_dst = n == 4      # 4x4 intra luma codes through the DST
    coef = transform.fwd_transform(resi, bit_depth, use_dst)
    lev = quant.quant(coef, qp, log2, bit_depth, True)
    rq = transform.inv_transform(quant.dequant(lev, qp, log2, bit_depth),
                                 bit_depth, use_dst)
    dist = block_dist((resi - rq).flatten(1), n, arm)
    # rate proxy: per-nonzero cost ~ 3 + 2*log2(|level|), + per-TU overhead
    a = torch.abs(lev).to(torch.float32).flatten(1)
    zero = torch.zeros((), dtype=torch.float32, device=resi.device)
    bits = block_bits(torch.where(a > 0, 3.0 + 2.0 * torch.log2(a + 1.0),
                                  zero))
    nz_any = (lev != 0).flatten(1).any(1)
    ten = torch.full((), 10.0, dtype=torch.float32, device=resi.device)
    bits = bits + torch.where(nz_any, ten, 1.0)  # last-pos/CG vs cbf=0
    # one fused multiply-add: the float64 product is exact, its sum is
    # rounded to float64 and then to float32
    lam = _f32(full_lambda(qp))
    return (dist.double() + lam * bits.double()).float()


# rd_costs' and rd_costs_forced's order of a 32x32 row's four chunks
ROW32_ORDER = {"rd": (0, 2, 3, 1), "forced": (0, 1, 2, 3)}


def block_dist(err: torch.Tensor, n: int, arm: str | None = None):
    """float32 SSE of each block's integer errors err [B, n*n] in the order
    of the reference's compiled reduction for ``arm`` ("rd": rd_costs,
    "forced": rd_costs_forced), read from XLA:CPU's machine code (ROADMAP.md
    queue 3, F12):

    - n = 8, 16: eight lanes, lane l adding rows l, l + 8 in row-major order,
      then the lanes by halves (ops/ss_search.py ``lane_block_sum``);
    - n = 32: row by row, the running sum entering lane 0 of an eight-lane
      vector to which the row's chunks (samples 8k .. 8k + 7) are added in
      ``ROW32_ORDER[arm]``, then ``fold_lanes`` (ops/quant.py);
    - n = 4, and ``arm`` None (the ISS pre-pass, models/ss_partition.py):
      one rounded add after another in raster order.

    Below 2**24 every partial sum is an exact integer in any order."""
    e = err.to(torch.float32)
    sq = e * e
    if arm is None or n == 4:
        return quant.seq_sum(sq)
    if n < 32:
        return lane_block_sum(sq.reshape(-1, n, n))
    order = ROW32_ORDER[arm]
    chunks = sq.reshape(-1, n, n // 8, 8)
    acc = torch.zeros(sq.shape[0], dtype=torch.float32, device=sq.device)
    for r in range(n):
        v = chunks[:, r, order[0]].clone()
        v[:, 0] = acc + v[:, 0]
        for k in order[1:]:
            v = v + chunks[:, r, k]
        acc = quant.fold_lanes(v)
    return acc


def block_bits(terms: torch.Tensor) -> torch.Tensor:
    """float32 sum of each block's rate terms [B, nn] in raster order."""
    return quant.seq_sum(terms)


def rd_costs_plain(y: torch.Tensor, n: int, qp: int, bit_depth: int = 8,
                   modes: torch.Tensor | None = None):
    """Plain version of :func:`rd_costs` (``modes`` None) and of
    :func:`rd_costs_forced` (``modes`` [by, bx]): returns (cost, mode)."""
    h, w = y.shape
    by, bx = h // n, w // n
    y = y.to(torch.int32)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (35 * n * n))
    costs, best = [], []
    for b0 in range(0, by * bx, chunk):
        idx = torch.arange(b0, min(b0 + chunk, by * bx), device=y.device)
        chains, blocks = _chains(y, idx, n, bit_depth)
        if modes is not None:
            m = modes.reshape(-1)[idx].to(torch.int32)
            pred = intra.predict_mode(chains, m, n, 0, bit_depth, False)
            costs.append(_tq_cost(blocks - pred, n, qp, bit_depth,
                                   "forced"))
            best.append(m)
            continue
        preds = intra.predict_all_modes(chains, n, 0, bit_depth, False)
        satd = intra.satd(blocks[:, None], preds)
        # the three lowest SATDs, the lower mode first among equals
        cand = torch.sort(satd, dim=1, stable=True).indices[:, :TOP_K]
        cpred = torch.gather(preds, 1, cand[:, :, None, None].expand(
            -1, -1, n, n))
        resi = (blocks[:, None] - cpred).reshape(-1, n, n)
        costk = _tq_cost(resi, n, qp, bit_depth, "rd").reshape(-1, TOP_K)
        ki = argmin_first(costk)
        costs.append(torch.gather(costk, 1, ki[:, None])[:, 0])
        best.append(torch.gather(cand, 1, ki[:, None])[:, 0].to(torch.int32))
    return (torch.cat(costs).reshape(by, bx),
            torch.cat(best).reshape(by, bx))


# ---------------------------------------------------------------------------
# rd_costs: dispatch and kernel C5's first entry.
# ---------------------------------------------------------------------------

def _check_grid(y, n):
    if y.dim() != 2 or n not in (4, 8, 16, 32) or y.shape[0] % n \
            or y.shape[1] % n:
        raise ValueError("rd_costs: a [h, w] plane of whole n x n blocks, "
                         "n in 4, 8, 16, 32")


def _rd(y, n, qp, bit_depth, modes):
    _check_grid(y, n)
    if modes is not None and tuple(modes.shape) != (y.shape[0] // n,
                                                    y.shape[1] // n):
        raise ValueError("rd_costs_forced: one mode per n x n block")
    if not y.is_cuda:
        return rd_costs_plain(y, n, qp, bit_depth, modes)
    return _rd_cuda(y, n, qp, bit_depth, modes)


def rd_costs(y: torch.Tensor, n: int, qp: int, bit_depth: int = 8):
    """True-RD cost of every n x n block of the plane y [h, w] int32 coded
    as one TU: (cost [h/n, w/n] float32, mode [h/n, w/n] int32), the best of
    the three lowest-SATD modes."""
    return _rd(y, n, qp, bit_depth, None)


def rd_costs_forced(y: torch.Tensor, modes: torch.Tensor, n: int, qp: int,
                    bit_depth: int = 8) -> torch.Tensor:
    """RD cost [h/n, w/n] float32 of every n x n block coerced to the given
    intra mode (modes [h/n, w/n] int32)."""
    return _rd(y, n, qp, bit_depth, modes)[0]


def _rd_cuda(y, n, qp, bit_depth, modes):
    global RD_LAUNCHES
    from hevc_hop_torch.convert import device_tables
    if not (y.dtype == torch.int32 and y.stride(1) == 1):
        raise ValueError("rd_costs: y must be a CUDA int32 plane with dense "
                         "rows")
    h, w = y.shape
    by, bx = h // n, w // n
    if modes is not None and not (modes.is_cuda and modes.is_contiguous()
                                  and modes.dtype == torch.int32):
        raise ValueError("rd_costs_forced: modes must be a contiguous CUDA "
                         "int32 tensor")
    cost = torch.empty((by, bx), dtype=torch.float32, device=y.device)
    mode = torch.empty((by, bx), dtype=torch.int32, device=y.device)
    log2 = n.bit_length() - 1
    tab = device_tables(y.device)
    qs, qbits, qoff = quant.quant_params(qp, log2, bit_depth)
    dqs, dqsh = quant.dequant_params(qp, log2, bit_depth)
    k = f"intra{n}"
    fn = _cuda.bind("partition", "hh_partition_rd",
                    "piii" "p" "ii" "iiiii" "f" "ppppppp" "pp" "p")
    err = fn(y.data_ptr(), h, w, y.stride(0),
             None if modes is None else modes.data_ptr(),
             n, bit_depth, qs, qbits, qoff, dqs, dqsh,
             full_lambda(qp),
             tab[k + "_ext_idx"].data_ptr(), tab[k + "_pred_idx"].data_ptr(),
             tab[k + "_fact"].data_ptr(), tab[k + "_is_hor"].data_ptr(),
             tab[k + "_filt"].data_ptr(),
             tab["hadamard4" if n == 4 else "hadamard8"].data_ptr(),
             tab["dst4" if n == 4 else f"dct{n}"].data_ptr(),
             cost.data_ptr(), mode.data_ptr(), _cuda.stream(y))
    _cuda.check("partition", err)
    RD_LAUNCHES += 1
    return cost, mode


# ---------------------------------------------------------------------------
# The bottom-up decision.
# ---------------------------------------------------------------------------

def _sum4(a: torch.Tensor) -> torch.Tensor:
    """Sum of each 2x2 cell, ((a00 + a01) + a10) + a11."""
    return ((a[0::2, 0::2] + a[0::2, 1::2]) + a[1::2, 0::2]) + a[1::2, 1::2]


def _up2(a: torch.Tensor) -> torch.Tensor:
    return a.repeat_interleave(2, 0).repeat_interleave(2, 1)


def _decide_costs(qp: int) -> tuple:
    """(mode, split, NxN, TU-split) rate costs of the decision. The NxN
    arm's 4 modes + part_mode bin + 3 extra luma-cbf bins, and the TU-split
    arm's mode + split flag, are each two constants that the reference adds
    in a row: folded into one float32 constant, as its compiler does."""
    lam = full_lambda(qp)
    mode_cost = lam * MODE_BITS
    return (mode_cost, lam * SPLIT_BITS,
            _f32(_f32(4.0 * mode_cost) + _f32(lam * 4.0)),
            _f32(_f32(mode_cost) + _f32(lam * TUSPLIT_BITS)))


def decide_plain(rd4, rd8, rd16, rd32, rd8f16, rd16f32, m4, m8, m16, m32,
                 qp: int):
    """Plain version of the decision, all three arms: ``rd4``/``m4`` None
    leaves out NxN, ``rd8f16``/``rd16f32`` None the TU split. Returns
    (depth8 (3 = NxN), mode4, tulog8) int32."""
    mode_cost, split_cost, nxn_cost, cut_cost = _decide_costs(qp)
    nxn, rqt = rd4 is not None, rd8f16 is not None
    i32 = lambda v: torch.full((), v, dtype=torch.int32, device=rd8.device)

    cu8 = rd8 + mode_cost
    if nxn:
        nxn8 = _sum4(rd4) + nxn_cost
        take_nxn = nxn8 < cu8
        best8 = torch.minimum(cu8, nxn8)
    else:
        take_nxn = torch.zeros_like(cu8, dtype=torch.bool)
        best8 = cu8

    def level(rd, rdf, below):
        cu = rd + mode_cost
        if rqt:
            cut = _sum4(rdf) + cut_cost
            take_t = cut < cu
            cu = torch.minimum(cu, cut)
        else:
            take_t = torch.zeros_like(cu, dtype=torch.bool)
        split = _sum4(below) + split_cost
        take = cu <= split
        return take, take_t, torch.where(take, cu, split)

    take16, take16t, lvl16 = level(rd16, rd8f16, best8)
    take32, take32t, _ = level(rd32, rd16f32, lvl16)

    depth8 = torch.where(take_nxn, i32(3), i32(2))
    tulog8 = torch.where(take_nxn, i32(2), i32(3))
    mode4 = torch.where(_up2(take_nxn), m4, _up2(m8)) if nxn else _up2(m8)
    t16 = _up2(take16)
    depth8 = torch.where(t16, i32(1), depth8)
    tulog8 = torch.where(t16, torch.where(_up2(take16t), i32(3), i32(4)),
                         tulog8)
    mode4 = torch.where(_up2(t16), _up2(_up2(m16)), mode4)
    t32 = _up2(_up2(take32))
    depth8 = torch.where(t32, i32(0), depth8)
    tulog8 = torch.where(t32, torch.where(_up2(_up2(take32t)), i32(4),
                                          i32(5)), tulog8)
    mode4 = torch.where(_up2(t32), _up2(_up2(_up2(m32))), mode4)
    return depth8, mode4.to(torch.int32), tulog8


def _decide(rd4, rd8, rd16, rd32, rd8f16, rd16f32, m4, m8, m16, m32, qp):
    by, bx = rd32.shape
    shapes = {8: (rd4, m4), 4: (rd8, m8, rd8f16), 2: (rd16, m16, rd16f32),
              1: (rd32, m32)}
    for f, ts in shapes.items():
        for t in ts:
            if t is not None and tuple(t.shape) != (by * f, bx * f):
                raise ValueError("decide: cost and mode grids of one picture "
                                 "of whole 32x32 CTUs")
    if (rd4 is None) != (m4 is None) or (rd8f16 is None) != (rd16f32 is None):
        raise ValueError("decide: rd4 with m4, rd8f16 with rd16f32")
    if not rd32.is_cuda:
        return decide_plain(rd4, rd8, rd16, rd32, rd8f16, rd16f32,
                            m4, m8, m16, m32, qp)
    return _decide_cuda(rd4, rd8, rd16, rd32, rd8f16, rd16f32,
                        m4, m8, m16, m32, qp)


def _decide_cuda(rd4, rd8, rd16, rd32, rd8f16, rd16f32, m4, m8, m16, m32,
                 qp):
    global DECIDE_LAUNCHES
    dev = rd32.device
    ptr = []
    for t, dt in ((rd4, torch.float32), (rd8, torch.float32),
                  (rd16, torch.float32), (rd32, torch.float32),
                  (rd8f16, torch.float32), (rd16f32, torch.float32),
                  (m4, torch.int32), (m8, torch.int32), (m16, torch.int32),
                  (m32, torch.int32)):
        if t is not None and not (t.is_cuda and t.dtype == dt
                                  and t.is_contiguous()):
            raise ValueError("decide: contiguous CUDA float32 costs and "
                             "int32 modes")
        ptr.append(None if t is None else t.data_ptr())
    # the kernel reads a cell's 2x2 of rd4 and m4 with 8-byte loads
    if rd4 is not None and (ptr[0] % 8 or ptr[6] % 8):
        raise ValueError("decide: rd4 and m4 8-byte aligned")
    by, bx = rd32.shape
    depth8 = torch.empty((by * 4, bx * 4), dtype=torch.int32, device=dev)
    mode4 = torch.empty((by * 8, bx * 8), dtype=torch.int32, device=dev)
    tulog8 = torch.empty((by * 4, bx * 4), dtype=torch.int32, device=dev)
    fn = _cuda.bind("partition", "hh_partition_decide",
                    "pppppp" "pppp" "ii" "ffff" "ppp" "p")
    err = fn(*ptr, by, bx, *_decide_costs(qp), depth8.data_ptr(),
             mode4.data_ptr(), tulog8.data_ptr(), _cuda.stream(rd32))
    _cuda.check("partition", err)
    DECIDE_LAUNCHES += 1
    return depth8, mode4, tulog8


def decide(rd8, rd16, rd32, m8, m16, m32, qp: int):
    """Bottom-up DP over the quadtree with per-size RD cost tensors
    (rd* [by, bx] float32, m* [by, bx] int32 best mode per candidate CU).
    Returns (depth8 [by8, bx8] int32, mode8 [by8, bx8] int32)."""
    depth8, mode4, _ = _decide(None, rd8, rd16, rd32, None, None,
                               None, m8, m16, m32, qp)
    return depth8, mode4[::2, ::2]


def decide_nxn(rd4, rd8, rd16, rd32, m4, m8, m16, m32, qp: int):
    """DP as decide(), extended one level down: an 8x8 CU may code as NxN
    (four 4x4 PUs with their own modes + forced 4x4 TUs).
    Returns (depth8 [by8, bx8] int32 with 3 = NxN, mode4 [by4, bx4])."""
    return _decide(rd4, rd8, rd16, rd32, None, None, m4, m8, m16, m32,
                   qp)[:2]


def decide_rqt(rd4, rd8, rd16, rd32, rd8f16, rd16f32,
               m4, m8, m16, m32, qp: int):
    """decide_nxn() extended with the residual-quadtree arm: a 16x16 or
    32x32 CU may keep ONE prediction mode but split its transform into four
    half-size TUs (rd8f16/rd16f32 = forced-parent-mode sub-TU costs).
    Returns (depth8 int32 (3 = NxN), mode4 [by4, bx4] int32, tulog8
    [by8, bx8] int32 TU log2 per cell)."""
    return _decide(rd4, rd8, rd16, rd32, rd8f16, rd16f32, m4, m8, m16, m32,
                   qp)
