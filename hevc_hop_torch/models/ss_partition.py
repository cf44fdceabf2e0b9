"""ISS and PSS CU-quadtree decision as a batched pre-pass, on the card.

Counterpart of hevc_hop_tpu/models/ss_partition.py. For every CU size 8,
16 and 32, every block's best intra RD cost (kernel C5,
models/partition.py ``rd_costs``) and best inter RD cost
(:func:`ss_rd_costs`, kernel C9's pre-pass entry: the self-similarity
arm on the ORIGINAL plane and, on a PSS picture, the temporal arm on the
previous picture's luma, the cheaper of the two) are computed at once,
the lower of the two is kept, and kernel C5's bottom-up decision picks
the depth map.
The wavefront scan then codes the chosen tree against the true recon,
with the pre-pass's intra modes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.models import partition, ss_scan, wavefront
from hevc_hop_torch.ops import quant, ss_search, transform

PREPASS_LAUNCHES = 0
# launches of the pre-pass entry with the temporal arm (PSS)
TEMPORAL_PREPASS_LAUNCHES = 0


def static_preds(n: int, mi_size: int, b: int, device) -> torch.Tensor:
    """The pre-pass's four predictors [B, 4, 2]: zero and the three MI
    displacements (zero again without MI)."""
    dmi = -(((n + mi_size - 1) // mi_size) * mi_size) * 4 if mi_size else 0
    p = torch.tensor([[0, 0], [dmi, 0], [0, dmi], [dmi, dmi]],
                     dtype=torch.int32, device=device)
    return p[None].expand(b, -1, -1).contiguous()


def ss_rd_costs_plain(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius,
                      w, h, mi_size, lam, ref=None, radius_t=0):
    """Plain version of :func:`ss_rd_costs`: the search (or the two), then
    C5's cost of the residual (models/partition.py ``_tq_cost``) plus the
    winning search's rate."""
    b = pos.shape[0]
    preds = static_preds(n, mi_size, b, org_plane.device)
    _, cost, pred, sse = ss_search.ss_search_plain(
        org_plane, org_plane, pos, zcur, zmaxw, preds, n, radius, w, h, lam)
    best = cost
    if ref is not None:
        zero = torch.zeros((b, 1, 2), dtype=torch.int32,
                           device=org_plane.device)
        # the pre-pass program keeps F8's sum order in both arms
        _, tcost, tpred, tsse = ss_search.t_search_plain(
            ref, org_plane, pos, zero, n, radius_t, w, h, lam, seq=False)
        use_t = tcost < cost
        pred = torch.where(use_t[:, None, None], tpred, pred)
        cost = torch.where(use_t, tcost, cost)
        sse = torch.where(use_t, tsse, sse)
        best = torch.minimum(best, tcost)
    ok = best < 1e37
    out = torch.full_like(cost, ss_search.BIG)
    if ok.any():
        resi = (ss_search.block_at(org_plane, pos[ok], n).to(torch.int32)
                - pred[ok])
        out[ok] = partition._tq_cost(resi, n, qp, bit_depth) + (cost[ok]
                                                                - sse[ok])
    return out


def ss_rd_costs(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius, w, h,
                mi_size, lam, ref=None, radius_t=0):
    """Kernel C9, pre-pass entry: the RD cost [B] float32 of the best inter
    arm of every n-block at pos [B, 2] of the original plane (the
    reference's ``_ss_rd_size``): the SS search with the four static
    predictors, and with ref [h, W] int32 (a PSS picture's previous luma,
    the original's row stride) the temporal search over it with radius
    ``radius_t`` and the zero predictor, the cheaper kept; then SSE after
    the dead-zone transform round trip + lam * level bits + the search's
    rate; 3e38 where no displacement is valid."""
    if not org_plane.is_cuda:
        return ss_rd_costs_plain(org_plane, pos, zcur, zmaxw, n, qp,
                                 bit_depth, radius, w, h, mi_size, lam, ref,
                                 radius_t)
    return _ss_rd_cuda(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius,
                       w, h, mi_size, lam, ref, radius_t)


def _ss_rd_cuda(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius, w, h,
                mi_size, lam, ref, radius_t):
    global PREPASS_LAUNCHES, TEMPORAL_PREPASS_LAUNCHES
    from hevc_hop_torch.convert import device_tables
    b = pos.shape[0]
    ss_search._check_plane(org_plane, "org_plane")
    if ref is not None:
        ss_search._check_plane(ref, "ref")
        if ref.stride(0) != org_plane.stride(0):
            raise ValueError("ss_rd_costs: ref and org_plane share one "
                             "stride")
    for t, nm in ((pos, "pos"), (zcur, "zcur"), (zmaxw, "zmaxw")):
        ss_search._check(t, torch.int32, nm)
    dev = org_plane.device
    cost = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return cost
    log2 = n.bit_length() - 1
    qs, qbits, qoff = quant.quant_params(qp, log2, bit_depth)
    dqs, dqsh = quant.dequant_params(qp, log2, bit_depth)
    mi = static_preds(n, mi_size, 1, "cpu")[0].tolist()
    fn = _cuda.bind("ss_search", "hh_ss_rd",
                    "pipppp" "iiiiiif" "iiiii" "iiii" "pi" "p" "p")
    err = fn(org_plane.data_ptr(), org_plane.stride(0), pos.data_ptr(),
             zcur.data_ptr(), zmaxw.data_ptr(),
             device_tables(dev)[f"dct{n}"].data_ptr(),
             b, n, radius, w, h, bit_depth, ss_search.f32(lam),
             qs, qbits, qoff, dqs, dqsh,
             mi[1][0], mi[2][1], mi[3][0], mi[3][1],
             None if ref is None else ref.data_ptr(), radius_t,
             cost.data_ptr(), _cuda.stream(org_plane))
    _cuda.check("ss_search", err)
    PREPASS_LAUNCHES += 1
    if ref is not None:
        TEMPORAL_PREPASS_LAUNCHES += 1
    return cost


# ---------------------------------------------------------------------------
# An emulation of kernel C9's pre-pass arithmetic, for the tests: the
# search's integer sums (the correlation as the tensor cores form it) and
# the 2^24 rule, and the tail's sums.
# ---------------------------------------------------------------------------

def tail_cost_split(resi: torch.Tensor, n: int, qp: int, bit_depth: int,
                    log2=torch.log2) -> torch.Tensor:
    """float32 cost of each residual block resi [B, n, n] as the pre-pass
    entry's tail forms it: the dead-zone transform round trip, the SSE as
    an exact integer below 2^24 and else the raster walk of the float
    squares, the level bits over the nonzero levels only, in raster order
    from 0.0, then (the rate's overhead, lambda) as
    models/partition.py ``_tq_cost``. ``log2`` gives the rate terms'
    log2 (the reference's, F1, in the tests)."""
    log2n = n.bit_length() - 1
    coef = transform.fwd_transform(resi, bit_depth, False)
    lev = quant.quant(coef, qp, log2n, bit_depth, True)
    rq = transform.inv_transform(quant.dequant(lev, qp, log2n, bit_depth),
                                 bit_depth, False)
    err = (resi - rq).flatten(1)
    se = (err.long() ** 2).sum(1)
    ef = err.to(torch.float32)
    dist = torch.where(se < ss_search.EXACT, se.to(torch.float32),
                       quant.seq_sum(ef * ef))
    a = torch.abs(lev).to(torch.float32).flatten(1)
    zero = torch.zeros((), dtype=torch.float32, device=resi.device)
    terms = torch.where(a > 0, 3.0 + 2.0 * log2(a + 1.0), zero)
    # the nonzero terms first, in raster order (a stable sort), then zeros
    order = torch.sort((terms == 0).to(torch.int8), dim=1, stable=True)[1]
    packed = terms.gather(1, order)
    bits = torch.zeros(resi.shape[0], dtype=torch.float32,
                       device=resi.device)
    for k in range(packed.shape[1]):
        bits = bits + packed[:, k]
    ten = torch.full((), 10.0, dtype=torch.float32, device=resi.device)
    bits = bits + torch.where((lev != 0).flatten(1).any(1), ten, 1.0)
    lam = partition._f32(partition.full_lambda(qp))
    return (dist.double() + lam * bits.double()).float()


def ss_rd_costs_split(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius,
                      w, h, mi_size, lam, ref=None, radius_t=0,
                      log2=torch.log2):
    """:func:`ss_rd_costs` as kernel C9's pre-pass entry forms it: each
    arm's search by ops/ss_search.py ``search_split_plain`` in one part,
    corr on the tensor cores (8 bit) or as integer products, ref^2 from
    box sums, an entry past 2^24 in F8's order; the cheaper arm; then
    :func:`tail_cost_split` plus the winner's rate. Returns (cost [B], the
    regions the searches reached, summed over the arms, and each arm's
    search results (mv, cost, pred, sse), the SS arm's first)."""
    b = pos.shape[0]
    preds = static_preds(n, mi_size, b, org_plane.device)
    mask = ss_search._ss_masks(pos, zcur, zmaxw, None, n, radius, w, h)[0]
    found, regions = ss_search.search_split_plain(
        org_plane, org_plane, pos, mask, preds, n, radius, h, lam, False, 1,
        tensor_cores=True)
    arms = [found]
    _, cost, pred, sse = found
    best = cost
    if ref is not None:
        zero = torch.zeros((b, 1, 2), dtype=torch.int32,
                           device=org_plane.device)
        tmask = ss_search._targets(pos, n, radius_t, w, h)[2]
        tfound, treg = ss_search.search_split_plain(
            ref, org_plane, pos, tmask, zero, n, radius_t, h, lam, False, 1,
            tensor_cores=True)
        arms.append(tfound)
        _, tcost, tpred, tsse = tfound
        regions = {k: regions[k] + treg[k] for k in regions}
        use_t = tcost < cost
        pred = torch.where(use_t[:, None, None], tpred, pred)
        cost = torch.where(use_t, tcost, cost)
        sse = torch.where(use_t, tsse, sse)
        best = torch.minimum(best, tcost)
    ok = best < 1e37
    out = torch.full_like(cost, ss_search.BIG)
    if ok.any():
        resi = (ss_search.block_at(org_plane, pos[ok], n).to(torch.int32)
                - pred[ok])
        out[ok] = tail_cost_split(resi, n, qp, bit_depth, log2) + (
            cost[ok] - sse[ok])
    return out, regions, arms


@functools.lru_cache(maxsize=16)
def _grid(w: int, h: int, ctb_log2: int, n: int, device: str):
    """(pos [B, 2], zcur [B]) int32 of the n-blocks of the picture in
    raster order, on ``device``, built once per geometry."""
    ys = (np.arange(h // n) * n)[:, None].repeat(w // n, 1).ravel()
    xs = (np.arange(w // n) * n)[None, :].repeat(h // n, 0).ravel()
    zplane4 = wavefront.zaddr4_plane(w, h, ctb_log2)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=device)
    return t(np.stack([xs, ys], -1)), t(zplane4[ys >> 2, xs >> 2])


def decide(y_dev: torch.Tensor, qp: int, ctb_log2: int, radius: int,
           mi_size: int, bit_depth: int = 8, ref_y=None,
           radius_t: int | None = None):
    """Quadtree depth map [h/8, w/8] uint8 and per-4x4 intra mode map
    [h/4, w/4] int32 (numpy) of an ISS picture (ref_y None) or a PSS one
    (ref_y [h, w] int32, the previous picture's luma, with the temporal
    radius ``radius_t``, ``radius`` when None) whose luma y_dev [h, w]
    int32 lies on the target device."""
    h, w = y_dev.shape
    lam = partition.full_lambda(qp)
    costs, modes = {}, {}
    for log2 in (3, 4, 5):
        n = 1 << log2
        pos, zcur = _grid(w, h, ctb_log2, n, str(y_dev.device))
        icost, imode = partition.rd_costs(y_dev, n, qp, bit_depth)
        scost = ss_rd_costs(y_dev, pos, zcur,
                            ss_scan.zmax_plane(w, h, ctb_log2, n,
                                               y_dev.device),
                            n, qp, bit_depth, radius, w, h, mi_size, lam,
                            ref_y, radius if radius_t is None else radius_t)
        costs[log2] = torch.minimum(icost, scost.reshape(h // n, w // n))
        modes[log2] = imode
    depth8, mode8 = partition.decide(costs[3], costs[4], costs[5], modes[3],
                                     modes[4], modes[5], qp)
    depth8 = depth8.cpu().numpy().astype(np.uint8)
    mode8 = mode8.cpu().numpy()
    mode4 = np.repeat(np.repeat(mode8, 2, 0), 2, 1).astype(np.int32)
    return depth8, mode4
