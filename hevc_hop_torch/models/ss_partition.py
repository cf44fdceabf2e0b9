"""ISS CU-quadtree decision as a batched pre-pass, on the card.

Counterpart of hevc_hop_tpu/models/ss_partition.py for ISS pictures (the
temporal arm of PSS is not ported). For every CU size 8, 16 and 32, every
block's best intra RD cost (kernel C5, models/partition.py ``rd_costs``)
and best self-similarity RD cost (:func:`ss_rd_costs`, kernel C9's
pre-pass entry) are computed at once on the ORIGINAL plane, the lower of
the two is kept, and kernel C5's bottom-up decision picks the depth map.
The wavefront scan then codes the chosen tree against the true recon,
with the pre-pass's intra modes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.models import partition, ss_scan, wavefront
from hevc_hop_torch.ops import quant, ss_search

PREPASS_LAUNCHES = 0


def static_preds(n: int, mi_size: int, b: int, device) -> torch.Tensor:
    """The pre-pass's four predictors [B, 4, 2]: zero and the three MI
    displacements (zero again without MI)."""
    dmi = -(((n + mi_size - 1) // mi_size) * mi_size) * 4 if mi_size else 0
    p = torch.tensor([[0, 0], [dmi, 0], [0, dmi], [dmi, dmi]],
                     dtype=torch.int32, device=device)
    return p[None].expand(b, -1, -1).contiguous()


def ss_rd_costs_plain(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius,
                      w, h, mi_size, lam):
    """Plain version of :func:`ss_rd_costs`: the search, then C5's cost of
    the residual (models/partition.py ``_tq_cost``) plus the search's
    rate."""
    preds = static_preds(n, mi_size, pos.shape[0], org_plane.device)
    _, cost, pred, sse = ss_search.ss_search_plain(
        org_plane, org_plane, pos, zcur, zmaxw, preds, n, radius, w, h, lam)
    ok = cost < 1e37
    out = torch.full_like(cost, ss_search.BIG)
    if ok.any():
        resi = (ss_search.block_at(org_plane, pos[ok], n).to(torch.int32)
                - pred[ok])
        out[ok] = partition._tq_cost(resi, n, qp, bit_depth) + (cost[ok]
                                                                - sse[ok])
    return out


def ss_rd_costs(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius, w, h,
                mi_size, lam):
    """Kernel C9, pre-pass entry: the RD cost [B] float32 of the best SS
    arm of every n-block at pos [B, 2] of the original plane (the
    reference's ``_ss_rd_size`` without the temporal arm): the search with
    the four static predictors, then SSE after the dead-zone transform
    round trip + lam * level bits + the search's rate; 3e38 where no
    displacement is causal."""
    if not org_plane.is_cuda:
        return ss_rd_costs_plain(org_plane, pos, zcur, zmaxw, n, qp,
                                 bit_depth, radius, w, h, mi_size, lam)
    return _ss_rd_cuda(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius,
                       w, h, mi_size, lam)


def _ss_rd_cuda(org_plane, pos, zcur, zmaxw, n, qp, bit_depth, radius, w, h,
                mi_size, lam):
    global PREPASS_LAUNCHES
    from hevc_hop_torch.convert import device_tables
    b = pos.shape[0]
    ss_search._check_plane(org_plane, "org_plane")
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
                    "pipppp" "iiiiiif" "iiiii" "iiii" "p" "p")
    err = fn(org_plane.data_ptr(), org_plane.stride(0), pos.data_ptr(),
             zcur.data_ptr(), zmaxw.data_ptr(),
             device_tables(dev)[f"dct{n}"].data_ptr(),
             b, n, radius, w, h, bit_depth, ss_search.f32(lam),
             qs, qbits, qoff, dqs, dqsh,
             mi[1][0], mi[2][1], mi[3][0], mi[3][1],
             cost.data_ptr(), _cuda.stream(org_plane))
    _cuda.check("ss_search", err)
    PREPASS_LAUNCHES += 1
    return cost


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
           mi_size: int, bit_depth: int = 8):
    """Quadtree depth map [h/8, w/8] uint8 and per-4x4 intra mode map
    [h/4, w/4] int32 (numpy) of an ISS picture whose luma y_dev [h, w]
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
                            n, qp, bit_depth, radius, w, h, mi_size, lam)
        costs[log2] = torch.minimum(icost, scost.reshape(h // n, w // n))
        modes[log2] = imode
    depth8, mode8 = partition.decide(costs[3], costs[4], costs[5], modes[3],
                                     modes[4], modes[5], qp)
    depth8 = depth8.cpu().numpy().astype(np.uint8)
    mode8 = mode8.cpu().numpy()
    mode4 = np.repeat(np.repeat(mode8, 2, 0), 2, 1).astype(np.int32)
    return depth8, mode4
