#!/usr/bin/env python3
"""Chip smoke of hevc_hop_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: every CUDA kernel of hevc_hop_torch/csrc (one nvcc per source,
   all started together, sm_90a) and the native CABAC library;
2. kernels: each kernel C1-C4 against its plain PyTorch version on the
   card, same seeded inputs, at every TU size 4-32 (DST4 included):
   0 mismatching elements;
3. main path: the all-intra encode of one 1920x1088 frame
   (cu_log2 = 4, RDOQ off, SBH, deblocking, checksum SEI) and its decode,
   both on the card; recon == decoded picture, hash_ok, and every kernel
   launched on that path. Then TIMED_FRAMES more encodes and decodes,
   timed one by one (median and maximum);
4. cpu: a 416x240 frame at cu_log2 3, 4 and 5, on the card and on the CPU
   (the path the CPU tests hold against the JAX reference): the streams
   must be byte-identical;
5. fixture: the committed JAX default-configuration stream
   tests/torch_fixtures/jax_intra_416x240_qp32.bin decodes on the card
   with hash_ok and the stored per-plane MD5s;
6. timing: each kernel held against its plain version at the largest
   launch the main path gives it, and at the path's other launch forms
   (C2's and C3's chroma launches on the stacked cb/cr plane, C2's decode
   epilogue for luma and chroma), 0 mismatching elements; then the
   kernel's device time (torch.profiler) beside the least time the card
   could take for the work its function needs (bytes, or operations by
   the fast algorithms HM uses), and the wrapper's and the plain
   version's time per call (CUDA events);
   then torch.profiler over one more encode and one more decode for each
   kernel's device time per frame and the card's idle share of each.

It prints the card's name and power limit, one JSON line for the kernels,
one for the main path, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and int32 operations
# on the CUDA cores (64 INT32 lanes per SM x 132 SMs x 1.98 GHz, a
# multiply-add counted as two operations, as the 67 TFLOP/s FP32 figure
# counts an FMA on its 128 FP32 lanes)
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 33.5e12

W, H, QP = 1920, 1088, 32
TIMED_FRAMES = 10


def log(*a):
    print(*a, flush=True)


def synth_class_b(w, h, seed=0):
    """bench.py's synthetic class-B content (copied: this script imports
    nothing of the JAX package or its benchmark)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
         + 25 * np.sin((xx + yy) / 7.0)
         + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.int32)
    cb = (128 + 30 * np.sin(xx[::2, ::2] / 41.0)).clip(0, 255).astype(np.int32)
    cr = (128 - 28 * np.cos(yy[::2, ::2] / 37.0)).clip(0, 255).astype(np.int32)
    return y, cb, cr


class Failed(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Failed(what)


# ---------------------------------------------------------------------------

def phase_build():
    from hevc_hop_torch import _cuda
    from hevc_hop_torch.entropy import native
    t0 = time.perf_counter()
    _cuda.build_all()
    for name in _cuda.sources():
        _cuda.lib(name)
    native.get_lib()
    log(f"build: {_cuda.sources()} and libhevc_hop.so in "
        f"{time.perf_counter() - t0:.1f} s")


def _mismatch(a, b):
    import torch
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


class Check:
    """Mismatch and max-abs-error tally of one kernel against its plain
    version."""

    def __init__(self):
        self.mism = 0
        self.err = 0
        self.cases = 0

    def add(self, got, want, what):
        m, e = _mismatch(got, want)
        self.cases += 1
        self.mism += m
        self.err = max(self.err, e)
        require(m == 0, f"{what}: {m} mismatching elements (max |err| {e})")


def _blocky(rng, h, w):
    """A ramp with a small step at every 8x8 block and a little noise, so
    that deblocking takes its strong, weak and off branches."""
    ramp = 60 + (np.arange(w)[None] + np.arange(h)[:, None]) // 16
    step = np.repeat(np.repeat(rng.integers(-12, 13, (h // 8, w // 8)), 8, 0),
                     8, 1)
    return np.clip(ramp + step + rng.integers(-2, 3, (h, w)), 0, 255)


def phase_kernels(checks):
    """Every kernel against its plain version on the card, every TU size."""
    import torch
    from hevc_hop_torch.ops import deblock, hashes, intra, tq
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                  device=dev)
    c1, c2, c3, c4 = (checks[k] for k in ("C1", "C2", "C3", "C4"))
    for n in (4, 8, 16, 32):
        h, w = 6 * n, 8 * n
        plane = t(rng.integers(0, 256, (h, w)))
        org = t(np.clip(plane.cpu().numpy() + rng.integers(-20, 20, (h, w)),
                        0, 255))
        pos = t([[x, y] for y in range(0, h, n) for x in range(0, w, n)])
        b = pos.shape[0]
        avail = t(rng.random((b, 4 * n + 1)) < 0.75, torch.bool)
        avail[0] = False
        modes = t(np.concatenate([np.arange(35), rng.integers(0, 35, b)])[:b])
        for c_idx in (0, 1):
            rmd = torch.full((b,), -1, dtype=torch.int32, device=dev)
            rmd[::5] = modes[::5]
            got = intra.intra_blocks(plane, pos, avail, rmd, n, c_idx,
                                     org=org)
            want = intra.intra_blocks_plain(plane, pos, avail, rmd, n, c_idx,
                                            org=org)
            c2.add(got[0], want[0], f"C2 rmd pred n={n} c={c_idx}")
            c2.add(got[1], want[1], f"C2 rmd best n={n} c={c_idx}")
            got = intra.intra_blocks(plane, pos, avail, modes, n, c_idx)
            want = intra.intra_blocks_plain(plane, pos, avail, modes, n,
                                            c_idx)
            c2.add(got[0], want[0], f"C2 mode pred n={n} c={c_idx}")
            resi = t(rng.integers(-80, 80, (h, w)))
            pk, pp = plane.clone(), plane.clone()
            intra.intra_blocks(pk, pos, avail, modes, n, c_idx, resi=resi)
            intra.intra_blocks_plain(pp, pos, avail, modes, n, c_idx,
                                     resi=resi)
            c2.add(pk, pp, f"C2 decode n={n} c={c_idx}")
            # C3 encode (DST at 4x4 luma) with SBH, then its decode entry
            pred = want[0]
            outs = []
            for fn in (tq.tq_encode, tq.tq_encode_plain):
                rec = torch.zeros_like(plane)
                cp = torch.zeros((h, w), dtype=torch.int16, device=dev)
                cbf = fn(org, pred, pos, modes, n, c_idx, 22, 8, True, 0.0,
                         rec, cp)
                outs.append((rec, cp, cbf))
            for i, what in enumerate(("recon", "levels", "cbf")):
                c3.add(outs[0][i], outs[1][i], f"C3 encode {what} n={n} "
                       f"c={c_idx}")
            dst = n == 4 and c_idx == 0
            lev = outs[1][1]
            ok = tq.tq_decode(lev, pos, n, 22, 8, dst,
                              torch.zeros_like(plane))
            op = tq.tq_decode_plain(lev, pos, n, 22, 8, dst,
                                    torch.zeros_like(plane))
            c3.add(ok, op, f"C3 decode n={n} c={c_idx}")
    for (w, h) in ((W, H), (416, 240)):
        y, cb, cr = (t(_blocky(rng, hh, ww)) for hh, ww in
                     ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
        tu4 = t(rng.integers(2, 6, (h // 4, w // 4)), torch.uint8)
        for qp, off in ((22, (0, 0)), (37, (2, -1))):
            got = deblock.deblock_frame(y, cb, cr, tu4, qp, qp - 2, 8, *off)
            want = deblock.deblock_frame_plain(y, cb, cr, tu4, qp, qp - 2, 8,
                                               *off)
            for g, p, nm in zip(got, want, ("y", "cb", "cr")):
                c4.add(g, p, f"C4 {w}x{h} qp={qp} {nm}")
        for bd in (8, 10):
            planes = [p * (4 if bd == 10 else 1) + 3 for p in (y, cb, cr)]
            got = hashes.plane_checksums(planes, bd)
            want = [hashes._checksum_plain(p, bd) for p in planes]
            c1.add(got, want, f"C1 {w}x{h} bd={bd}")
    torch.cuda.synchronize()
    log("kernels: " + ", ".join(
        f"{k} {c.cases} cases {c.mism} mismatches" for k, c in checks.items()))


def _counters():
    """(name, module, attribute) of every kernel's launch count; the two
    kernels of csrc/tq.cu count apart."""
    from hevc_hop_torch.ops import deblock, hashes, intra, tq
    return [("C1", hashes, "LAUNCHES"), ("C2", intra, "LAUNCHES"),
            ("C3 encode", tq, "ENCODE_LAUNCHES"),
            ("C3 decode", tq, "DECODE_LAUNCHES"),
            ("C4", deblock, "LAUNCHES")]


def phase_main_path():
    import torch
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    frame = synth_class_b(W, H, seed=0)
    cfg = EncoderConfig(width=W, height=H, qp=QP, cu_log2=4, rdoq=False)
    enc = IntraEncoder(cfg)
    counters = _counters()
    for _, m, attr in counters:
        setattr(m, attr, 0)
    t0 = time.perf_counter()
    stream = enc.encode_frame(*frame)
    dec = Decoder()
    (pic,) = dec.decode_stream(stream)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"main path launches: {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    require(dec.hash_ok == [True], f"hash_ok {dec.hash_ok}")
    for a, b, nm in zip(pic, enc.recon_yuv, ("y", "cb", "cr")):
        require(np.array_equal(a, b), f"decoded {nm} != encoder recon")
    y = frame[0]
    mse = np.mean((enc.recon_yuv[0].astype(np.float64) - y) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    require(psnr > 25, f"Y-PSNR {psnr:.2f} dB")

    # timed: TIMED_FRAMES more frames each way, one after another (the
    # first frame built the schedules and loaded the kernels)
    enc_s, dec_s = [], []
    for _ in range(TIMED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = enc.encode_frame(*frame)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        require(again == stream, "a later encode differs from the first")
        t0 = time.perf_counter()
        dec2 = Decoder()
        dec2.decode_stream(stream)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        require(dec2.hash_ok == [True], "a later decode's hash")
    stats = dict(enc.last_stats)
    plans = enc._schedule(enc._decide()).plans
    levels = int(sum(np.any([p.cnt > 0 for p in plans.values()], 0)))
    enc_med, dec_med = float(np.median(enc_s)), float(np.median(dec_s))
    out = {"frame": f"{W}x{H}", "qp": QP, "cu_log2": 4,
           "wavefront_levels": levels,
           "bytes": len(stream), "y_psnr_db": psnr,
           "first_encode_decode_s": first_s, "timed_frames": TIMED_FRAMES,
           "encode_s": enc_med, "encode_s_max": max(enc_s),
           "decode_s": dec_med, "decode_s_max": max(dec_s),
           "encode_fps": 1.0 / enc_med, "decode_fps": 1.0 / dec_med,
           "last_stats": stats, "launches": launches}
    return out, dict(enc=enc, frame=frame)


def phase_cpu_parity():
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    frame = synth_class_b(416, 240, seed=3)
    for cu in (3, 4, 5):
        cfg = EncoderConfig(width=416, height=240, qp=QP, cu_log2=cu,
                            rdoq=False)
        g = IntraEncoder(cfg).encode_frame(*frame)
        c = IntraEncoder(cfg, device="cpu").encode_frame(*frame)
        require(g == c, f"card and CPU streams differ at cu_log2={cu}")
        log(f"cpu parity: cu_log2={cu} {len(g)} bytes identical")


def phase_fixture():
    from hevc_hop_torch.models.decoder import Decoder
    base = os.path.join(ROOT, "tests", "torch_fixtures",
                        "jax_intra_416x240_qp32")
    with open(base + ".bin", "rb") as f:
        stream = f.read()
    with open(base + ".json") as f:
        meta = json.load(f)
    dec = Decoder()
    (planes,) = dec.decode_stream(stream)
    require(dec.hash_ok == [True], f"fixture hash_ok {dec.hash_ok}")
    md5 = {k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
           for k, p in zip(("y", "cb", "cr"), planes)}
    require(md5 == meta["md5"], f"fixture MD5s {md5}")
    log("fixture: decoded with hash_ok and the stored MD5s")


# ---------------------------------------------------------------------------
# Timing at main-path shapes.

def time_ms(fn, reps=7, inner=10):
    """Median over reps of the mean time of one call in a run of inner
    back-to-back calls (CUDA events), after two warm-ups."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    return float(np.median(ts))


# Operation counts of the work each kernel's function needs, by the fast
# algorithms HM uses: an add, subtract, shift, abs, min or max, or a lone
# multiply counts one operation, a multiply-add two. Work that depends on
# the data beyond what is counted (SBH's RD move) is left out, so each
# count is a floor.

def butterfly_ops(n):
    """One 1-D n-point DCT by HM's partial butterfly, forward or inverse:
    n even/odd sums, the odd half's n/2 dot products of n/2 terms, the even
    half recursively (at n = 4: four sums, four dot products of two)."""
    if n == 4:
        return 4 + 4 * 3
    return n + (n // 2) * (n - 1) + butterfly_ops(n // 2)


def transform_ops(n, inverse):
    """A 2-D n x n transform: 2n butterflies, a rounding add and shift per
    output of each stage, and on the inverse a 16-bit clamp (two)."""
    return 2 * n * (butterfly_ops(n) + (4 if inverse else 2) * n)


def satd_ops(n):
    """Hadamard SATD of an n x n difference, as HM's xCalcHADs: per k x k
    tile (k = 8, or 4 at n = 4) the difference, two passes of log2(k)
    butterfly stages, abs, the sum and its normalisation; then the tiles'
    sum."""
    k = 8 if n >= 8 else 4
    tiles = (n // k) ** 2
    tile = k * k * (1 + 2 * (k.bit_length() - 1) + 1) + (k * k - 1) + 2
    return tiles * tile + tiles - 1


def rmd_ops(n, c_idx=0):
    """Kernel C2's RMD of one n x n block: the reference smoothing, the 35
    predictions (planar by HM's running sums, four per sample; DC's mean
    and luma edge filter; an angular row two taps, (32-f)a + fb + 16 >> 5,
    five operations per sample, where its fraction f is non-zero, and a
    copy where it is zero; the luma edge filter of modes 10 and 26), each
    prediction's SATD, and the 34 comparisons of the choice."""
    from hevc_hop_torch.common import rom
    luma_edges = c_idx == 0 and n < 32
    ops = 4 * (4 * n - 1) if c_idx == 0 and n > 4 else 0
    ops += 4 * n * n
    ops += 2 * n + 1 + (3 * (2 * n - 1) if luma_edges else 0)
    for mi in range(33):
        angle = int(rom.INTRA_PRED_ANGLE[mi])
        ops += 5 * n * sum(((y + 1) * angle) & 31 != 0 for y in range(n))
        if luma_edges and mi + 2 in (10, 26):
            ops += 5 * n
    return ops + 35 * satd_ops(n) + 34


def tq_encode_ops(n):
    """Kernel C3's encode entry on one n x n block: the residual, the
    forward transform, the quantiser (abs, multiply-add, shift, sign,
    clamp), SBH's group parity (abs and sum), the dequantiser
    (multiply-add, shift, clamp), the inverse transform and the clipped
    recon."""
    nn = n * n
    return (nn + transform_ops(n, False) + 7 * nn + 2 * nn + 5 * nn
            + transform_ops(n, True) + 3 * nn)


def tq_decode_ops(n):
    """Kernel C3's decode entry on one n x n block: dequantiser and
    inverse transform."""
    return 5 * n * n + transform_ops(n, True)


def bound(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _replay_other_launches(enc, frame, sched, s, checks):
    """The main path's other launch forms at the fullest level s, against
    their plain versions on the same inputs: C2's chroma prediction and
    C3's chroma encode on the stacked cb/cr plane (cb and cr blocks share
    one row of availability and mode), and C2's decode epilogue for luma
    and for chroma."""
    import torch
    from hevc_hop_torch.common import rom
    from hevc_hop_torch.ops import intra, tq
    dev = torch.device("cuda")
    p, n = sched.plans[4], 16
    o, c, co = int(p.off[s]), int(p.cnt[s]), int(p.coff[s])
    pad = 1 << enc.cfg.ctb_log2
    hc, hc_off = H // 2, H // 2 + pad
    ry, rcb, rcr = enc._recon_dev
    stack = lambda a, b: torch.cat([
        a, torch.zeros((pad, W // 2), dtype=torch.int32, device=dev),
        b, torch.zeros((pad, W // 2), dtype=torch.int32, device=dev)])
    up = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    rc, org_c = stack(rcb, rcr), stack(up(frame[1]), up(frame[2]))
    require(rc.shape[0] == 2 * hc_off, "stacked chroma plane")
    plane = torch.zeros((H + pad, W), dtype=torch.int32, device=dev)
    plane[:H] = ry
    pos, avail = p.pos[o:o + c], p.avail[o:o + c]
    cpos, cavail = p.cpos[co:co + 2 * c], p.cavail[o:o + c]
    org = torch.zeros_like(plane)
    org[:H] = up(frame[0])
    rmd = torch.full((c,), -1, dtype=torch.int32, device=dev)
    _, best = intra.intra_blocks(plane, pos, avail, rmd, n, 0, org=org)
    c2, c3 = checks["C2"], checks["C3"]
    got = intra.intra_blocks(rc, cpos, cavail, best, n // 2, 1)[0]
    predc = intra.intra_blocks_plain(rc, cpos, cavail, best, n // 2, 1)[0]
    c2.add(got, predc, "C2 chroma prediction at the main path's shape")
    outs = []
    for fn in (tq.tq_encode, tq.tq_encode_plain):
        rec = torch.zeros_like(rc)
        cp = torch.zeros(rc.shape, dtype=torch.int16, device=dev)
        cbf = fn(org_c, predc, cpos, best, n // 2, 1,
                 rom.chroma_qp_from_luma(QP), 8, True, 0.0, rec, cp)
        outs.append((rec, cp, cbf))
    for i, what in enumerate(("recon", "levels", "cbf")):
        c3.add(outs[0][i], outs[1][i],
               f"C3 chroma encode {what} at the main path's shape")
    g = torch.Generator(device="cpu").manual_seed(5)
    for nm, pl, bp, av, sz, c_idx in (
            ("luma", plane, pos, avail, n, 0),
            ("chroma", rc, cpos, cavail, n // 2, 1)):
        resi = torch.randint(-60, 61, pl.shape, generator=g,
                             dtype=torch.int32).to(dev)
        pk, pp = pl.clone(), pl.clone()
        intra.intra_blocks(pk, bp, av, best, sz, c_idx, resi=resi)
        intra.intra_blocks_plain(pp, bp, av, best, sz, c_idx, resi=resi)
        c2.add(pk, pp, f"C2 {nm} decode epilogue at the main path's shape")
    torch.cuda.synchronize()


def phase_timing(ctx, checks, launches):
    """Each kernel at the largest launch the main path gives it (C2 and
    C3 encode: the fullest wavefront level; C3 decode, C4, C1: the whole
    frame): held against its plain version on the same inputs, then both
    timed. The other launch forms of the path are held too."""
    import torch
    from hevc_hop_torch.ops import deblock, hashes, intra, tq
    enc = ctx["enc"]
    sched = enc._schedule(enc._decide())
    p, n = sched.plans[4], 16
    s = int(np.argmax(p.cnt))
    _replay_other_launches(enc, ctx["frame"], sched, s, checks)
    o, c = int(p.off[s]), int(p.cnt[s])
    tu4 = sched.tu4_dev
    dev = torch.device("cuda")
    pad = 1 << enc.cfg.ctb_log2
    org = torch.zeros((H + pad, W), dtype=torch.int32, device=dev)
    org[:H] = torch.as_tensor(ctx["frame"][0], device=dev)
    ry, rcb, rcr = enc._recon_dev
    plane = org.clone()
    plane[:H] = ry
    pos, avail = p.pos[o:o + c], p.avail[o:o + c]
    rmd = torch.full((c,), -1, dtype=torch.int32, device=dev)
    pred, best = intra.intra_blocks(plane, pos, avail, rmd, n, 0, org=org)
    # the frame's levels, for the decode entry: every 16x16 block of the
    # original predicted by the (deblocked) recon
    ys, xs = np.mgrid[0:H:n, 0:W:n]
    grid = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], -1),
                           dtype=torch.int32, device=dev)
    nb = grid.shape[0]
    modes0 = torch.zeros(1, dtype=torch.int32, device=dev)
    fpred = ry.reshape(H // n, n, W // n, n).transpose(1, 2).reshape(
        -1, n, n).contiguous()
    coef = torch.zeros(org.shape, dtype=torch.int16, device=dev)
    tq.tq_encode(org, fpred, grid, modes0, n, 0, QP, 8, True, 0.0,
                 torch.zeros_like(org), coef)
    levels = coef[:H].contiguous()
    bufs = {k: (torch.zeros_like(org),
                torch.zeros(org.shape, dtype=torch.int16, device=dev),
                torch.zeros((H, W), dtype=torch.int32, device=dev))
            for k in ("kernel", "plain")}

    def tq_enc(fn, k):
        rec, cp, _ = bufs[k]
        return fn(org, pred, pos, best, n, 0, QP, 8, True, 0.0, rec, cp), \
            rec, cp

    def tq_dec(fn, k):
        return fn(levels, grid, n, QP, 8, False, bufs[k][2])

    npx = H * W * 3 // 2
    # (name, counter, what, source, replaces, kernel, plain, bytes, ops)
    specs = [
        ("C2 intra (RMD)", "C2", f"{c} luma blocks of {n}x{n}, 35-mode RMD",
         "hevc_hop_torch/csrc/intra.cu", "hevc_hop_tpu/ops/intra.py:124",
         lambda: intra.intra_blocks(plane, pos, avail, rmd, n, 0, org=org),
         lambda: intra.intra_blocks_plain(plane, pos, avail, rmd, n, 0,
                                          org=org),
         c * (4 * n * n * 2 + 4 * (4 * n + 1) + 4 * n + 1 + 16),
         c * rmd_ops(n)),
        ("C3 tq (encode)", "C3 encode",
         f"{c} luma blocks of {n}x{n}, encode entry",
         "hevc_hop_torch/csrc/tq.cu", "hevc_hop_tpu/ops/quant.py:54",
         lambda: tq_enc(tq.tq_encode, "kernel"),
         lambda: tq_enc(tq.tq_encode_plain, "plain"),
         c * (n * n * (4 + 4 + 4 + 2) + 16), c * tq_encode_ops(n)),
        ("C3 tq (decode)", "C3 decode",
         f"{nb} luma blocks of {n}x{n}, decode entry",
         "hevc_hop_torch/csrc/tq.cu", "hevc_hop_tpu/models/decoder.py:30",
         lambda: tq_dec(tq.tq_decode, "kernel"),
         lambda: tq_dec(tq.tq_decode_plain, "plain"),
         nb * (n * n * (2 + 4) + 8), nb * tq_decode_ops(n)),
        ("C4 deblock", "C4", f"{W}x{H} frame, both passes",
         "hevc_hop_torch/csrc/deblock.cu", "hevc_hop_tpu/ops/deblock.py:166",
         lambda: deblock.deblock_frame(ry, rcb, rcr, tu4, QP, 31),
         lambda: deblock.deblock_frame_plain(ry, rcb, rcr, tu4, QP, 31),
         2 * 4 * npx + tu4.numel(), 2 * 40 * npx // 4),
        ("C1 checksum", "C1", f"{W}x{H} frame, three planes",
         "hevc_hop_torch/csrc/checksum.cu", "hevc_hop_tpu/ops/hashes.py:18",
         lambda: hashes.plane_checksums([ry, rcb, rcr]),
         lambda: [hashes._checksum_plain(q, 8) for q in (ry, rcb, rcr)],
         4 * npx + 12, 10 * npx),
    ]
    rows = []
    for name, counter, shape, source, replaces, fn, plain, nbytes, ops \
            in specs:
        check = checks[counter.split()[0]]
        got, want = fn(), plain()
        torch.cuda.synchronize()
        for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            check.add(g, w_, f"{name} at the main path's shape")
        call_ms = time_ms(fn)
        pms = time_ms(plain, reps=5, inner=1)
        # the kernel's own device time per call: a call of these small
        # launches is bound by the host, so call_ms is mostly Python
        inner = 10
        prof = _profile(lambda: [fn() for _ in range(inner)])
        ms = prof["kernel_ms"][KERNEL_NAMES[name]] / inner
        require(ms > 0, f"the profiler saw no {KERNEL_NAMES[name]}")
        b_ms, by = bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[counter],
                     "max_abs_err": check.err, "mismatches": check.mism,
                     "ms": ms, "kernel_ms": ms, "call_ms": call_ms,
                     "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": None, "shape": shape})
    return rows


KERNEL_NAMES = {"C1 checksum": "checksum_kernel",
                "C2 intra (RMD)": "intra_kernel",
                "C3 tq (encode)": "tq_encode_kernel",
                "C3 tq (decode)": "tq_decode_kernel",
                "C4 deblock": "deblock_kernel"}


def _profile(fn):
    """Wall time of fn(), the card's busy time within it, and each
    kernel's device time, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {k: 0.0 for k in KERNEL_NAMES.values()}
    busy = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is not None and \
                "CUDA" not in str(e.device_type):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        busy += dt
        for k in per:
            if k in e.key:
                per[k] += dt
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1 - busy / 1e3 / (wall * 1e3)
                                  if busy else None),
            "kernel_ms": {k: v / 1e3 for k, v in per.items()}}


def phase_profile(ctx):
    """One encode and one decode of the main path's frame, each under
    torch.profiler: the card's idle share of each, and each kernel's
    device time (C2's sums every C2 launch: RMD, chroma, decode)."""
    from hevc_hop_torch.models.decoder import Decoder
    enc, frame = ctx["enc"], ctx["frame"]
    box = {}
    out = {"encode": _profile(
        lambda: box.setdefault("s", enc.encode_frame(*frame)))}
    out["decode"] = _profile(lambda: Decoder().decode_stream(box["s"]))
    log(f"profile: {json.dumps(out)}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    require(card, "nvidia-smi gave no card")
    phase_build()
    checks = {k: Check() for k in ("C1", "C2", "C3", "C4")}
    phase_kernels(checks)
    main_path, ctx = phase_main_path()
    phase_cpu_parity()
    phase_fixture()
    rows = phase_timing(ctx, checks, main_path["launches"])
    prof = phase_profile(ctx)
    for r in rows:
        k = KERNEL_NAMES[r["name"]]
        r["frame_ms"] = {side: prof[side]["kernel_ms"][k]
                         if prof[side]["device_busy_ms"] else None
                         for side in ("encode", "decode")}
    main_path["profile"] = prof
    log(card)
    log(json.dumps({"main_path": main_path, "card": card}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
