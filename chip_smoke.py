#!/usr/bin/env python3
"""Chip smoke of hevc_hop_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: every CUDA kernel of hevc_hop_torch/csrc (one nvcc per source,
   all started together, sm_90a) and the native CABAC library;
2. kernels: each kernel C1-C4 against its plain PyTorch version on the
   card, same seeded inputs, at every TU size 4-32 (DST4 included):
   0 mismatching elements. Kernel C7 (RDOQ) against its plain body for
   every TU class (4x4 to 32x32, luma and chroma), every MDCS scan the
   class has, 8 and 10 bit, QP 22/27/32/37 and init types 2, 3 and 4 (I,
   ISS and PSS slices), on
   seeded blocks with all-zero and clamped ones: 0 mismatching levels.
   Kernels C5 (partition RD pre-pass and decision) and C6 (SAO statistics
   and apply) at the main path's shapes, a 1920x1088 luma plane and its
   chroma, 8 and 10 bit: integers equal, float32 costs within COST_RTOL,
   and a decision that differs only where the two costs behind it agree
   within COST_RTOL (each count printed). Kernel C8 (motion compensation)
   at every luma size 4-32 and chroma size 2-16, every phase, 8 and 10
   bit, windows clamped at every edge, in its three forms. Kernel C11 (the
   GT warp) on every golden case of tests/golden/hm_golden.json and a
   sweep of both forms (luma 8-32, chroma 4-16, 8 and 10 bit, corners to
   +-n, the knife edges reached), prediction and safety mask, and its
   plane entries in their masked and add-residual forms;
3. main paths, all on the card, each with every launch count set to 0
   just before it and read just after:
   - production: bench.py's production configuration, the all-intra
     encode of 1920x1088 frames with the RD pre-pass, NxN, the residual
     quadtree, RDOQ (C7's device code in C3's RDOQ arm), SBH, deblocking,
     SAO and the checksum SEI, and the decode of that stream; recon ==
     decoded picture, hash_ok, every kernel of the path launched. Then
     TIMED_FRAMES more encodes and decodes, timed one by one (median and
     maximum) with two fixed pieces of host work timed beside each
     (host_probes: the paths are bound by the host, whose speed moves),
     and four distinct frames (the last with five times the noise, whose
     partition goes down to 4x4), so that building a frame's schedule is
     timed too;
   - quadtree: the same with RDOQ off, QUADTREE_TIMED_FRAMES timed frames;
   - uniform: uniform 16x16 CUs, in-loop RMD, SAO and RDOQ off,
     UNIFORM_TIMED_FRAMES timed frames;
   - iss: the lenslet ISS encode (bench.py:88-100's cell with the GT warp
     off, at 1920x1088: quadtree pre-pass with C9's pre-pass entry,
     self-similarity search C9, merge arms, sub-pel refinement and the
     tournament C10, chroma MC C8, RDOQ, SAO, deblocking with the inter
     boundary strengths) of a copy of tools/bdrate.py's lenslet frame and
     its decode, ISS_TIMED_FRAMES timed frames;
   - iss-uniform: the same with uniform 16x16 CUs and in-loop RMD, one
     timed frame;
   - iss-gt: bench.py:88-100's lenslet cell whole, the GT warp on (C9's
     anchor ring, C12's corner search and decision, C11's GT chroma and
     decode), ISS_TIMED_FRAMES timed frames, its GT area printed;
   - iss-gt-warped: tests/test_e2e_iss.py's GT configuration (16x16 CUs,
     QP 37) on a copy of its warped lenslet content at 1920x1088, where
     GT engages (the run fails if it never does), two timed frames;
   - pss-gt: the iss-gt configuration (search_range_t 16) on a low-delay
     holoscopic sequence of PSS_FRAMES pictures through
     HoloEncoder.encode_sequence, an ISS picture then PSS ones whose L0 is
     [the previous picture, the SS reference] (C9's temporal search in
     its scan launches, its pre-pass with the temporal arm, C10's and
     C12's PSS forms, C8 out of the previous picture), on a copy of
     make_jax_fixture.py's pss_frames (the lenslet frame panned one
     sample per frame): every picture hash_ok and equal to the recon
     history, temporal prediction chosen (each PSS picture's share
     printed); then PSS_TIMED_TURNS more codings of the sequence, each PSS
     picture timed;
   and for the two GT paths the GT tool's share of the encode, each path's
   encoder against a gt=False twin on its frame, in turns in one process;
   then C9's pre-pass entry on every block of the lenslet luma against
   its plain body (in chunks), with the temporal arm on every block of
   the pss-gt path's second picture, and one more encode and decode of
   each ISS path with its C8, C9, C10 and C4 launches held against the
   plain bodies (the fullest level of each size and every eighth level),
   and on the GT paths every launch of C9 (with its ring), C12 and C11;
   on the pss-gt path every launch of its PSS pictures' forms (C9's SS
   and temporal searches and its pre-pass, C10, C12) and every C8 and C11
   launch of the sequence, its ISS picture's other launches sampled as
   above;
4. cpu: small frames on the card and on the CPU (the path the CPU tests
   hold against the JAX reference), uniform CUs at cu_log2 3, 4 and 5 and
   the quadtree path at 8 and 10 bit and without RQT and NxN, RDOQ off,
   and the production configuration at 8 and 10 bit and on a noisy frame,
   and five small ISS cases (uniform 8x8 and 16x16 CUs, the quadtree with
   SAO, RDOQ on and off, deblocking off), and four small GT cases (16x16
   CUs, the quadtree with SAO, 10 bit, the bench's lenslet content): the
   streams must be byte-identical;
5. fixtures: the committed JAX streams under tests/torch_fixtures/ (intra,
   ISS and GT, and the JAX streams of the iss-gt, iss-gt-warped and
   pss-gt paths at 1920x1088) decode on the card with hash_ok and the
   stored per-plane MD5s (per picture), and the card's encoders write
   each one byte for byte from the same seeded frames (the full-size ones
   are the paths' own streams);
6. cli: two 1920x1088 frames through ``python -m hevc_hop_torch.utils.cli``
   encode (cfg/encoder_intra_main.cfg), decode and bytecount on the card:
   rc 0, the checksum SEI verified ([OK]), the decoded frames equal to the
   recon (see phase_cli for the recon file's fault R1); and one 1920x1088
   lenslet frame through ``-hi`` with cfg/3DHencoder_intra_main.cfg, whose
   bitstream must equal the iss-gt path's, and the pss-gt path's frames
   through ``-hi -f 3``, whose bitstream must equal that path's and whose
   recon file (each picture's recon) the decoded file; then the lenslet
   BD-rate of the
   port on the card (tools/bdrate.py's run_ours_iss configuration on its
   512x384 lenslet frame at QPs 22-37 against tests/golden/bdrate.json's
   HM anchors), which must stay under tests/test_bdrate.py's ceiling;
7. timing: every launch form of the three paths held against its plain
   version on the 1920x1088 frames' own schedules, 0 mismatching
   elements: the uniform path's RMD, chroma and decode-epilogue launches;
   on the production and quadtree paths, for the noisy frame and the main
   one, C2 with given modes and C3's encode (in its RDOQ arm on the
   production path) at every TU size (the DST at 4x4), the NxN carriers'
   4x4 chroma with their CU's first mode, chroma at 4x4 to 16x16, C2's
   decode epilogue for each, and the decoder's C3 launch per size and
   plane on the frame's own levels; the run fails if a form was never
   held. Then each kernel at the largest launch a path gives it (C2 and
   C3 once per path; C7 alone on the production path's fullest level's
   coefficients): its device time (torch.profiler, from a trace that
   holds every launch's record) beside the least time the card could
   take for the work its function needs (bytes, or int32 and float32
   operations by the algorithms HM uses), and the wrapper's and the
   plain version's time per call (CUDA events); then torch.profiler over
   one more encode and one more decode of each path for each kernel's
   device time per frame and the card's idle share. The kernels of the
   ISS paths get rows the same way: C9's scan entry (with a grouped
   float32 conv2d of the same windows as its library yardstick), its
   pre-pass entry, C10's two entries, C8's two forms and C4 with the ISS
   frame's inter maps; and those of the GT paths: C9's scan entry with
   the ring, C12's search and decide entries, and C11's two plane
   entries; and those of the PSS path, at its last picture's fullest
   32x32 level: C9's scan entry with the temporal search (a grouped
   conv2d of the temporal windows as its library yardstick), its pre-pass
   entry with the temporal arm, C10's PSS forms and C12's PSS decide.

It prints the card's name and power limit, one JSON line for the kernels,
one for the main paths, and as its last line
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
# float32 on the CUDA cores (NVIDIA data sheet, 67 TFLOP/s, an FMA counted
# as two operations)
PEAK_FP32_OPS = 67e12

W, H, QP = 1920, 1088, 32
TIMED_FRAMES = 6
QUADTREE_TIMED_FRAMES = 3
UNIFORM_TIMED_FRAMES = 3
# the frame whose partition goes down to 4x4: bench.py's content with five
# times its luma noise
NOISY = dict(seed=4, noise=25)
# kernel C5's float32 costs against the plain version's: the same formulas
# and the same order of sums, so a few units in the last place at most
COST_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def synth_class_b(w, h, seed=0, noise=5):
    """bench.py's synthetic class-B content (copied: this script imports
    nothing of the JAX package or its benchmark). ``noise`` is the luma
    noise's standard deviation, 5 in bench.py; more of it gives a frame
    whose partition goes down to 4x4."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
         + 25 * np.sin((xx + yy) / 7.0)
         + rng.normal(0, noise, (h, w))).clip(0, 255).astype(np.int32)
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

    def add_close(self, got, want, rtol, what):
        """float32 tensors that must agree within rtol; returns how many
        elements are not bit-equal."""
        require(got.shape == want.shape, f"{what}: shape")
        d = (got.double() - want.double()).abs()
        rel = float((d / want.double().abs().clamp(min=1e-30)).max())
        self.cases += 1
        self.err = max(self.err, float(d.max()))
        require(rel <= rtol, f"{what}: max relative error {rel} > {rtol}")
        return int((got != want).sum())


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
                cbf = fn(org, pred, pos, modes, n, c_idx, 22, 8, True, None,
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
        f"{k} {checks[k].cases} cases {checks[k].mism} mismatches"
        for k in ("C1", "C2", "C3", "C4")))


def rdoq_coefs(rng, b, n):
    """Seeded coefficient blocks for RDOQ: Laplacian magnitudes decaying
    toward high frequencies over three decades of scale, a twentieth of
    the blocks all zero and a twentieth at the +-32768 clamps."""
    scale = np.exp(rng.uniform(np.log(2), np.log(3000), (b, 1, 1)))
    yy, xx = np.mgrid[0:n, 0:n]
    dec = np.exp(-(xx + yy) * rng.uniform(0, 0.5, (b, 1, 1)))
    c = np.round(rng.laplace(0, 1, (b, n, n)) * scale * dec)
    c[:b // 20] = 0
    c[b // 20:b // 10] = rng.choice([-32768, 32767, 0, 5],
                                    (b // 10 - b // 20, n, n))
    return np.clip(c, -32768, 32767).astype(np.int32)


def phase_rdoq(checks):
    """Kernel C7 against its plain body on the card: every TU class (log2
    2..5, luma and chroma), every MDCS scan the class has, 8 and 10 bit,
    QP 22/27/32/37, init types 2, 3 and 4 (I, ISS, PSS); 0 mismatching
    levels."""
    import torch
    from hevc_hop_torch.models.partition import full_lambda
    from hevc_hop_torch.ops import rdoq
    dev = torch.device("cuda")
    c7 = checks["C7"]
    tus = 0
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        b = {2: 2048, 3: 1024, 4: 256, 5: 96}[log2]
        for c_idx in (0, 1):
            scans = (0, 1, 2) if not rdoq.single_scan(log2, c_idx) else (0,)
            for bd in (8, 10):
                for qp in (22, 27, 32, 37):
                    for init_type in (2, 3, 4):
                        rng = np.random.default_rng(
                            [log2, c_idx, bd, qp, init_type])
                        coef = torch.as_tensor(rdoq_coefs(rng, b, n),
                                               device=dev)
                        sid = torch.as_tensor(
                            np.resize(np.array(scans, np.int32), b),
                            device=dev)
                        lam = full_lambda(qp) * (2.0 ** (-1.0 / 3.0)
                                                 if c_idx else 1.0)
                        kw = dict(qp=qp, log2_size=log2, bit_depth=bd,
                                  c_idx=c_idx, init_type=init_type, lam=lam)
                        c7.add(rdoq.rdoq_quant(coef, sid, **kw),
                               rdoq.rdoq_quant_plain(coef, sid, **kw),
                               f"C7 log2={log2} c={c_idx} bd={bd} qp={qp} "
                               f"init_type={init_type}")
                        tus += b
    torch.cuda.synchronize()
    log(f"C7: {c7.cases} cases, {tus} TUs, {c7.mism} mismatching levels")


def _scaled(frame, bit_depth, dev):
    import torch
    return tuple(torch.as_tensor(
        (p * 4 + 1 if bit_depth == 10 else p).astype(np.int32), device=dev)
        for p in frame)


def _decide_args(rd, arm):
    """Arguments of partition._decide for one arm from rd[key] = (cost,
    mode) per size and rd["8f"], rd["16f"] (forced sub-TU costs)."""
    nxn, rqt = arm != "plain", arm == "rqt"
    return (rd[4][0] if nxn else None, rd[8][0], rd[16][0], rd[32][0],
            rd["8f"] if rqt else None, rd["16f"] if rqt else None,
            rd[4][1] if nxn else None, rd[8][1], rd[16][1], rd[32][1])


def mode_faults(kern, plain):
    """(blocks whose best mode differs between the kernel's (cost, mode)
    and the plain version's, how many of those are no near-tie). On a
    near-tie the two winners' costs are not bit-equal (equal costs go to
    the lower mode in both bodies) and agree within COST_RTOL."""
    differ = kern[1] != plain[1]
    ck, cp = kern[0][differ].double(), plain[0][differ].double()
    near = (ck != cp) & ((ck - cp).abs() <= COST_RTOL * cp.abs())
    return int(differ.sum()), int((~near).sum())


def decision_faults(kern_args, plain_args, got, ends, ctu=32):
    """(cells of depth8, mode4 and tulog8 that differ between the decision
    on the kernel's costs and the one on the plain version's, how many of
    those lie in a CTU where every cost and mode that went in is equal).
    The decision of a CTU reads that CTU's inputs only, and the two bodies
    decide alike on equal inputs, so a cell may differ only where an input
    does; the costs there were held to agree within COST_RTOL."""

    def per_ctu(mask, h):
        k = ctu * mask.shape[0] // h
        return mask.reshape(mask.shape[0] // k, k, mask.shape[1] // k,
                            k).any(3).any(1)

    # depth8 has one cell per 8x8 samples
    h = got[0].shape[0] * 8
    moved = None
    for a, b in zip(kern_args, plain_args):
        if a is not None:
            m = per_ctu(a != b, h)
            moved = m if moved is None else moved | m
    differ = faults = 0
    for g, w_ in zip(got, ends):
        if g is None:
            continue
        d = g != w_
        differ += int(d.sum())
        faults += int((per_ctu(d, h) & ~moved).sum())
    return differ, faults


def phase_partition_sao(checks):
    """Kernels C5 and C6 against their plain versions on the card, at the
    main path's shapes: the 1920x1088 luma plane at every block size, top
    three and forced; the three arms of the decision; SAO statistics and
    apply of the luma and chroma planes; 8 and 10 bit."""
    import torch
    from hevc_hop_torch.models import partition
    from hevc_hop_torch.ops import sao
    dev = torch.device("cuda")
    c5, c6 = checks["C5"], checks["C6"]
    rng = np.random.default_rng(2)
    up2 = lambda a: a.repeat_interleave(2, 0).repeat_interleave(
        2, 1).contiguous()
    ctx = {}
    for bd in (8, 10):
        y, cb, cr = _scaled(synth_class_b(W, H, seed=0), bd, dev)
        kern, plain = {}, {}
        tally = {"costs_not_bit_equal": 0, "modes_differ": 0,
                 "decision_cells_differ": 0}
        for n in (4, 8, 16, 32):
            kern[n] = partition.rd_costs(y, n, QP, bd)
            plain[n] = partition.rd_costs_plain(y, n, QP, bd)
            tally["costs_not_bit_equal"] += c5.add_close(
                kern[n][0], plain[n][0], COST_RTOL, f"C5 rd cost n={n}")
            differ, faults = mode_faults(kern[n], plain[n])
            tally["modes_differ"] += differ
            require(faults == 0, f"C5 rd n={n}: {faults} of {differ} blocks "
                    "whose modes differ are no near-tie")
        for n, parent in ((8, 16), (16, 32)):
            forced = up2(kern[parent][1])
            kern[f"{n}f"] = partition.rd_costs_forced(y, forced, n, QP, bd)
            plain[f"{n}f"] = partition.rd_costs_plain(y, n, QP, bd,
                                                      forced)[0]
            tally["costs_not_bit_equal"] += c5.add_close(
                kern[f"{n}f"], plain[f"{n}f"], COST_RTOL,
                f"C5 rd forced cost n={n}")
        for arm in ("plain", "nxn", "rqt"):
            args = _decide_args(kern, arm)
            got = partition._decide(*args, QP)
            # on the same costs the two bodies must decide the same
            for g, w_, nm in zip(got, partition.decide_plain(*args, QP),
                                 ("depth8", "mode4", "tulog8")):
                c5.add(g, w_, f"C5 decide {arm} {nm} bd={bd}")
            # the plain pipeline end to end
            plain_args = _decide_args(plain, arm)
            ends = partition.decide_plain(*plain_args, QP)
            differ, faults = decision_faults(args, plain_args, got, ends)
            tally["decision_cells_differ"] += differ
            require(faults == 0, f"C5 decide {arm}: {faults} of {differ} "
                    "cells that differ lie in a CTU whose costs and modes "
                    "are all equal")
        log(f"C5 bd={bd} against the plain pipeline (costs within "
            f"{COST_RTOL} relative): {json.dumps(tally)}; depth8 histogram "
            f"{torch.bincount(got[0].flatten(), minlength=4).tolist()}")

        lam = partition.full_lambda(QP)
        maxv = (1 << bd) - 1
        planes = []
        for org, ctb in ((y, 5), (cb, 4), (cr, 4)):
            noise = torch.as_tensor(rng.integers(-6, 7, tuple(org.shape)),
                                    dtype=torch.int32, device=dev)
            pre = (org + noise * (4 if bd == 10 else 1)).clamp(0, maxv)
            got = sao.sao_stats_plane(org, pre, ctb, bd)
            want = sao.sao_stats_plane_plain(org, pre, ctb, bd)
            for g, w_, nm in zip(got, want, ("eo_cnt", "eo_sum", "bo_cnt",
                                             "bo_sum")):
                c6.add(g, w_, f"C6 stats {nm} ctb_log2={ctb} bd={bd}")
            planes.append((org, pre, ctb, got))
        stats_np = [tuple(a.cpu().numpy() for a in st)
                    for _, _, _, st in planes]
        _, type3, off, band = sao.choose_sao_params(*stats_np, lam)
        require(type3.any(), "the SAO RDO turned no CTU on")
        maps = []
        for ci, (org, pre, ctb, _) in enumerate(planes):
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a).astype(
                np.int32), device=dev)
            shape = type3.shape[:2]
            rdo = (t(type3[:, :, ci]), t(off[:, :, ci]), t(band[:, :, ci]))
            # every type, and bands that wrap past 31
            anyp = (t(rng.integers(0, 6, shape)),
                    t(rng.integers(-7, 8, shape + (4,))),
                    t(rng.integers(0, 32, shape)))
            for nm, (tm, om, bm) in (("rdo", rdo), ("random", anyp)):
                c6.add(sao.apply_sao_plane(pre, tm, om, bm, ctb, bd),
                       sao.apply_sao_plane_plain(pre, tm, om, bm, ctb, bd),
                       f"C6 apply {nm} maps ctb_log2={ctb} bd={bd}")
            maps.append(rdo)
        if bd == 8:
            ctx = dict(y=y, kern=kern, planes=planes, maps=maps)
    torch.cuda.synchronize()
    log("kernels at the main path's shapes: " + ", ".join(
        f"{k} {checks[k].cases} cases {checks[k].mism} mismatches"
        for k in ("C5", "C6")))
    return ctx


def _counters():
    """(name, module, attribute) of every kernel's launch count; the
    kernels of csrc/tq.cu (encode, its RDOQ arm, decode), csrc/partition.cu,
    csrc/sao.cu, csrc/interp.cu (luma, chroma), csrc/ss_search.cu (scan,
    and among its launches those with the GT ring and those with the
    temporal search; pre-pass, and among them those with the temporal
    arm), csrc/inter_arms.cu (arms, motion, and among each the PSS form),
    csrc/warp.cu (window, luma, chroma) and csrc/gt_search.cu (search,
    decide, and among the latter the PSS form) count apart."""
    from hevc_hop_torch.models import partition, ss_partition
    from hevc_hop_torch.ops import (deblock, gt, hashes, inter_arms, interp,
                                    intra, rdoq, sao, ss_search, tq, warp)
    return [("C1", hashes, "LAUNCHES"), ("C2", intra, "LAUNCHES"),
            ("C3 encode", tq, "ENCODE_LAUNCHES"),
            ("C3 encode (RDOQ)", tq, "ENCODE_RDOQ_LAUNCHES"),
            ("C3 decode", tq, "DECODE_LAUNCHES"),
            ("C7", rdoq, "LAUNCHES"),
            ("C4", deblock, "LAUNCHES"),
            ("C5 rd", partition, "RD_LAUNCHES"),
            ("C5 decide", partition, "DECIDE_LAUNCHES"),
            ("C6 stats", sao, "STATS_LAUNCHES"),
            ("C6 apply", sao, "APPLY_LAUNCHES"),
            ("C8 luma", interp, "LUMA_LAUNCHES"),
            ("C8 chroma", interp, "CHROMA_LAUNCHES"),
            ("C9 search", ss_search, "SEARCH_LAUNCHES"),
            ("C9 ring", ss_search, "RING_LAUNCHES"),
            ("C9 temporal", ss_search, "TEMPORAL_LAUNCHES"),
            ("C9 prepass", ss_partition, "PREPASS_LAUNCHES"),
            ("C9 prepass temporal", ss_partition,
             "TEMPORAL_PREPASS_LAUNCHES"),
            ("C10 arms", inter_arms, "LAUNCHES"),
            ("C10 arms PSS", inter_arms, "PSS_LAUNCHES"),
            ("C10 motion", inter_arms, "MOTION_LAUNCHES"),
            ("C10 motion PSS", inter_arms, "PSS_MOTION_LAUNCHES"),
            ("C11 window", warp, "LAUNCHES"),
            ("C11 luma", warp, "LUMA_LAUNCHES"),
            ("C11 chroma", warp, "CHROMA_LAUNCHES"),
            ("C12 search", gt, "SEARCH_LAUNCHES"),
            ("C12 decide", gt, "DECIDE_LAUNCHES"),
            ("C12 decide PSS", gt, "PSS_DECIDE_LAUNCHES")]


PATHS = {
    # bench.py's production configuration: RDOQ (C7's device code in C3's
    # RDOQ arm) on every TU
    "production": (dict(sao=True), TIMED_FRAMES,
                   ("C1", "C2", "C3 encode (RDOQ)", "C3 decode", "C4",
                    "C5 rd", "C5 decide", "C6 stats", "C6 apply")),
    # the same with RDOQ off
    "quadtree": (dict(sao=True, rdoq=False), QUADTREE_TIMED_FRAMES,
                 ("C1", "C2", "C3 encode", "C3 decode", "C4", "C5 rd",
                  "C5 decide", "C6 stats", "C6 apply")),
    "uniform": (dict(cu_log2=4, rdoq=False), UNIFORM_TIMED_FRAMES,
                ("C1", "C2", "C3 encode", "C3 decode", "C4")),
}


def host_probes():
    """Two fixed pieces of host work, timed: (ms of a pure-Python loop, ms
    of 200 launches of a one-element fill and their synchronize). The main
    paths are bound by the host, whose speed moves between calls and
    within one; these say how fast it was beside each timed frame."""
    import torch
    t0 = time.perf_counter()
    acc = 0
    for i in range(100000):
        acc += i & 7
    t1 = time.perf_counter()
    x = _PROBE.setdefault("x", torch.zeros(1, device=torch.device("cuda")))
    for _ in range(200):
        x.zero_()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


_PROBE = {}


def log_host(where):
    """One line on the host's state: the two probes, the machine's load
    average, this process's threads, and the CPU time this process (all
    its threads) took per second of wall time since the last such line."""
    wall, cpu = time.perf_counter(), sum(os.times()[:2])
    w0, c0 = _PROBE.get("clock", (wall, cpu))
    _PROBE["clock"] = (wall, cpu)
    py_ms, launch_ms = host_probes()
    log("host " + json.dumps({
        "at": where, "t_s": wall - _PROBE.setdefault("t0", wall),
        "python_probe_ms": py_ms, "launch_probe_ms": launch_ms,
        "loadavg_1min": os.getloadavg()[0],
        "threads": len(os.listdir("/proc/self/task")),
        "cpu_s_per_wall_s": (cpu - c0) / (wall - w0) if wall > w0 else None}))


def _roundtrip(enc, frame, what):
    """One encode and its decode on the card, checked; returns (stream,
    seconds of the encode, seconds of the decode)."""
    import torch
    from hevc_hop_torch.models.decoder import Decoder
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = enc.encode_frame(*frame)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec = Decoder()
    (pic,) = dec.decode_stream(stream)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    require(dec.hash_ok == [True], f"{what}: hash_ok {dec.hash_ok}")
    for a, b, nm in zip(pic, enc.recon_yuv, ("y", "cb", "cr")):
        require(np.array_equal(a, b), f"{what}: decoded {nm} != recon")
    return stream, t1 - t0, t2 - t1


def phase_main_path(name):
    import torch
    from hevc_hop_torch.models import wavefront_scan
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    extra, timed, needed = PATHS[name]
    frame = synth_class_b(W, H, seed=0)
    enc = IntraEncoder(EncoderConfig(width=W, height=H, qp=QP, **extra))
    counters = _counters()
    for _, m, attr in counters:
        setattr(m, attr, 0)
    stream, e_s, d_s = _roundtrip(enc, frame, name)
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"{name} path launches: {launches}")
    require(all(launches[k] > 0 for k in needed),
            f"a kernel was not launched on the {name} path: {launches}")
    y = frame[0]
    mse = np.mean((enc.recon_yuv[0].astype(np.float64) - y) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    require(psnr > 25, f"Y-PSNR {psnr:.2f} dB")

    # timed: more frames each way, one after another (the first frame
    # built the schedule and loaded the kernels)
    enc_s, dec_s, probes = [], [], []
    for _ in range(timed):
        probes.append(host_probes())
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
    sched = next(reversed(wavefront_scan._SCHEDULES.values()))
    levels = int(sum(np.any([p.cnt > 0 for p in sched.plans.values()], 0)))
    blocks = {int(lg): int(p.cnt.sum()) for lg, p in sched.plans.items()}
    enc_med, dec_med = float(np.median(enc_s)), float(np.median(dec_s))
    out = {"frame": f"{W}x{H}", "qp": QP, "config": extra,
           "wavefront_levels": levels, "transform_blocks": blocks,
           "bytes": len(stream), "y_psnr_db": psnr,
           "first_encode_decode_s": e_s + d_s, "timed_frames": timed,
           "encode_s": enc_med, "encode_s_max": max(enc_s),
           "decode_s": dec_med, "decode_s_max": max(dec_s),
           "encode_fps": 1.0 / enc_med, "decode_fps": 1.0 / dec_med,
           "python_probe_ms": float(np.median([p[0] for p in probes])),
           "launch_probe_ms": float(np.median([p[1] for p in probes])),
           "last_stats": stats, "launches": launches}
    if name == "production":
        # distinct frames: each has its own partition, so its schedule is
        # built anew (the cache holds the frame above only)
        # bench.py's content at this QP codes nearly all of the frame as
        # 32x32 CUs; the last frame, with five times the noise, goes down
        # to NxN and split TUs
        fresh = []
        for seed, noise in ((1, 5), (2, 5), (3, 5),
                            (NOISY["seed"], NOISY["noise"])):
            other = synth_class_b(W, H, seed=seed, noise=noise)
            st, e1, d1 = _roundtrip(enc, other, f"{name} seed {seed}")
            sc = next(reversed(wavefront_scan._SCHEDULES.values()))
            fresh.append({
                "seed": seed, "noise": noise, "bytes": len(st),
                "encode_s": e1, "decode_s": d1,
                "transform_blocks": {int(lg): int(p.cnt.sum())
                                     for lg, p in sc.plans.items()},
                "wavefront_levels": int(sum(np.any(
                    [p.cnt > 0 for p in sc.plans.values()], 0))),
                "last_stats": dict(enc.last_stats)})
        out["distinct_frames"] = fresh
        log(f"{name} distinct frames: {json.dumps(fresh)}")
        enc.encode_frame(*frame)    # the profiled frame's recon and cache
    return out, dict(enc=enc, frame=frame, sched=sched)


def phase_cpu_parity():
    import torch
    from hevc_hop_torch.models import wavefront_scan
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    frame = synth_class_b(416, 240, seed=3)
    cases = [(frame, dict(width=416, height=240, cu_log2=cu))
             for cu in (3, 4, 5)]
    cases = [(fr, dict(kw, rdoq=False)) for fr, kw in cases]
    # the quadtree path at a small CTU-aligned size, RDOQ off and on (the
    # production configuration), and the production configuration on a
    # frame whose partition goes down to 4x4
    small = synth_class_b(256, 192, seed=4)
    for extra in (dict(sao=True, rdoq=False),
                  dict(sao=True, bit_depth=10, rdoq=False),
                  dict(sao=True, rqt=False, rdoq=False),
                  dict(sao=True, nxn=False, rdoq=False),
                  dict(sao=True), dict(sao=True, bit_depth=10),
                  dict(sao=True, noisy=True)):
        fr = small
        if extra.pop("noisy", False):
            fr = synth_class_b(256, 192, **NOISY)
        if extra.get("bit_depth") == 10:
            fr = tuple(p * 4 + 1 for p in small)
        cases.append((fr, dict(width=256, height=192, **extra)))
    for fr, kw in cases:
        cfg = EncoderConfig(qp=QP, **kw)
        g = IntraEncoder(cfg).encode_frame(*fr)
        c = IntraEncoder(cfg, device="cpu").encode_frame(*fr)
        require(g == c, f"card and CPU streams differ for {kw}")
        sc = next(reversed(wavefront_scan._SCHEDULES.values()))
        log(f"cpu parity: {kw} {len(g)} bytes identical, transform blocks "
            f"{ {int(lg): int(p.cnt.sum()) for lg, p in sc.plans.items()} }")
    # the lenslet ISS encoder: uniform 8x8 and 16x16 CUs, the quadtree with
    # SAO, RDOQ on and off, deblocking off
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    small = lenslet_frame(128, 96, mi=16)
    for fr, kw in (
            (synth_lenslet(96, 64, 13, seed=128),
             dict(width=96, height=64, cu_log2=4, mi_size=13)),
            (synth_lenslet(64, 64, 8, seed=91),
             dict(width=64, height=64, cu_log2=3, qp=27, mi_size=8,
                  search_range=24)),
            (small, dict(width=128, height=96, quadtree=True, sao=True,
                         mi_size=16)),
            (small, dict(width=128, height=96, quadtree=True, sao=True,
                         rdoq=False, mi_size=16)),
            (synth_lenslet(64, 64, 13, seed=9),
             dict(width=64, height=64, cu_log2=4, qp=30, mi_size=13,
                  search_range=24, deblocking=False))):
        cfg = HoloConfig(**dict(dict(qp=QP, gt=False), **kw))
        g = HoloEncoder(cfg).encode_frame(*fr)
        c = HoloEncoder(cfg, device="cpu").encode_frame(*fr)
        require(g == c, f"card and CPU ISS streams differ for {kw}")
        log(f"cpu parity: ISS {kw} {len(g)} bytes identical")
    # the GT warp on: the warped lenslet grid with 16x16 CUs, the quadtree
    # with SAO, 10-bit samples, and the bench's lenslet content with the
    # quadtree; GT engages in the first three
    warped = synth_warped_lenslet(96, 64, 16, seed=5)
    for fr, kw, engages in (
            (warped, dict(width=96, height=64, cu_log2=4, qp=37), True),
            (synth_warped_lenslet(128, 96, 16, seed=6),
             dict(width=128, height=96, quadtree=True, sao=True), True),
            (tuple(p * 4 for p in warped),
             dict(width=96, height=64, cu_log2=4, qp=37, bit_depth=10),
             True),
            (small, dict(width=128, height=96, quadtree=True, sao=True),
             False)):
        cfg = HoloConfig(**dict(dict(qp=QP, mi_size=16, gt=True), **kw))
        enc = HoloEncoder(cfg)
        g = enc.encode_frame(*fr)
        c = HoloEncoder(cfg, device="cpu").encode_frame(*fr)
        require(g == c, f"card and CPU GT streams differ for {kw}")
        gt_cus = int(enc.last_maps.gt8.sum())
        require(gt_cus > 0 or not engages, f"GT never engaged for {kw}")
        log(f"cpu parity: GT {kw} {len(g)} bytes identical, {gt_cus} GT CUs")
    torch.cuda.synchronize()


def phase_fixture():
    from hevc_hop_torch import convert
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import IntraEncoder
    for name in ("jax_intra_416x240_qp32", "jax_intra_sao_256x192_qp32",
                 "jax_intra_sao_nordoq_256x192_qp32"):
        base = os.path.join(ROOT, "tests", "torch_fixtures", name)
        with open(base + ".bin", "rb") as f:
            stream = f.read()
        with open(base + ".json") as f:
            meta = json.load(f)
        dec = Decoder()
        (planes,) = dec.decode_stream(stream)
        require(dec.hash_ok == [True], f"{name}: hash_ok {dec.hash_ok}")
        md5 = {k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
               for k, p in zip(("y", "cb", "cr"), planes)}
        require(md5 == meta["md5"], f"{name}: MD5s {md5}")
        log(f"fixture {name}: decoded with hash_ok and the stored MD5s")
        if "sao" in name or meta["config"]["rdoq"]:
            # the reference encoder's stream, from the same seeded frame
            cfg = convert.config_from_reference(meta["config"])
            frame = synth_class_b(cfg.width, cfg.height, seed=meta["seed"])
            got = IntraEncoder(cfg).encode_frame(*frame)
            require(got == stream, f"{name}: the card's encoder writes "
                    f"{len(got)} bytes that differ from the reference's "
                    f"{len(stream)}")
            log(f"fixture {name}: the card's encoder writes the "
                "reference's stream byte for byte")
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    for name in ("jax_iss_128x96_qp32", "jax_iss_quadtree_sao_128x96_qp32",
                 "jax_iss_gt_96x64_qp37"):
        base = os.path.join(ROOT, "tests", "torch_fixtures", name)
        with open(base + ".bin", "rb") as f:
            stream = f.read()
        with open(base + ".json") as f:
            meta = json.load(f)
        dec = Decoder()
        (planes,) = dec.decode_stream(stream)
        require(dec.hash_ok == [True], f"{name}: hash_ok {dec.hash_ok}")
        md5 = {k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
               for k, p in zip(("y", "cb", "cr"), planes)}
        require(md5 == meta["md5"], f"{name}: MD5s {md5}")
        cfg = HoloConfig(**meta["config"])
        if "synth_warped_lenslet" in meta["content"]:
            frame = synth_warped_lenslet(cfg.width, cfg.height, 16,
                                         seed=meta["seed"])
        else:
            frame = lenslet_frame(cfg.width, cfg.height, mi=16,
                                  seed=meta["seed"])
        got = HoloEncoder(cfg).encode_frame(*frame)
        require(got == stream, f"{name}: the card's ISS encoder writes "
                f"{len(got)} bytes that differ from the reference's "
                f"{len(stream)}")
        log(f"fixture {name}: decoded with hash_ok and the stored MD5s; the "
            "card's ISS encoder writes it byte for byte")


FULL_FIXTURES = {"iss-gt": "jax_iss_gt_1920x1088_qp32",
                 "iss-gt-warped": "jax_iss_gt_warped_1920x1088_qp37",
                 "pss-gt": "jax_pss_gt_1920x1088_qp32"}


def phase_full_fixtures(ctxs):
    """The JAX encoder's streams of the two GT paths and the PSS path at
    1920x1088 (tests/torch_fixtures/, made on a CPU by
    make_jax_fixture.py): each decodes on the card with hash_ok and its
    stored MD5s (one per picture), and the path's own stream, from the
    same configuration and seeded frames, equals it byte for byte."""
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.ss_encoder import HoloConfig
    out = {}
    for path, name in FULL_FIXTURES.items():
        base = os.path.join(ROOT, "tests", "torch_fixtures", name)
        with open(base + ".bin", "rb") as f:
            stream = f.read()
        with open(base + ".json") as f:
            meta = json.load(f)
        dec = Decoder()
        pics = dec.decode_stream(stream)
        want = meta["md5"] if isinstance(meta["md5"], list) else [
            meta["md5"]]
        require(dec.hash_ok == [True] * len(want),
                f"{name}: hash_ok {dec.hash_ok}")
        md5 = [{k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
                for k, p in zip(("y", "cb", "cr"), planes)}
               for planes in pics]
        require(md5 == want, f"{name}: MD5s {md5}")
        enc = ctxs[path]["enc"]
        require(enc.cfg == HoloConfig(**meta["config"])
                and meta["content"].endswith(ctxs[path]["content"]),
                f"{name}: not the {path} path's configuration and frame")
        got = ctxs[path]["stream"]
        first = next((i for i, (a, b) in enumerate(zip(got, stream))
                      if a != b), min(len(got), len(stream)))
        require(got == stream, f"{name}: the card's {path} stream "
                f"({len(got)} bytes) differs from the reference's "
                f"({len(stream)} bytes) from byte {first}")
        out[name] = {"bytes": len(stream), "md5": md5}
        log(f"fixture {name}: decoded with hash_ok and the stored MD5s; the "
            f"card's {path} path writes it byte for byte")
    return out


def phase_cli():
    """The user's entry point: two bench.py frames at 1920x1088 through
    ``python -m hevc_hop_torch.utils.cli`` encode (cfg/encoder_intra_main.cfg,
    on the card), decode and bytecount. Each must exit 0 and the decode
    must verify the checksum SEI ([OK]). The recon file holds the last
    frame for every frame (fault R1, kept as the reference has it), so the
    decoded file's last frame must equal the recon file's, and its first
    the encoder's first frame as the library encodes it."""
    import tempfile
    from hevc_hop_torch.io import yuv as yuvio
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    frames = [synth_class_b(W, H, seed=s) for s in (5, 6)]
    fsize = W * H * 3 // 2
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        src, bs, rec, dec = (os.path.join(tmp, f) for f in (
            "in.yuv", "out.bin", "rec.yuv", "dec.yuv"))
        yuvio.write_yuv420(src, frames)
        cli = [sys.executable, "-m", "hevc_hop_torch.utils.cli"]
        runs = {}
        for cmd in (["encode", "-c", os.path.join(ROOT, "cfg",
                                                 "encoder_intra_main.cfg"),
                     "-i", src, "-b", bs, "-o", rec, "-wdt", str(W),
                     "-hgt", str(H), "-f", "2"],
                    ["decode", "-b", bs, "-o", dec],
                    ["bytecount", "-b", bs]):
            t0 = time.perf_counter()
            out = subprocess.run(cli + cmd, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600)
            runs[cmd[0]] = time.perf_counter() - t0
            require(out.returncode == 0, f"cli {cmd[0]}: rc {out.returncode}"
                    f"\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
            if cmd[0] == "decode":
                require("[OK]" in out.stdout, f"cli decode: {out.stdout}")
            log(f"cli {cmd[0]}: " + " | ".join(
                out.stdout.strip().splitlines()[-2:]))
        with open(rec, "rb") as f:
            recon = f.read()
        with open(dec, "rb") as f:
            decoded = f.read()
        require(len(decoded) == len(recon) == 2 * fsize, "cli file sizes")
        require(recon[:fsize] == recon[fsize:], "cli recon: R1 no longer "
                "holds; compare the whole files")
        require(decoded[fsize:] == recon[fsize:],
                "cli: decoded last frame != recon")
        lib = IntraEncoder(EncoderConfig(width=W, height=H, qp=32, sao=True,
                                         hash_type=2))
        lib.encode_frame(*frames[0])
        first = b"".join(np.ascontiguousarray(p, np.uint8).tobytes()
                         for p in lib.recon_yuv)
        require(decoded[:fsize] == first, "cli: decoded first frame != the "
                "library's recon of it")
    log(f"cli: encode, decode and bytecount of 2 frames at {W}x{H}, "
        f"seconds per process {json.dumps(runs)}")
    return runs


def phase_cli_holo(ctxs):
    """The holoscopic CLI: one 1920x1088 lenslet frame through ``python -m
    hevc_hop_torch.utils.cli encode -c cfg/3DHencoder_intra_main.cfg -f 1``
    (the quadtree pre-pass, MI merge candidates, GT, SAO, RDOQ, the
    checksum SEI: the iss-gt path's configuration), decode and bytecount
    on the card. Each exits 0, the decode verifies the SEI, the decoded
    frame equals the recon file, and the bitstream equals the iss-gt
    path's. Then the pss-gt path's PSS_FRAMES frames through ``-f 3``
    (an ISS picture, then PSS ones): its bitstream equals the path's, and
    the recon file (each picture's recon) the decoded file."""
    out = {"iss-gt": _cli_holo(ctxs["iss-gt"], "-f 1")}
    out["pss-gt"] = _cli_holo(ctxs["pss-gt"], f"-f {PSS_FRAMES}")
    return out


def _cli_holo(ctx, what):
    import tempfile
    from hevc_hop_torch.io import yuv as yuvio
    frames = ctx.get("frames", [ctx["frame"]])
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        src, bs, rec, dec = (os.path.join(tmp, f) for f in (
            "in.yuv", "out.bin", "rec.yuv", "dec.yuv"))
        yuvio.write_yuv420(src, frames)
        cli = [sys.executable, "-m", "hevc_hop_torch.utils.cli"]
        runs = {}
        for cmd in (["encode", "-c", os.path.join(ROOT, "cfg",
                                                 "3DHencoder_intra_main.cfg"),
                     "-i", src, "-b", bs, "-o", rec, "-wdt", str(W),
                     "-hgt", str(H), "-f", str(len(frames))],
                    ["decode", "-b", bs, "-o", dec],
                    ["bytecount", "-b", bs]):
            t0 = time.perf_counter()
            out = subprocess.run(cli + cmd, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600)
            runs[cmd[0]] = time.perf_counter() - t0
            require(out.returncode == 0, f"cli -hi {what} {cmd[0]}: rc "
                    f"{out.returncode}\n{out.stdout[-2000:]}\n"
                    f"{out.stderr[-2000:]}")
            if cmd[0] == "decode":
                require("[OK]" in out.stdout,
                        f"cli -hi {what} decode: {out.stdout}")
            log(f"cli -hi {what} {cmd[0]}: " + " | ".join(
                out.stdout.strip().splitlines()[-2:]))
        with open(rec, "rb") as f:
            recon = f.read()
        with open(dec, "rb") as f:
            decoded = f.read()
        with open(bs, "rb") as f:
            stream = f.read()
    require(len(recon) == len(frames) * W * H * 3 // 2 and decoded == recon,
            f"cli -hi {what}: decoded frames != recon file")
    require(stream == ctx["stream"], f"cli -hi {what}: the bitstream "
            "differs from the path's")
    log(f"cli -hi {what}: encode, decode and bytecount of {len(frames)} "
        f"lenslet frame(s) at {W}x{H}, {len(stream)} bytes, seconds per "
        f"process {json.dumps(runs)}")
    return runs


# tools/bdrate.py's QPs and tests/test_bdrate.py's lenslet ceiling
BD_QPS = (22, 27, 32, 37)
BD_CEILING_LENSLET = 49.0


def psnr(a, b, maxv=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(maxv * maxv / mse)


def bd_rate(rate_a, psnr_a, rate_b, psnr_b):
    """tools/bdrate.py's Bjontegaard delta-rate of B against A (copied):
    cubic fits of log-rate over PSNR, integrated over the overlap; per
    cent, negative where B is better."""
    la, lb = np.log(rate_a), np.log(rate_b)
    pa = np.polyfit(psnr_a, la, 3)
    pb = np.polyfit(psnr_b, lb, 3)
    lo = max(min(psnr_a), min(psnr_b))
    hi = min(max(psnr_a), max(psnr_b))
    ia = np.polyval(np.polyint(pa), hi) - np.polyval(np.polyint(pa), lo)
    ib = np.polyval(np.polyint(pb), hi) - np.polyval(np.polyint(pb), lo)
    return (np.exp((ib - ia) / (hi - lo)) - 1.0) * 100.0


def phase_bdrate():
    """The port's lenslet BD-rate on the card: tools/bdrate.py's
    run_ours_iss configuration (quadtree, SAO, GT, MI 16, radius 32) on a
    copy of its lenslet_frame(512, 384) at QPs 22-37, against the HM
    anchors of tests/golden/bdrate.json (hm_lenslet_iss), with the
    weighted (6 Y + Cb + Cr) / 8 PSNR; it must stay under
    tests/test_bdrate.py's ceiling."""
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    with open(os.path.join(ROOT, "tests", "golden", "bdrate.json")) as f:
        hm = json.load(f)["hm_lenslet_iss"]
    require(tuple(hm["qps"]) == BD_QPS, "bdrate.json QPs")
    frame = lenslet_frame()
    h, w = frame[0].shape
    rates, wpsnrs, ypsnrs = [], [], []
    for qp in BD_QPS:
        enc = HoloEncoder(HoloConfig(width=w, height=h, qp=qp, mi_size=16,
                                     gt=True, search_range=32, quadtree=True,
                                     sao=True))
        stream = enc.encode_frame(*frame)
        rec = enc.recon_yuv
        p = [psnr(a, b) for a, b in zip(frame, rec)]
        rates.append(len(stream))
        wpsnrs.append((6 * p[0] + p[1] + p[2]) / 8.0)
        ypsnrs.append(p[0])
    bdr = float(bd_rate(hm["bytes"], hm["wpsnr"], rates, wpsnrs))
    out = {"frame": f"lenslet_frame({w}, {h}, mi=16, seed=5)",
           "qps": list(BD_QPS), "bytes": rates, "wpsnr": wpsnrs,
           "ypsnr": ypsnrs, "bdrate_vs_hm_pct": bdr,
           "ceiling_pct": BD_CEILING_LENSLET}
    log(f"bdrate: {json.dumps(out)}")
    require(bdr < BD_CEILING_LENSLET, f"lenslet BD-rate {bdr:+.2f} % is over "
            f"the ceiling of {BD_CEILING_LENSLET}")
    return out


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


def given_mode_ops(n):
    """Kernel C2 with the mode given, one n x n luma block: the reference
    smoothing and one prediction (an angular row's five operations per
    sample)."""
    return (4 * (4 * n - 1) if n > 4 else 0) + 5 * n * n


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


def partition_rd_ops(n, top):
    """Kernel C5's RD entry on one n x n block: with the search, the 35
    predictions, their SATDs and the choice of the top three (as C2's RMD
    counts them); then per candidate the prediction (five operations per
    sample, an angular row), C3's encode chain without SBH's parity, the
    squared error and its sum (three per sample) and the rate sum (two per
    sample; the log2 of each nonzero level depends on the data and is left
    out), and the cost and its comparison."""
    nn = n * n
    cands = 3 if top else 1
    search = rmd_ops(n) + 2 * 35 if top else 0
    return search + cands * (5 * nn + tq_encode_ops(n) - 2 * nn + 3 * nn
                             + 2 * nn + 3)


def rdoq_ops(n):
    """(int32, float32) operations of RDOQ on one n x n block, by the
    reference's algorithm, per coefficient: int32 ones for the scan gather
    and round-half level (5), last_pos (1), the c1/c2 counts, four Rice
    passes and context indices (24), the two candidates' rate terms (16),
    the level choice (4) and the signed scatter (2); float32 ones for the
    uncoded cost (3), the two candidates' costs (11 each, a fused
    multiply-add counted twice), the zero cost and the sig costs (4), the
    comparisons and the kept cost (5), the group sums (3) and the
    tournament's scans and total (17)."""
    nn = n * n
    return 52 * nn, 54 * nn


def bound(nbytes, ops):
    """Least time (ms) of the work and what bounds it. ``ops`` is int32
    operations, or (int32, float32) operations: the CUDA cores run the two
    at 33.5 and 67 T/s, and the floor is the larger of the two times."""
    if isinstance(ops, tuple):
        to = max(ops[0] / PEAK_INT32_OPS, ops[1] / PEAK_FP32_OPS) * 1e3
    else:
        to = ops / PEAK_INT32_OPS * 1e3
    tb = nbytes / PEAK_BYTES * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _padded_planes(enc, frame, recon):
    """(recon luma [H+pad, W], stacked cb/cr recon, original luma, stacked
    original chroma) on the card, laid out as the level loop holds them."""
    import torch
    dev = torch.device("cuda")
    pad = 1 << enc.cfg.ctb_log2
    up = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    gap = torch.zeros((pad, W // 2), dtype=torch.int32, device=dev)
    stack = lambda a, b: torch.cat([a, gap, b, gap])
    ry, rcb, rcr = recon
    plane = torch.zeros((H + pad, W), dtype=torch.int32, device=dev)
    plane[:H] = ry
    org = torch.zeros_like(plane)
    org[:H] = up(frame[0])
    rc, org_c = stack(rcb, rcr), stack(up(frame[1]), up(frame[2]))
    require(rc.shape[0] == 2 * (H // 2 + pad), "stacked chroma plane")
    return plane, rc, org, org_c


def rdoq_configs(use_rdoq):
    """(luma, chroma) RDOQ configurations of tq_encode at QP, as the level
    loop builds them (models/wavefront_scan.py scan_encode), or Nones."""
    from hevc_hop_torch.common import rom
    from hevc_hop_torch.models.partition import full_lambda
    if not use_rdoq:
        return None, None
    qpc = rom.chroma_qp_from_luma(QP)
    lam = full_lambda(QP)
    return (2, lam), (2, lam * 2.0 ** ((qpc - QP) / 3.0))


def _hold_block_launches(planes, p, s, sc, luma_modes, chroma_modes, rmd,
                         checks, what, seen, use_rdoq=False):
    """The launches of one level of the scan for the blocks of plan ``p``,
    kernel against plain version on the same inputs: C2's luma prediction
    (35-mode RMD where ``rmd``, else the given modes) at level ``s``, C3's
    luma encode, C2's chroma prediction and C3's chroma encode on the
    stacked cb/cr plane at level ``sc`` (cb and cr blocks share one row of
    availability and mode; at 4x4 only the NxN carriers code chroma, with
    their CU's first mode), and C2's decode epilogue for both. With
    ``use_rdoq``, C3's encode runs its RDOQ arm (C7's device code)."""
    import torch
    from hevc_hop_torch.common import rom
    from hevc_hop_torch.ops import intra, tq
    rcfg = rdoq_configs(use_rdoq)
    enc_form = "C3 encode (RDOQ)" if use_rdoq else "C3 encode"
    plane, rc, org, org_c = planes
    dev = plane.device
    c2, c3 = checks["C2"], checks["C3"]
    n = p.n
    o, c = int(p.off[s]), int(p.cnt[s])
    pos, avail = p.pos[o:o + c], p.avail[o:o + c]
    if rmd:
        ask = torch.full((c,), -1, dtype=torch.int32, device=dev)
        got = intra.intra_blocks(plane, pos, avail, ask, n, 0, org=org)
        want = intra.intra_blocks_plain(plane, pos, avail, ask, n, 0,
                                        org=org)
        c2.add(got[1], want[1], f"C2 {what} luma {n}x{n} RMD modes")
        best = want[1]
    else:
        best = luma_modes[o:o + c]
        got = intra.intra_blocks(plane, pos, avail, best, n, 0)
        want = intra.intra_blocks_plain(plane, pos, avail, best, n, 0)
    c2.add(got[0], want[0], f"C2 {what} luma {n}x{n} prediction")
    seen.add(("C2 luma", n))
    cases = [("luma", plane, org, pos, avail, best, n, 0, QP, rcfg[0])]
    cc = int(p.ccnt[sc])
    if cc:
        co = int(p.coff[sc])
        nc = 4 if n == 4 else n // 2
        cmode = best
        if chroma_modes is not None:
            cmode = chroma_modes[co // 2:co // 2 + cc]
        else:
            require(sc == s, "chroma follows its own block's luma mode")
        cases.append(("carrier chroma" if n == 4 else "chroma", rc, org_c,
                      p.cpos[co:co + 2 * cc], p.cavail[co // 2:co // 2 + cc],
                      cmode, nc, 1, rom.chroma_qp_from_luma(QP), rcfg[1]))
    g = torch.Generator(device="cpu").manual_seed(5)
    for nm, pl, og, bp, av, md, sz, c_idx, qp, rq in cases:
        if c_idx:
            got = intra.intra_blocks(pl, bp, av, md, sz, 1)[0]
            want = intra.intra_blocks_plain(pl, bp, av, md, sz, 1)
            c2.add(got, want[0], f"C2 {what} {nm} {sz}x{sz} prediction")
            seen.add((f"C2 {nm}", sz))
        pred = want[0]
        outs = []
        for fn in (tq.tq_encode, tq.tq_encode_plain):
            rec = torch.zeros_like(pl)
            cp = torch.zeros(pl.shape, dtype=torch.int16, device=dev)
            cbf = fn(og, pred, bp, md, sz, c_idx, qp, 8, True, rq, rec, cp)
            outs.append((rec, cp, cbf))
        for i, part in enumerate(("recon", "levels", "cbf")):
            (checks["C7"] if rq else c3).add(
                outs[0][i], outs[1][i],
                f"{enc_form} {what} {nm} {sz}x{sz} encode {part}")
        seen.add((f"{enc_form} {nm}", sz))
        resi = torch.randint(-60, 61, pl.shape, generator=g,
                             dtype=torch.int32).to(dev)
        pk, pp = pl.clone(), pl.clone()
        intra.intra_blocks(pk, bp, av, md, sz, c_idx, resi=resi)
        intra.intra_blocks_plain(pp, bp, av, md, sz, c_idx, resi=resi)
        c2.add(pk, pp, f"C2 {what} {nm} {sz}x{sz} decode epilogue")
        seen.add((f"C2 decode {nm}", sz))


def _replay_uniform(ctx, checks):
    """The uniform path's launch forms at its fullest level."""
    enc, sched = ctx["enc"], ctx["sched"]
    p = sched.plans[4]
    s = int(np.argmax(p.cnt))
    planes = _padded_planes(enc, ctx["frame"], enc._recon_dev)
    _hold_block_launches(planes, p, s, s, None, None, True, checks,
                         "uniform path", set())


def _replay_quadtree(enc, frame, checks, what):
    """Every launch form of the quadtree path (or, where ``enc`` has RDOQ
    on, the production path) on ``frame``'s own schedule: per TU size, the
    fullest level of the given-modes scan (luma, and the level with the
    most chroma blocks), and the decoder's dequantize and inverse transform
    of all TUs of each size of each plane, on the frame's own levels.
    Returns the set of (form, size) held."""
    import torch
    from hevc_hop_torch.common import rom
    from hevc_hop_torch.ops import tq
    st = enc._stage1(*frame)
    enc._stage2(st)
    sched, maps = st["sched"], st["maps"]
    modes = enc._given_modes(sched, maps.mode4.astype(np.int32))
    planes = _padded_planes(enc, frame, st["recon"])
    seen = set()
    for log2, p in sched.plans.items():
        if p.cnt.sum() == 0:
            continue
        _hold_block_launches(planes, p, int(np.argmax(p.cnt)),
                             int(np.argmax(p.ccnt)), modes[log2][0],
                             modes[log2][1], False, checks, what, seen,
                             enc.cfg.rdoq)
    dev = torch.device("cuda")
    luma_pos, chroma_pos = sched.tu_pos
    c3 = checks["C3"]
    for nm, coef, by_size, qp in (
            ("luma", maps.coef_y, luma_pos, QP),
            ("cb", maps.coef_cb, chroma_pos, rom.chroma_qp_from_luma(QP)),
            ("cr", maps.coef_cr, chroma_pos, rom.chroma_qp_from_luma(QP))):
        cp = torch.as_tensor(coef).to(dev)
        for log2, pos in sorted(by_size.items()):
            dst = nm == "luma" and log2 == 2
            outs = [fn(cp, pos, 1 << log2, qp, 8, dst,
                       torch.zeros(cp.shape, dtype=torch.int32, device=dev))
                    for fn in (tq.tq_decode, tq.tq_decode_plain)]
            c3.add(*outs, f"C3 {what} {nm} {1 << log2}x{1 << log2} decode of "
                   f"{pos.shape[0]} TUs")
            seen.add((f"C3 decode {nm}", 1 << log2))
    torch.cuda.synchronize()
    return seen, st


# every launch form the quadtree path has: luma at the four TU sizes (the
# DST at 4x4), the NxN carriers' 4x4 chroma, chroma at 4x4 to 16x16; the
# production path has the same with C3's RDOQ arm
QUADTREE_FORMS = {(f, n) for fs, ns in (
    (("C2 luma", "C3 encode luma", "C2 decode luma", "C3 decode luma"),
     (4, 8, 16, 32)),
    (("C2 carrier chroma", "C3 encode carrier chroma",
      "C2 decode carrier chroma"), (4,)),
    (("C2 chroma", "C3 encode chroma", "C2 decode chroma", "C3 decode cb",
      "C3 decode cr"), (4, 8, 16))) for f in fs for n in ns}
PRODUCTION_FORMS = {(f.replace("C3 encode", "C3 encode (RDOQ)"), n)
                    for f, n in QUADTREE_FORMS}


def phase_timing(ctxs, ps, checks, launches):
    """First every launch form of both main paths is held against its
    plain version at the path's own shapes. Then each kernel, at the
    largest launch a main path gives it (C2 and C3 encode: the fullest
    wavefront level of the uniform path, 16x16 with RMD, and of the
    quadtree path, 32x32 with given modes; C3 decode, C4, C1, C5 and C6:
    the whole frame), is held again and timed beside its plain version.
    ``ps`` holds phase_partition_sao's inputs."""
    import torch
    from hevc_hop_torch.models import partition
    from hevc_hop_torch.ops import deblock, hashes, intra, sao, tq
    dev = torch.device("cuda")
    _replay_uniform(ctxs["uniform"], checks)
    noisy = synth_class_b(W, H, **NOISY)
    replays = {}
    for name, forms in (("production", PRODUCTION_FORMS),
                        ("quadtree", QUADTREE_FORMS)):
        enc = ctxs[name]["enc"]
        seen, _ = _replay_quadtree(enc, noisy, checks,
                                   f"{name} path, noisy frame")
        more, replays[name] = _replay_quadtree(enc, ctxs[name]["frame"],
                                               checks, f"{name} path")
        missing = sorted(forms - (seen | more))
        log(f"launch forms of the {name} path held at {W}x{H}: "
            f"{len(seen | more)} (form, size) pairs, missing {missing}")
        require(not missing, f"{name}: launch forms never held: {missing}")
    qt = ctxs["quadtree"]
    st = replays["quadtree"]

    enc = ctxs["uniform"]["enc"]
    sched = ctxs["uniform"]["sched"]
    frame = ctxs["uniform"]["frame"]
    tu4 = sched.tu4_dev
    ry, rcb, rcr = enc._recon_dev
    plane, _, org, _ = _padded_planes(enc, frame, enc._recon_dev)
    bufs = {k: (torch.zeros_like(org),
                torch.zeros(org.shape, dtype=torch.int16, device=dev),
                torch.zeros((H, W), dtype=torch.int32, device=dev))
            for k in ("kernel", "plain")}
    specs = []

    def spec(name, counter, path, kernel, shape, source, replaces, fn, plain,
             nbytes, ops):
        specs.append(dict(name=name, counter=counter, path=path,
                          kernel=kernel, shape=shape, source=source,
                          replaces=replaces, fn=fn, plain=plain,
                          nbytes=nbytes, ops=ops))

    def scan_level(path, p, luma_modes, pl, use_rdoq=False):
        """Rows of C2 and C3 encode at the fullest level of plan ``p``;
        with ``use_rdoq``, of C3's RDOQ arm and of C7 alone on the same
        blocks' coefficients instead."""
        n = p.n
        s = int(np.argmax(p.cnt))
        o, c = int(p.off[s]), int(p.cnt[s])
        pos, avail = p.pos[o:o + c], p.avail[o:o + c]
        if luma_modes is None:
            ask = torch.full((c,), -1, dtype=torch.int32, device=dev)
            kw = dict(org=org)
            form, c2ops = "35-mode RMD", rmd_ops(n)
            c2bytes = 4 * n * n * 2 + 4 * (4 * n + 1) + 4 * n + 1 + 16
        else:
            ask, kw = luma_modes[o:o + c], {}
            form, c2ops = "given mode", given_mode_ops(n)
            c2bytes = 4 * n * n + 4 * (4 * n + 1) + 4 * n + 1 + 12
        pred, best = intra.intra_blocks(pl, pos, avail, ask, n, 0, **kw)
        best = ask if best is None else best
        if use_rdoq:
            rdoq_rows(path, n, c, pos, pred, best)
            return
        spec(f"C2 intra ({'RMD' if luma_modes is None else 'given mode'})",
             "C2", path, "intra_kernel",
             f"{c} luma blocks of {n}x{n}, {form}",
             "hevc_hop_torch/csrc/intra.cu", "hevc_hop_tpu/ops/intra.py:124",
             lambda: intra.intra_blocks(pl, pos, avail, ask, n, 0, **kw),
             lambda: intra.intra_blocks_plain(pl, pos, avail, ask, n, 0,
                                              **kw),
             c * c2bytes, c * c2ops)

        def tq_enc(fn, k):
            rec, cp, _ = bufs[k]
            return fn(org, pred, pos, best, n, 0, QP, 8, True, None, rec,
                      cp), rec, cp

        spec(f"C3 tq (encode, {n}x{n})", "C3 encode", path,
             "tq_encode_kernel", f"{c} luma blocks of {n}x{n}, encode entry",
             "hevc_hop_torch/csrc/tq.cu", "hevc_hop_tpu/ops/quant.py:54",
             lambda: tq_enc(tq.tq_encode, "kernel"),
             lambda: tq_enc(tq.tq_encode_plain, "plain"),
             c * (n * n * (4 + 4 + 4 + 2) + 16), c * tq_encode_ops(n))

    def rdoq_rows(path, n, c, pos, pred, best):
        """C3's encode entry in its RDOQ arm, and C7 alone on the forward
        transform of the same blocks' residuals."""
        from hevc_hop_torch.ops import rdoq, transform
        rcfg = rdoq_configs(True)[0]

        def tq_enc(fn, k):
            rec, cp, _ = bufs[k]
            return fn(org, pred, pos, best, n, 0, QP, 8, True, rcfg, rec,
                      cp), rec, cp

        ri, rf = rdoq_ops(n)
        spec(f"C3 tq (encode, RDOQ, {n}x{n})", "C3 encode (RDOQ)", path,
             "tq_encode_rdoq_kernel",
             f"{c} luma blocks of {n}x{n}, encode entry, RDOQ arm",
             "hevc_hop_torch/csrc/tq.cu", "hevc_hop_tpu/ops/rdoq.py:214",
             lambda: tq_enc(tq.tq_encode, "kernel"),
             lambda: tq_enc(tq.tq_encode_plain, "plain"),
             c * (n * n * (4 + 4 + 4 + 2) + 16),
             (c * (tq_encode_ops(n) - 7 * n * n + ri), c * rf))
        rows_, cols_ = intra.block_index(pos, n)
        coef = transform.fwd_transform(org[rows_, cols_] - pred, 8,
                                       False).contiguous()
        sid = torch.zeros(c, dtype=torch.int32, device=dev)
        kw = dict(qp=QP, log2_size=n.bit_length() - 1, bit_depth=8,
                  c_idx=0, init_type=2, lam=rcfg[1])
        spec(f"C7 rdoq ({n}x{n})", "C7", path, "rdoq_quant_kernel",
             f"{c} luma blocks of {n}x{n}, standalone entry",
             "hevc_hop_torch/csrc/rdoq.cu", "hevc_hop_tpu/ops/rdoq.py:214",
             lambda: rdoq.rdoq_quant(coef, sid, **kw),
             lambda: rdoq.rdoq_quant_plain(coef, sid, **kw),
             c * (n * n * (4 + 4) + 4), (c * ri, c * rf))

    def decode_all(path, pos, n, levels):
        nb = pos.shape[0]
        spec(f"C3 tq (decode, {n}x{n})", "C3 decode", path,
             "tq_decode_kernel", f"{nb} luma blocks of {n}x{n}, decode entry",
             "hevc_hop_torch/csrc/tq.cu", "hevc_hop_tpu/models/decoder.py:30",
             lambda: tq.tq_decode(levels, pos, n, QP, 8, False,
                                  bufs["kernel"][2]),
             lambda: tq.tq_decode_plain(levels, pos, n, QP, 8, False,
                                        bufs["plain"][2]),
             nb * (n * n * (2 + 4) + 8), nb * tq_decode_ops(n))

    scan_level("uniform", sched.plans[4], None, plane)
    # the uniform frame's levels, for the decode entry: every 16x16 block
    # of the original predicted by the (deblocked) recon
    n = 16
    ys, xs = np.mgrid[0:H:n, 0:W:n]
    grid = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], -1),
                           dtype=torch.int32, device=dev)
    fpred = ry.reshape(H // n, n, W // n, n).transpose(1, 2).reshape(
        -1, n, n).contiguous()
    coef = torch.zeros(org.shape, dtype=torch.int16, device=dev)
    tq.tq_encode(org, fpred, grid, torch.zeros(1, dtype=torch.int32,
                                               device=dev), n, 0, QP, 8,
                 True, None, torch.zeros_like(org), coef)
    decode_all("uniform", grid, n, coef[:H].contiguous())
    # the quadtree path's own frame: its 32x32 TUs, modes and levels
    qsched, qmaps = st["sched"], st["maps"]
    qplane = _padded_planes(qt["enc"], qt["frame"], st["recon"])[0]
    qmodes = qt["enc"]._given_modes(qsched, qmaps.mode4.astype(np.int32))
    scan_level("quadtree", qsched.plans[5], qmodes[5][0], qplane)
    # the production path's own frame: its 32x32 TUs and modes
    pe, pst = ctxs["production"]["enc"], replays["production"]
    pmodes = pe._given_modes(pst["sched"], pst["maps"].mode4.astype(np.int32))
    scan_level("production", pst["sched"].plans[5], pmodes[5][0],
               _padded_planes(pe, ctxs["production"]["frame"],
                              pst["recon"])[0], use_rdoq=True)
    decode_all("quadtree", qsched.tu_pos[0][5], 32,
               torch.as_tensor(qmaps.coef_y).to(dev))

    npx = H * W * 3 // 2
    spec("C4 deblock", "C4", "uniform", "deblock_kernel",
         f"{W}x{H} frame, both passes", "hevc_hop_torch/csrc/deblock.cu",
         "hevc_hop_tpu/ops/deblock.py:166",
         lambda: deblock.deblock_frame(ry, rcb, rcr, tu4, QP, 31),
         lambda: deblock.deblock_frame_plain(ry, rcb, rcr, tu4, QP, 31),
         2 * 4 * npx + tu4.numel(), 2 * 40 * npx // 4)
    spec("C1 checksum", "C1", "uniform", "checksum_kernel",
         f"{W}x{H} frame, three planes", "hevc_hop_torch/csrc/checksum.cu",
         "hevc_hop_tpu/ops/hashes.py:18",
         lambda: hashes.plane_checksums([ry, rcb, rcr]),
         lambda: [hashes._checksum_plain(q, 8) for q in (ry, rcb, rcr)],
         4 * npx + 12, 10 * npx)
    # C5 and C6 on the whole frame (inputs of phase_partition_sao, 8 bit)
    yq, kern = ps["y"], ps["kern"]
    (oy, py_, _, _), (tm, om, bm) = ps["planes"][0], ps["maps"][0]
    nb4 = (H // 4) * (W // 4)
    rqt = _decide_args(kern, "rqt")
    grids = sum(t.numel() for t in rqt)
    ctus = (H // 32) * (W // 32)
    spec("C5 partition (rd)", "C5 rd", "quadtree", "partition_rd_kernel",
         f"{nb4} blocks of 4x4 of the {W}x{H} luma plane, top-3 search",
         "hevc_hop_torch/csrc/partition.cu",
         "hevc_hop_tpu/models/partition.py:64",
         lambda: partition.rd_costs(yq, 4, QP, 8),
         lambda: partition.rd_costs_plain(yq, 4, QP, 8),
         4 * H * W + 8 * nb4, nb4 * partition_rd_ops(4, True))
    spec("C5 partition (decide)", "C5 decide", "quadtree",
         "partition_decide_kernel",
         f"{ctus} CTUs of the {W}x{H} frame, NxN and RQT arms",
         "hevc_hop_torch/csrc/partition.cu",
         "hevc_hop_tpu/models/partition.py:247",
         lambda: partition._decide(*rqt, QP),
         lambda: partition.decide_plain(*rqt, QP),
         4 * grids + 4 * (2 * (H // 8) * (W // 8) + nb4), 400 * ctus)
    spec("C6 sao (stats)", "C6 stats", "quadtree", "sao_stats_kernel",
         f"{W}x{H} luma plane, 32x32 CTUs", "hevc_hop_torch/csrc/sao.cu",
         "hevc_hop_tpu/ops/sao.py:100",
         lambda: sao.sao_stats_plane(oy, py_, 5, 8),
         lambda: sao.sao_stats_plane_plain(oy, py_, 5, 8),
         2 * 4 * H * W + 96 * 4 * ctus, 60 * H * W)
    spec("C6 sao (apply)", "C6 apply", "quadtree", "sao_apply_kernel",
         f"{W}x{H} luma plane, 32x32 CTUs", "hevc_hop_torch/csrc/sao.cu",
         "hevc_hop_tpu/ops/sao.py:58",
         lambda: sao.apply_sao_plane(py_, tm, om, bm, 5, 8),
         lambda: sao.apply_sao_plane_plain(py_, tm, om, bm, 5, 8),
         2 * 4 * H * W + 6 * 4 * ctus, 20 * H * W)
    return _time_specs(specs, checks, launches)


def _time_specs(specs, checks, launches):
    """Each spec's kernel held once more against its plain version, then
    timed: device ms from a complete profiler trace, the wrapper's and the
    plain version's ms per call (CUDA events), the bound, and the library
    call's ms where the spec names one; one row of the kernels line each."""
    import torch
    rows = []
    for sp in specs:
        name, counter, fn, plain = (sp[k] for k in ("name", "counter", "fn",
                                                    "plain"))
        check = checks[counter.split()[0]]
        got, want = fn(), plain()
        torch.cuda.synchronize()
        for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            if g is None:
                continue
            if torch.is_tensor(g) and g.is_floating_point():
                check.add_close(g, w_, COST_RTOL,
                                f"{name} at the main path's shape")
            elif sp.get("rtol"):
                check.add_close(g, w_, sp["rtol"],
                                f"{name} at the main path's shape")
            else:
                check.add(g, w_, f"{name} at the main path's shape")
        # the plain bodies of these take seconds
        slow = counter in ("C5 rd", "C9 prepass", "C9 search", "C9 ring",
                           "C10 arms", "C12 search", "C12 decide",
                           "C9 temporal", "C9 prepass temporal",
                           "C10 arms PSS", "C12 decide PSS")
        call_ms = time_ms(fn, reps=3 if slow else 7, inner=3 if slow else 10)
        pms = time_ms(plain, reps=1 if slow else 5, inner=1)
        # the kernel's own device time per call: a call of these small
        # launches is bound by the host, so call_ms is mostly Python. A
        # trace now and then lacks some of the launches' records, so one
        # counts only if it holds them all
        inner, ms, traces = 10, None, 0
        while ms is None and traces < 6:
            traces += 1
            prof = _profile(lambda: [fn() for _ in range(inner)])
            count = prof["kernel_calls"][sp["kernel"]]
            per_call = count // inner
            if count and count == per_call * inner:
                ms = prof["kernel_ms"][sp["kernel"]] / inner
            else:
                log(f"{name}: trace {traces} holds {count} records of "
                    f"{sp['kernel']} for {inner} calls; traced again")
        require(ms is not None and ms > 0,
                f"no complete trace of {sp['kernel']} in {traces} tries")
        b_ms, by = bound(sp["nbytes"], sp["ops"])
        launched, fused = counter, {}
        if counter == "C7":
            # on the main paths C7's device code (rdoq_block) runs inside
            # C3's RDOQ arm, so its launches there are that arm's; only
            # this comparison launches the standalone entry
            launched = "C3 encode (RDOQ)"
            fused = {"launched_in": launched,
                     "frame_kernel": "tq_encode_rdoq_kernel",
                     "standalone_launches_by_path": {
                         k: v[counter] for k, v in launches.items()}}
        rows.append({"name": name, "route": "cuda", "source": sp["source"],
                     "replaces": sp["replaces"], "path": sp["path"],
                     "kernel": sp["kernel"],
                     "launches": launches[sp["path"]][launched],
                     "launches_by_path": {k: v[launched]
                                          for k, v in launches.items()},
                     "max_abs_err": check.err, "mismatches": check.mism,
                     "ms": ms, "kernel_ms": ms, "call_ms": call_ms,
                     "profile_traces": traces,
                     "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": (time_ms(sp["library"])
                                    if sp.get("library") else None),
                     "library_call": sp.get("library_call"),
                     "shape": sp["shape"], **fused})
    return rows


# ---------------------------------------------------------------------------
# The lenslet ISS slice: kernels C8, C9, C10 and C4's inter arm.

# bench.py:88-100's lenslet cell at 1920x1088 with the GT warp off
ISS_CONFIG = dict(qp=QP, mi_size=16, search_range=32, quadtree=True,
                  sao=True, rdoq=True, sbh=True, gt=False)
ISS_TIMED_FRAMES = 3
_ISS_KERNELS = ("C1", "C2", "C3 encode (RDOQ)", "C3 decode", "C4", "C8 luma",
                "C8 chroma", "C9 search", "C10 arms", "C10 motion")
_GT_KERNELS = ("C9 ring", "C11 luma", "C11 chroma", "C12 search",
               "C12 decide")
_PREPASS_KERNELS = ("C5 rd", "C5 decide", "C6 stats", "C6 apply",
                    "C9 prepass")
_PSS_KERNELS = ("C9 temporal", "C9 prepass temporal", "C10 arms PSS",
                "C10 motion PSS", "C12 decide PSS")
# the PSS path's sequence: an ISS picture, then PSS ones; the sequence is
# coded PSS_TIMED_TURNS more times for its timing
PSS_FRAMES = 3
PSS_TIMED_TURNS = 2
# name -> (HoloConfig fields beyond the size, timed frames (the PSS path:
# timed turns of its sequence), kernels the path must launch, content)
ISS_PATHS = {
    "iss": (dict(ISS_CONFIG), ISS_TIMED_FRAMES,
            _ISS_KERNELS + _PREPASS_KERNELS, "lenslet"),
    # uniform 16x16 CUs: the only path with the scan's in-loop RMD arm
    "iss-uniform": (dict(ISS_CONFIG, quadtree=False, sao=False, cu_log2=4),
                    1, _ISS_KERNELS, "lenslet"),
    # bench.py:88-100's lenslet cell whole, the GT warp on
    "iss-gt": (dict(ISS_CONFIG, gt=True), ISS_TIMED_FRAMES,
               _ISS_KERNELS + _PREPASS_KERNELS + _GT_KERNELS, "lenslet"),
    # tests/test_e2e_iss.py's GT configuration (test_gt_roundtrip_and_
    # engages: 16x16 CUs, QP 37, SAO off) at full size on its warped
    # lenslet content, where the GT arm wins 24 times the area
    "iss-gt-warped": (dict(qp=37, cu_log2=4, search_range=32, mi_size=16,
                           gt=True), 2, _ISS_KERNELS + _GT_KERNELS,
                      "warped"),
    # bench.py:88-100's lenslet cell whole on a low-delay holoscopic
    # sequence (HoloEncoder.encode_sequence: an ISS picture, then PSS ones
    # whose L0 is [the previous picture, the SS reference]): a plenoptic
    # video camera panning one sample per frame (pss_frames)
    "pss-gt": (dict(ISS_CONFIG, gt=True, search_range_t=16),
               PSS_TIMED_TURNS,
               _ISS_KERNELS + _PREPASS_KERNELS + _GT_KERNELS + _PSS_KERNELS,
               "panned"),
}


def lenslet_frame(w=512, h=384, mi=16, seed=5):
    """tools/bdrate.py's synthetic lenslet light field (copied: this script
    imports nothing of the JAX package or its tools): a micro-image grid
    with a smooth per-MI disparity drift over a textured scene."""
    rng = np.random.default_rng(seed)
    scene_w, scene_h = w * 2, h * 2
    sy, sx = np.mgrid[0:scene_h, 0:scene_w]
    scene = (100 + 70 * np.sin(sx / 23.0) * np.cos(sy / 17.0)
             + 40 * np.sin((sx - sy) / 31.0)
             + rng.normal(0, 4, (scene_h, scene_w))).clip(0, 255)
    y = np.zeros((h, w))
    for by in range(h // mi):
        for bx in range(w // mi):
            ox = int(bx * mi * 0.6) + 40
            oy = int(by * mi * 0.6) + 40
            y[by * mi:(by + 1) * mi, bx * mi:(bx + 1) * mi] = \
                scene[oy:oy + mi, ox:ox + mi]
    y = y.clip(0, 255).astype(np.int32)
    cb = (120 + 20 * np.sin(np.mgrid[0:h // 2, 0:w // 2][1] / 19.0)
          ).clip(0, 255).astype(np.int32)
    cr = (128 + 18 * np.cos(np.mgrid[0:h // 2, 0:w // 2][0] / 23.0)
          ).clip(0, 255).astype(np.int32)
    return y, cb, cr


def pss_frames(w, h, count, seed=5):
    """tests/torch_fixtures/make_jax_fixture.py's pss_frames (copied): the
    motion model of tests/test_e2e_iss.py test_pss_sequence_roundtrip on
    lenslet_frame(w, h, mi=16, seed): frame t is the luma rolled by t
    samples plus default_rng(7) noise in [-2, 2], clipped; the chroma
    rolled by t // 2."""
    y0, cb0, cr0 = lenslet_frame(w, h, mi=16, seed=seed)
    rng = np.random.default_rng(7)
    frames = []
    for t in range(count):
        y = np.roll(y0, t, axis=1) + rng.integers(-2, 3, (h, w))
        frames.append((y.clip(0, 255).astype(np.int32),
                       np.roll(cb0, t // 2, axis=1).astype(np.int32),
                       np.roll(cr0, t // 2, axis=1).astype(np.int32)))
    return frames


PSS_CONTENT = (f"make_jax_fixture.py pss_frames({W}, {H}, {PSS_FRAMES}, "
               "seed=5) on tools/bdrate.py lenslet_frame")


def synth_lenslet(w, h, mi, seed=3):
    """tests/test_e2e_iss.py's micro-image grid with drift and noise
    (copied)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, (mi, mi))
    yy, xx = np.mgrid[0:h, 0:w]
    y = (base[yy % mi, xx % mi] + 0.2 * xx + 0.1 * yy
         + rng.normal(0, 2, (h, w))).clip(0, 255).astype(np.int32)
    cb = (128 + base[yy[::2, ::2] % mi, xx[::2, ::2] % mi] // 8
          ).clip(0, 255).astype(np.int32)
    cr = (128 - base[(yy[::2, ::2] + 5) % mi, xx[::2, ::2] % mi] // 8
          ).clip(0, 255).astype(np.int32)
    return y, cb, cr


def synth_warped_lenslet(w, h, mi, seed=5):
    """tests/test_e2e_iss.py's micro-image grid with a two-axis zoom
    gradient (copied): pure translation mispredicts, the GT warp
    compensates."""
    rng = np.random.default_rng(seed)
    base = rng.integers(30, 220, (mi * 4, mi * 4)).astype(np.float64)
    k = np.ones((3, 3)) / 9.0
    for _ in range(2):
        base = np.pad(base, 1, mode="edge")
        base = sum(base[i:i + mi * 4, j:j + mi * 4] * k[i, j]
                   for i in range(3) for j in range(3))
    out = np.zeros((h, w))
    for by in range(0, h, mi):
        for bx in range(0, w, mi):
            s = 1.0 + 0.12 * (bx // mi) + 0.12 * (by // mi)
            ly, lx = np.mgrid[0:mi, 0:mi]
            sy = np.clip(ly * s, 0, mi * 4 - 1)
            sx = np.clip(lx * s, 0, mi * 4 - 1)
            y0, x0 = sy.astype(int), sx.astype(int)
            fy, fx = sy - y0, sx - x0
            y1 = np.clip(y0 + 1, 0, mi * 4 - 1)
            x1 = np.clip(x0 + 1, 0, mi * 4 - 1)
            out[by:by + mi, bx:bx + mi] = (
                (1 - fy) * ((1 - fx) * base[y0, x0] + fx * base[y0, x1])
                + fy * ((1 - fx) * base[y1, x0] + fx * base[y1, x1]))
    y = out.clip(0, 255).astype(np.int32)
    cb = np.full((h // 2, w // 2), 128, np.int32)
    cr = np.full((h // 2, w // 2), 128, np.int32)
    return y, cb, cr


def path_frame(content):
    """The 1920x1088 frame of an ISS path and its description."""
    if content == "warped":
        return (synth_warped_lenslet(W, H, 16, seed=5),
                f"synth_warped_lenslet({W}, {H}, 16, seed=5)")
    return (lenslet_frame(W, H, mi=16),
            f"lenslet_frame({W}, {H}, mi=16, seed=5)")


def phase_interp(checks):
    """Kernel C8 against its plain body: every luma size 4-32 and chroma
    size 2-16, every quarter- and eighth-pel phase, 8 and 10 bit, MVs that
    clamp the window at every edge of both stacked pictures, and the three
    forms (prediction, masked write, add-residual epilogue)."""
    import torch
    from hevc_hop_torch.ops import interp
    dev = torch.device("cuda")
    c8 = checks["C8"]
    rng = np.random.default_rng(8)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=dev)
    for bd in (8, 10):
        for chroma, sizes in ((False, (4, 8, 16, 32)), (True, (2, 4, 8, 16))):
            h, w, pad = 96, 128, 16
            hc_off = h + pad
            rows = 2 * hc_off if chroma else h + pad
            plane = t(rng.integers(0, 1 << bd, (rows, w)))
            for n in sizes:
                b = 256
                pos = np.stack([rng.integers(0, w - n + 1, b),
                                rng.integers(0, h - n + 1, b)], -1)
                if chroma:
                    pos[b // 2:, 1] += hc_off
                mv = rng.integers(-4 * (n + 24), 4 * (n + 24), (b, 2))
                mv[:64, 0] = np.arange(64) % 16 - 8
                mv[64:128, 1] = np.arange(64) % 16 - 8
                pos, mv = t(pos), t(mv)
                args = (pos, mv, n, chroma, h, bd, hc_off)
                what = f"C8 {'chroma' if chroma else 'luma'} n={n} bd={bd}"
                c8.add(interp.mc_blocks(plane, *args),
                       interp.mc_blocks_plain(plane, *args), what)
                only = t(rng.random(b) < 0.5)
                base = t(rng.integers(0, 1 << bd, (b, n, n)))
                c8.add(interp.mc_blocks(plane, *args, out=base.clone(),
                                        only=only),
                       interp.mc_blocks_plain(plane, *args, out=base.clone(),
                                              only=only), what + " masked")
                # the decode epilogue writes the plane in place, so (as
                # the decoder's schedule guarantees) no block may read
                # samples another writes: blocks n + 16 apart, MVs within
                # +-8 samples, so that each window (+-4 more for the taps)
                # stays clear of the other blocks
                step = n + 16
                g = np.stack(np.meshgrid(np.arange(0, w - n + 1, step),
                                         np.arange(0, h - n + 1, step)),
                             -1).reshape(-1, 2)
                if chroma:
                    g = np.concatenate([g, g + [0, hc_off]])
                gpos = t(g)
                gmv = t(rng.integers(-8 * (4 if not chroma else 8),
                                     8 * (4 if not chroma else 8),
                                     (len(g), 2)))
                resi = t(rng.integers(-300, 300, tuple(plane.shape)))
                pk, pp = plane.clone(), plane.clone()
                interp.mc_blocks(pk, gpos, gmv, n, chroma, h, bd, hc_off,
                                 resi=resi)
                interp.mc_blocks_plain(pp, gpos, gmv, n, chroma, h, bd,
                                       hc_off, resi=resi)
                c8.add(pk, pp, what + " decode epilogue")
    torch.cuda.synchronize()
    log(f"C8: {c8.cases} cases {c8.mism} mismatches")


def phase_warp(checks):
    """Kernel C11 against its plain body: the window entry on every case of
    tests/golden/hm_golden.json ``gt_warp`` and on a sweep (luma n = 8, 16,
    32; chroma, half-pel, m = 4, 8, 16; 8 and 10 bit; corner offsets up to
    +-n, small integral ones and ramps that reach the knife edges and the
    clamp), prediction and ``safe``; the plane entries (luma, chroma) in
    their masked-write and add-residual forms."""
    import torch
    from hevc_hop_torch.ops import gt, warp
    dev = torch.device("cuda")
    c11 = checks["C11"]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=dev)
    with open(os.path.join(ROOT, "tests", "golden", "hm_golden.json")) as f:
        golden = json.load(f)["gt_warp"]
    for i, case in enumerate(golden):
        n = case["n"]
        win = t(np.array(case["win"]).reshape(1, 2 * n, 2 * n))
        cor = t(np.array(case["gt"]).reshape(1, 4, 2))
        got, want = warp.warp_blocks(win, cor, n), warp.warp_blocks_plain(
            win, cor, n)
        c11.add(got[0], want[0], f"C11 golden case {i} pred")
        c11.add(got[1], want[1], f"C11 golden case {i} safe")
    rng = np.random.default_rng(11)
    unsafe = 0
    for bd in (8, 10):
        for half, sizes in ((False, (8, 16, 32)), (True, (4, 8, 16))):
            for n in sizes:
                b = 512
                win = rng.integers(0, 1 << bd, (b, 2 * n, 2 * n))
                win[: b // 4] = (np.arange(2 * n)[:, None] * 3
                                 + np.arange(2 * n)[None] * 5) % (1 << bd)
                reach = 2 * n if half else n
                cor = rng.integers(-reach, reach + 1, (b, 4, 2))
                cor[b // 4: b // 2] = rng.integers(-1, 2, (b // 4, 4, 2))
                cor[:8] = 0
                win, cor = t(win), t(cor)
                got = warp.warp_blocks(win, cor, n, bd, half)
                want = warp.warp_blocks_plain(win, cor, n, bd, half)
                what = f"C11 window {'chroma' if half else 'luma'} n={n} " \
                       f"bd={bd}"
                c11.add(got[0], want[0], what + " pred")
                c11.add(got[1], want[1], what + " safe")
                unsafe += int((~want[1]).sum())
    require(unsafe > 0, "the C11 sweep reached no knife edge")
    # the plane entries: windows clamped at every edge of both pictures
    for bd in (8, 10):
        for chroma, sizes in ((False, (8, 16, 32)), (True, (4, 8, 16))):
            h, w, pad = 96, 128, 16
            hc_off = h + pad
            plane = t(rng.integers(0, 1 << bd,
                                   (2 * hc_off if chroma else h + pad, w)))
            for n in sizes:
                step = 2 * n + 8
                g = np.stack(np.meshgrid(np.arange(0, w - n + 1, step),
                                         np.arange(0, h - n + 1, step)),
                             -1).reshape(-1, 2)
                p = len(g)
                if chroma:
                    g = np.concatenate([g, g + [0, hc_off]])
                pos = t(g)
                mv = t(rng.integers(-4 * n, 4 * n, (p, 2)))
                gtc = t(rng.integers(-n, n + 1, (p, 6)))
                only = t(rng.random(p) < 0.7)
                what = f"C11 {'chroma' if chroma else 'luma'} n={n} bd={bd}"
                args = (pos, mv, gtc, n, chroma, h, bd, hc_off)
                base = t(rng.integers(0, 1 << bd, (len(g), n, n)))
                c11.add(warp.gt_pred_blocks(plane, *args, out=base.clone(),
                                            only=only),
                        gt.gt_pred_blocks_plain(plane, *args,
                                                  out=base.clone(),
                                                  only=only),
                        what + " masked")
                # the decode epilogue writes the plane in place: blocks
                # 2n + 8 apart, anchors within +-2 samples, so that no
                # window reaches another block
                mv2 = t(rng.integers(-8, 9, (p, 2)))
                resi = t(rng.integers(-300, 300, tuple(plane.shape)))
                pk, pp = plane.clone(), plane.clone()
                warp.gt_pred_blocks(pk, pos, mv2, gtc, n, chroma, h, bd,
                                    hc_off, resi=resi, only=only)
                gt.gt_pred_blocks_plain(pp, pos, mv2, gtc, n, chroma, h,
                                          bd, hc_off, resi=resi, only=only)
                c11.add(pk, pp, what + " decode epilogue")
    torch.cuda.synchronize()
    log(f"C11: {c11.cases} cases {c11.mism} mismatches ({len(golden)} "
        f"golden cases; {unsafe} unsafe blocks in the sweep)")


def phase_iss_path(name):
    """An ISS main path on the card: the launch counts of one encode and
    its decode (set to 0 just before, read just after), then the timed
    frames."""
    import torch
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    extra, timed, needed, content = ISS_PATHS[name]
    frame, content = path_frame(content)
    enc = HoloEncoder(HoloConfig(width=W, height=H, **extra))
    counters = _counters()
    for _, m, attr in counters:
        setattr(m, attr, 0)
    stream, e_s, d_s = _roundtrip(enc, frame, name)
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"{name} path launches: {launches}")
    require(all(launches[k] > 0 for k in needed),
            f"a kernel was not launched on the {name} path: {launches}")
    maps = enc.last_maps
    inter_share = float((maps.pred4 == 0).mean())
    require(inter_share > 0, f"{name}: no SS or merge CU")
    mse = np.mean((enc.recon_yuv[0].astype(np.float64) - frame[0]) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    require(psnr > 25, f"{name}: Y-PSNR {psnr:.2f} dB")
    # the GT area: 8x8 units whose CU codes the GT warp (gt8 marks each GT
    # CU's first unit)
    gt_cus = int(maps.gt8.sum())
    units = 1 << (2 * (maps.tu4[::2, ::2].astype(np.int64) - 3))
    gt_area = int((units * (maps.gt8 != 0)).sum())
    if name == "iss-gt-warped":
        require(gt_cus > 0, f"{name}: GT never engaged")
    enc_s, dec_s, probes = [], [], []
    for _ in range(timed):
        probes.append(host_probes())
        t0 = time.perf_counter()
        again = enc.encode_frame(*frame)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        require(again == stream, f"{name}: a later encode differs")
        t0 = time.perf_counter()
        dec = Decoder()
        dec.decode_stream(stream)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        require(dec.hash_ok == [True], f"{name}: a later decode's hash")
    plans = _last_prep(enc)[0]
    out = {"frame": f"{W}x{H}", "qp": enc.cfg.qp, "config": extra,
           "content": content,
           "wavefront_levels": enc.last_stats["levels"],
           "cus": {int(lg): int(p.cnt.sum()) for lg, p in plans.items()},
           "inter_share": inter_share, "gt_cus": gt_cus,
           "gt_area_8x8": gt_area,
           "gt_area_share": gt_area / float((W // 8) * (H // 8)),
           "bytes": len(stream), "y_psnr_db": psnr,
           "first_encode_decode_s": e_s + d_s, "timed_frames": timed,
           "encode_s": float(np.median(enc_s)), "encode_s_max": max(enc_s),
           "decode_s": float(np.median(dec_s)), "decode_s_max": max(dec_s),
           "encode_fps": 1.0 / float(np.median(enc_s)),
           "decode_fps": 1.0 / float(np.median(dec_s)),
           "python_probe_ms": float(np.median([p[0] for p in probes])),
           "launch_probe_ms": float(np.median([p[1] for p in probes])),
           "last_stats": dict(enc.last_stats), "launches": launches}
    log(f"{name} path: {json.dumps(out)}")
    return out, dict(enc=enc, frame=frame, stream=stream, content=content)


def _temporal_share(maps):
    """The share of the picture's 4x4 units that temporal prediction codes
    (inter, reference index 0 of L0 = [previous picture, SS])."""
    return float(((maps.pred4 == 0) & (maps.ref4 == 0)).mean())


def phase_pss_path(name):
    """The PSS main path on the card: the launch counts of one
    encode_sequence of the PSS_FRAMES pictures and its decode (set to 0
    just before, read just after); every picture hash_ok and equal to the
    encoder's recon history; temporal prediction chosen. Then the sequence
    coded PSS_TIMED_TURNS more times picture by picture, each PSS picture
    timed (host_probes beside it), and its decode timed."""
    import torch
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    extra, turns, needed, _ = ISS_PATHS[name]
    frames = pss_frames(W, H, PSS_FRAMES)
    enc = HoloEncoder(HoloConfig(width=W, height=H, **extra))
    counters = _counters()
    for _, m, attr in counters:
        setattr(m, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = enc.encode_sequence(frames)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec = Decoder()
    pics = dec.decode_stream(stream)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"{name} path launches: {launches}")
    require(all(launches[k] > 0 for k in needed),
            f"a kernel was not launched on the {name} path: {launches}")
    require(dec.hash_ok == [True] * PSS_FRAMES and dec.concealed == [],
            f"{name}: hash_ok {dec.hash_ok}, concealed {dec.concealed}")
    require(len(pics) == len(enc.recon_history) == PSS_FRAMES,
            f"{name}: {len(pics)} pictures decoded")
    for i, (pic, rec) in enumerate(zip(pics, enc.recon_history)):
        for a, b, nm in zip(pic, rec, ("y", "cb", "cr")):
            require(np.array_equal(a, b),
                    f"{name}: picture {i} decoded {nm} != recon")
    psnr = [10 * np.log10(255.0 ** 2 / max(np.mean(
        (rec[0].astype(np.float64) - fr[0]) ** 2), 1e-9))
        for rec, fr in zip(enc.recon_history, frames)]
    require(min(psnr) > 25, f"{name}: Y-PSNR {psnr}")
    # the timed turns, picture by picture: each PSS picture's temporal
    # share and GT CUs, and its time
    pss_s, iss_s, dec_s, probes, share, gt_cus, stats = ([] for _ in
                                                         range(7))
    for _ in range(turns):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out = [enc.encode_frame(*frames[0])]
        torch.cuda.synchronize()
        iss_s.append(time.perf_counter() - t0_)
        for poc in range(1, PSS_FRAMES):
            probes.append(host_probes())
            t0_ = time.perf_counter()
            out.append(enc._encode_pss(*frames[poc], poc))
            torch.cuda.synchronize()
            pss_s.append(time.perf_counter() - t0_)
            share.append(_temporal_share(enc.last_maps))
            gt_cus.append(int(enc.last_maps.gt8.sum()))
            stats.append(dict(enc.last_stats))
        require(b"".join(out) == stream, f"{name}: a later encode differs")
        t0_ = time.perf_counter()
        d2 = Decoder()
        d2.decode_stream(stream)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0_)
        require(d2.hash_ok == [True] * PSS_FRAMES, f"{name}: a later decode")
    require(min(share) > 0, f"{name}: temporal prediction never chosen "
            f"({share})")
    plans = _last_prep(enc)[0]
    out = {"frame": f"{W}x{H}", "qp": enc.cfg.qp, "config": extra,
           "content": PSS_CONTENT, "pictures": PSS_FRAMES,
           "wavefront_levels": enc.last_stats["levels"],
           "cus_last_picture": {int(lg): int(p.cnt.sum())
                                for lg, p in plans.items()},
           "temporal_share": share, "gt_cus": gt_cus,
           "bytes": len(stream), "y_psnr_db": psnr,
           "first_encode_sequence_s": t1 - t0,
           "first_decode_sequence_s": t2 - t1, "timed_turns": turns,
           "pss_encode_s": float(np.median(pss_s)),
           "pss_encode_s_max": max(pss_s),
           "iss_encode_s": float(np.median(iss_s)),
           "decode_s_per_picture": float(np.median(dec_s)) / PSS_FRAMES,
           "decode_sequence_s_max": max(dec_s),
           "pss_encode_fps": 1.0 / float(np.median(pss_s)),
           "python_probe_ms": float(np.median([p[0] for p in probes])),
           "launch_probe_ms": float(np.median([p[1] for p in probes])),
           "last_stats": stats[-1], "launches": launches}
    log(f"{name} path: {json.dumps(out)}")
    return out, dict(enc=enc, frames=frames, frame=frames[1],
                     stream=stream, content=PSS_CONTENT)


GT_SHARE_TURNS = 1


def phase_gt_share(ctxs):
    """The GT tool's share of each GT path's encode, in turns in one
    process: the path's encoder and a twin with gt=False on the same frame,
    off, on, on, off, GT_SHARE_TURNS times over (after a warm-up frame of
    the twin); medians of scan_s and of the whole encode each way."""
    import dataclasses
    import torch
    from hevc_hop_torch.models.ss_encoder import HoloEncoder
    out = {}
    for name in ("iss-gt", "iss-gt-warped"):
        enc, frame = ctxs[name]["enc"], ctxs[name]["frame"]
        off = HoloEncoder(dataclasses.replace(enc.cfg, gt=False))
        off.encode_frame(*frame)
        t = {True: [], False: []}
        for _ in range(GT_SHARE_TURNS):
            for gt in (False, True, True, False):
                e = enc if gt else off
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.encode_frame(*frame)
                torch.cuda.synchronize()
                t[gt].append((time.perf_counter() - t0,
                              e.last_stats["scan_s"]))
        med = {gt: np.median(np.array(v), axis=0) for gt, v in t.items()}
        out[name] = {
            "encode_s_gt_on": float(med[True][0]),
            "encode_s_gt_off": float(med[False][0]),
            "scan_s_gt_on": float(med[True][1]),
            "scan_s_gt_off": float(med[False][1]),
            "gt_share_of_scan_s": float(1 - med[False][1] / med[True][1]),
            "gt_share_of_encode": float(1 - med[False][0] / med[True][0]),
            "turns": GT_SHARE_TURNS}
    log(f"gt share: {json.dumps(out)}")
    return out


def _hold_iss_launches(enc, frames, stream, checks, every=8):
    """The launches of one encode of ``frames`` (one ISS picture, or the
    PSS path's sequence) and its decode, kernel against plain body on the
    same inputs, at the fullest level of every CU size and at every
    ``every``-th level: C9's search, C10's arms and motion write, C8's
    masked chroma (encoder) and both decode epilogues, and C4 with the
    inter maps; with the GT on, every launch of C9 (its ring), C12 (search
    and decide, one wrapper call) and C11 (the encoder's masked chroma,
    both decode epilogues); on the PSS path's sequence every launch of
    C9's temporal forms (scan and pre-pass), C10's PSS forms, C12's PSS
    decide and C8 (from the previous picture too), its ISS picture's C9 ring and C12 launches
    sampled as the other forms. The encode goes on with the kernels'
    outputs."""
    import torch
    from hevc_hop_torch.models import ss_scan
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.ops import deblock, gt, interp
    from hevc_hop_torch.ops import inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    from hevc_hop_torch.models import ss_encoder, decoder as dmod
    from hevc_hop_torch.models import ss_partition
    c8, c9, c10, c4 = (checks[k] for k in ("C8", "C9", "C10", "C4"))
    c11, c12 = checks["C11"], checks["C12"]
    orig = dict(mc=ss_scan.mc_blocks, ss=ss_scan.ss_search,
                ps=ss_scan.pss_search, rd=ss_partition.ss_rd_costs,
                arms=ss_scan.inter_arms, mw=ss_scan.motion_write,
                db=deblock.deblock_frame, gt=ss_scan.gt_step,
                gp=ss_scan.gt_pred_blocks)
    calls = {}
    fullest = {}
    plans = _last_prep(enc)[0]
    for lg, p in plans.items():
        fullest[p.n] = int(p.cnt.max())
    held = {}

    def pick(kind, n, b):
        k = calls[(kind, n)] = calls.get((kind, n), -1) + 1
        return b == fullest.get(n, -1) or k % every == 0

    def mark(what):
        held[what] = held.get(what, 0) + 1

    def mc(plane, pos, mv, n, chroma, h_real, bd=8, hc_off=0, out=None,
           only=None, resi=None, dst=None):
        # a PSS picture's temporal blocks read the previous picture (the
        # decoder writes them into the recon): every launch of a sequence
        other = dst is not None and dst is not plane
        if len(frames) == 1 and not pick(
                "mc" + str(chroma) + str(resi is None), n,
                pos.shape[0] // (2 if chroma else 1)):
            return orig["mc"](plane, pos, mv, n, chroma, h_real, bd, hc_off,
                              out, only, resi, dst)
        p2 = plane.clone()
        o2 = None if out is None else out.clone()
        d2 = dst.clone() if dst is not None and dst is not plane else None
        want = interp.mc_blocks_plain(p2, pos, mv, n, chroma, h_real, bd,
                                      hc_off, o2, only, resi,
                                      d2 if d2 is not None else
                                      (None if dst is None else p2))
        got = orig["mc"](plane, pos, mv, n, chroma, h_real, bd, hc_off, out,
                         only, resi, dst)
        what = (f"C8 {'chroma' if chroma else 'luma'} "
                f"{'masked' if resi is None else 'decode'}"
                f"{' previous picture' if other else ''} n={n}")
        c8.add(plane, p2, what + " plane")
        if out is not None:
            c8.add(out, o2, what)
        if d2 is not None:
            c8.add(dst, d2, what + " into the recon")
        mark(what)
        return got if resi is None else want

    def search(recon, org, pos, zcur, zmaxw, motion, nbav, miav, n, radius,
               w, h, lam, mi, zmax2n=None):
        got = orig["ss"](recon, org, pos, zcur, zmaxw, motion, nbav, miav, n,
                         radius, w, h, lam, mi, zmax2n)
        # the GT paths hold every ring launch; the PSS path's ISS picture
        # samples them as the other forms
        if (zmax2n is not None and len(frames) == 1) or pick(
                "ss", n, pos.shape[0]):
            preds = ia.gather_cands(*motion, pos, nbav, miav, n, mi)[3]
            want = ss.ss_search_plain(recon, org, pos, zcur, zmaxw, preds, n,
                                      radius, w, h, lam, zmax2n)
            for g, w_, nm in zip(got, want, ("mv", "cost", "pred", "sse",
                                              "anchor", "gt_rate",
                                              "gt_ok")):
                c9.add(g, w_, f"C9 search n={n} {nm}")
            mark(f"C9 {'ring' if zmax2n is not None else 'search'} n={n}")
        return got

    def psearch(recon, org, pos, zcur, zmaxw, motion, nbav, miav, n, radius,
                w, h, lam, mi, zmax2n, ref, radius_t):
        got = orig["ps"](recon, org, pos, zcur, zmaxw, motion, nbav, miav,
                         n, radius, w, h, lam, mi, zmax2n, ref, radius_t)
        p_ss, p_t = ia.gather_cands(*motion, pos, nbav, miav, n, mi,
                                    ss.SS_IDX_PSS)[3:]
        want = (ss.ss_search_plain(recon, org, pos, zcur, zmaxw, p_ss, n,
                                   radius, w, h, lam, zmax2n, seq=True),
                ss.t_search_plain(ref, org, pos, p_t, n, radius_t, w, h,
                                  lam))
        for side, g_, w_ in zip(("SS", "temporal"), got, want):
            for g, w2, nm in zip(g_, w_, ("mv", "cost", "pred", "sse",
                                          "anchor", "gt_rate", "gt_ok")):
                c9.add(g, w2, f"C9 PSS {side} n={n} {nm}")
        mark(f"C9 temporal n={n}")
        return got

    def prepass(org, pos, zcur, zmaxw, n, qp, bd, radius, w, h, mi, lam,
                ref=None, radius_t=0):
        got = orig["rd"](org, pos, zcur, zmaxw, n, qp, bd, radius, w, h, mi,
                         lam, ref, radius_t)
        if ref is not None:
            # the PSS pictures' pre-pass launches, every one, in chunks
            for i in range(0, pos.shape[0], 2048):
                sl = slice(i, i + 2048)
                want = ss_partition.ss_rd_costs_plain(
                    org, pos[sl], zcur[sl], zmaxw, n, qp, bd, radius, w, h,
                    mi, lam, ref, radius_t)
                c9.add_close(got[sl], want, COST_RTOL,
                             f"C9 pre-pass temporal n={n} blocks {i}+")
            mark(f"C9 prepass temporal n={n}")
        return got

    def gt_step(recon, org, rc, pos, zcur, z2, motion, nbav, miav, ring,
                costs, pred, inter, mv, smode, n, w, h, hc_off, bd, lam, mi,
                refsel=None):
        if refsel is None and len(frames) > 1 and not pick(
                "gt", n, pos.shape[0]):
            return orig["gt"](recon, org, rc, pos, zcur, z2, motion, nbav,
                              miav, ring, costs, pred, inter, mv, smode, n,
                              w, h, hc_off, bd, lam, mi)
        c = [t_.clone() for t_ in (pred, inter, mv, smode)]
        r2 = None if refsel is None else refsel.clone()
        want = gt.gt_step_plain(recon, org, rc, pos, zcur, z2, motion, nbav,
                                miav, ring, costs, *c, n, w, h, hc_off, bd,
                                lam, mi, r2)
        got = orig["gt"](recon, org, rc, pos, zcur, z2, motion, nbav, miav,
                         ring, costs, pred, inter, mv, smode, n, w, h,
                         hc_off, bd, lam, mi, refsel)
        extra = () if refsel is None else ((refsel, r2, "refsel"),)
        for g, w_, nm in zip(got + (pred, inter, mv, smode), want + tuple(c),
                             ("flag", "gtc", "pred", "inter", "mv",
                              "smode")):
            c12.add(g, w_, f"C12 n={n} {nm}")
        for g, w_, nm in extra:
            c12.add(g, w_, f"C12 PSS n={n} {nm}")
        mark(f"C12 {'PSS ' if refsel is not None else ''}n={n}")
        held["gt_cus"] = held.get("gt_cus", 0) + int(got[0].sum())
        return got

    def gt_pred(plane, pos, mv, gtc, n, chroma, h_real, bd=8, hc_off=0,
                out=None, only=None, resi=None):
        p2 = plane.clone()
        o2 = None if out is None else out.clone()
        gt.gt_pred_blocks_plain(p2, pos, mv, gtc, n, chroma, h_real, bd,
                                hc_off, o2, only, resi)
        got = orig["gp"](plane, pos, mv, gtc, n, chroma, h_real, bd, hc_off,
                         out, only, resi)
        what = (f"C11 {'chroma' if chroma else 'luma'} "
                f"{'masked' if resi is None else 'decode'} n={n}")
        c11.add(plane, p2, what + " plane")
        if out is not None:
            c11.add(out, o2, what)
        mark(what)
        return got

    def arms(recon, org, pos, zcur, zmaxw, motion, nbav, miav, mv_i, pred0,
             sse0, ipred, imode, n, w, h, bd, lam, mi, pss=None):
        if pss is None and not pick("arms", n, pos.shape[0]):
            return orig["arms"](recon, org, pos, zcur, zmaxw, motion, nbav,
                                miav, mv_i, pred0, sse0, ipred, imode, n, w,
                                h, bd, lam, mi)
        ip2 = ipred.clone()
        want = ia.inter_arms_plain(recon, org, pos, zcur, zmaxw, motion, nbav,
                                   miav, mv_i, pred0, sse0, ip2, imode, n, w,
                                   h, bd, lam, mi, pss)
        got = orig["arms"](recon, org, pos, zcur, zmaxw, motion, nbav, miav,
                           mv_i, pred0, sse0, ipred, imode, n, w, h, bd, lam,
                           mi, pss=pss)
        form = "" if pss is None else " PSS"
        for g, w_, nm in zip(got + (ipred,), want + (ip2,),
                             ("inter", "mv", "smode", "costs", "refsel",
                              "pred")[:len(got)] + ("pred",)):
            c10.add(g, w_, f"C10 arms{form} n={n} {nm}")
        mark(f"C10 arms{form} n={n}")
        return got

    def motion(mvx4, mvy4, pi4, pos, inter, mv, n, rf4=None, refsel=None):
        if refsel is None and not pick("mw", n, pos.shape[0]):
            return orig["mw"](mvx4, mvy4, pi4, pos, inter, mv, n, rf4,
                              refsel)
        planes = (mvx4, mvy4, pi4) + (() if refsel is None else (rf4,))
        c = [t_.clone() for t_ in planes]
        ia.motion_write_plain(*c[:3], pos, inter, mv, n,
                              *((c[3], refsel) if refsel is not None
                                else ()))
        orig["mw"](mvx4, mvy4, pi4, pos, inter, mv, n, rf4, refsel)
        form = "" if refsel is None else " PSS"
        c10.add(torch.stack(planes), torch.stack(c),
                f"C10 motion{form} n={n}")
        mark(f"C10 motion{form} n={n}")
        return None

    def deblock_both(y, cb, cr, tu4, qp, qp_c, bit_depth=8, beta_off=0,
                     tc_off=0, **kw):
        want = deblock.deblock_frame_plain(y, cb, cr, tu4, qp, qp_c,
                                           bit_depth, beta_off, tc_off, **kw)
        got = orig["db"](y, cb, cr, tu4, qp, qp_c, bit_depth, beta_off,
                         tc_off, **kw)
        for g, w_, nm in zip(got, want, ("y", "cb", "cr")):
            c4.add(g, w_, f"C4 inter arm {nm}")
        mark("C4 inter arm")
        return got

    ss_scan.mc_blocks, ss_scan.ss_search = mc, search
    ss_scan.pss_search, ss_partition.ss_rd_costs = psearch, prepass
    ss_scan.inter_arms, ss_scan.motion_write = arms, motion
    ss_scan.gt_step, ss_scan.gt_pred_blocks = gt_step, gt_pred
    ss_encoder.deblock.deblock_frame = deblock_both
    try:
        got = (enc.encode_frame(*frames[0]) if len(frames) == 1
               else enc.encode_sequence(frames))
        calls.clear()
        dec = Decoder()
        dec.decode_stream(got)
    finally:
        ss_scan.mc_blocks, ss_scan.ss_search = orig["mc"], orig["ss"]
        ss_scan.pss_search, ss_partition.ss_rd_costs = orig["ps"], orig["rd"]
        ss_scan.inter_arms, ss_scan.motion_write = orig["arms"], orig["mw"]
        ss_scan.gt_step, ss_scan.gt_pred_blocks = orig["gt"], orig["gp"]
        ss_encoder.deblock.deblock_frame = orig["db"]
    require(dmod.deblock.deblock_frame is orig["db"], "deblock restored")
    require(got == stream, "the held encode differs from the path's")
    require(dec.hash_ok == [True] * len(frames), "the held decode's hash")
    torch.cuda.synchronize()
    log(f"ISS launches held against the plain bodies: {json.dumps(held)}")
    return held


def phase_iss_kernels(checks, ctxs):
    """Kernels C9 (pre-pass entry, every block of every size of the
    1920x1088 lenslet luma, in chunks, and with the temporal arm every
    block of the pss-gt path's second picture), and C8, C9's scan entry,
    C10, C12 and C4's inter arm on the launches of real ISS and PSS
    encodes and decodes, each against its plain body on the card."""
    import torch
    from hevc_hop_torch.models import partition, ss_partition, wavefront
    from hevc_hop_torch.models.ss_scan import zmax_win_px
    dev = torch.device("cuda")
    c9 = checks["C9"]
    y = torch.as_tensor(lenslet_frame(W, H, mi=16)[0], device=dev)
    lam = partition.full_lambda(QP)
    zplane4 = wavefront.zaddr4_plane(W, H, 5)
    tally = {}
    for n in (8, 16, 32):
        ys, xs = np.mgrid[0:H:n, 0:W:n]
        ys, xs = ys.ravel(), xs.ravel()
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                      device=dev)
        zmaxw = t(zmax_win_px(zplane4, n))
        chunk = 2048
        for i in range(0, len(xs), chunk):
            pos = t(np.stack([xs[i:i + chunk], ys[i:i + chunk]], -1))
            zcur = t(zplane4[ys[i:i + chunk] >> 2, xs[i:i + chunk] >> 2])
            args = (y, pos, zcur, zmaxw, n, QP, 8, 32, W, H, 16, lam)
            got = ss_partition.ss_rd_costs(*args)
            want = ss_partition.ss_rd_costs_plain(*args)
            tally[f"not_bit_equal_n{n}"] = tally.get(
                f"not_bit_equal_n{n}", 0) + c9.add_close(
                got, want, COST_RTOL, f"C9 pre-pass n={n} blocks {i}+")
            tally[f"causal_n{n}"] = tally.get(f"causal_n{n}", 0) + int(
                (want < 1e37).sum())
    log(f"C9 pre-pass entry, every block of the {W}x{H} lenslet luma "
        f"(costs within {COST_RTOL} relative): {json.dumps(tally)}")
    # the pre-pass with its temporal arm: every block of the pss-gt path's
    # second picture against the first's recon
    enc = ctxs["pss-gt"]["enc"]
    y1 = torch.as_tensor(ctxs["pss-gt"]["frames"][1][0], device=dev)
    ref = torch.as_tensor(enc.recon_history[0][0], device=dev)
    for n in (8, 16, 32):
        ys, xs = np.mgrid[0:H:n, 0:W:n]
        ys, xs = ys.ravel(), xs.ravel()
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                      device=dev)
        zmaxw = t(zmax_win_px(zplane4, n))
        for i in range(0, len(xs), 2048):
            pos = t(np.stack([xs[i:i + 2048], ys[i:i + 2048]], -1))
            zcur = t(zplane4[ys[i:i + 2048] >> 2, xs[i:i + 2048] >> 2])
            args = (y1, pos, zcur, zmaxw, n, QP, 8, 32, W, H, 16, lam, ref,
                    16)
            got = ss_partition.ss_rd_costs(*args)
            want = ss_partition.ss_rd_costs_plain(*args)
            tally[f"temporal_not_bit_equal_n{n}"] = tally.get(
                f"temporal_not_bit_equal_n{n}", 0) + c9.add_close(
                got, want, COST_RTOL,
                f"C9 pre-pass temporal n={n} blocks {i}+")
    log(f"C9 pre-pass entry with the temporal arm, every block of the "
        f"pss-gt path's second picture: {json.dumps(tally)}")
    log_host("pre-pass entries held")
    held = {}
    for name in ISS_PATHS:
        c = ctxs[name]
        held[name] = _hold_iss_launches(c["enc"], c.get("frames",
                                                        [c["frame"]]),
                                        c["stream"], checks)
        log_host(f"{name} launches held")
    need = {"C9 search", "C10 arms", "C10 motion", "C8 chroma masked",
            "C8 luma decode", "C8 chroma decode", "C4 inter arm", "C9 ring",
            "C12", "C11 chroma masked", "C11 luma decode",
            "C11 chroma decode", "C9 temporal", "C10 arms PSS",
            "C10 motion PSS", "C12 PSS", "C8 luma decode previous picture",
            "C8 chroma decode previous picture", "C9 prepass temporal"}
    seen = {k.rsplit(" n=", 1)[0] for h in held.values() for k in h}
    require(need <= seen, f"ISS launch forms never held: {need - seen}")
    log("ISS kernels: " + ", ".join(
        f"{k} {checks[k].cases} cases {checks[k].mism} mismatches"
        for k in ("C4", "C8", "C9", "C10", "C11", "C12")))
    return tally


def _last_prep(enc):
    """(plans, nsteps, zmaxw, zmax2n) of the partition the encoder coded
    last."""
    return enc._prep_cache[next(reversed(enc._prep_cache))]


def search_ops(pos, zcur, zmaxw, n, radius):
    """Float32 operations of the search over blocks pos at the causal
    displacements these inputs have (the kernel skips the others): per
    displacement 2 n^2 multiply-adds (correlation and ref^2, two
    operations each) and the SSE, rate and compare (about 12 + 10 per
    predictor, counted as 80)."""
    import torch
    d = torch.arange(-radius, radius + 1, device=pos.device)
    ty = pos[:, 1, None, None].long() + d[None, :, None]
    tx = pos[:, 0, None, None].long() + d[None, None, :]
    inb = (ty >= 0) & (tx >= 0) & (ty + n <= H) & (tx + n <= W)
    zm = zmaxw[ty.clamp(0, H - n), tx.clamp(0, W - n)]
    causal = int((inb & (zm < zcur[:, None, None])).sum())
    return causal * (4 * n * n + 80), causal


def mc_ops(n, taps):
    """int32 operations of one n x n MC: two separable stages of ``taps``
    multiply-adds per sample (the first over n + taps - 1 rows), plus the
    shifts, offsets and clip (4 per sample)."""
    return 2 * taps * n * (n + taps - 1) + 2 * taps * n * n + 4 * n * n


def phase_iss_timing(ctxs, checks, launches):
    """Rows of the kernels line for C8, C9, C10 and C4's inter arm, each at
    the largest launch the iss path gives it, held once more and timed
    beside its plain version, its bound and, for C9, a library call."""
    import torch
    import torch.nn.functional as F
    from hevc_hop_torch.models import partition, ss_partition, wavefront
    from hevc_hop_torch.models.ss_scan import zmax_win_px
    from hevc_hop_torch.ops import deblock, interp
    from hevc_hop_torch.ops import inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    dev = torch.device("cuda")
    # the level loop's inputs at the fullest 16x16 level of the iss path:
    # at radius 32 no 32x32 displacement is causal (the window with the
    # filter margin spans 40 samples), so 16x16 is the largest search
    path = "iss" if 4 in _last_prep(ctxs["iss"]["enc"])[0] else "iss-uniform"
    enc, frame = ctxs[path]["enc"], ctxs[path]["frame"]
    plans, _, zmaxws = _last_prep(enc)[:3]
    lam = partition.full_lambda(QP)
    specs = []

    def spec(**kw):
        specs.append(kw)

    lg = 4
    p = plans[lg]
    n = p.n
    s = int(np.argmax(p.cnt))
    o, c = int(p.off[s]), int(p.cnt[s])
    sl = slice(o, o + c)
    pos, zcur, nbav, miav = p.pos[sl], p.zcur[sl], p.nbav[sl], p.miav[sl]
    oy, oc = enc._upload(*frame)
    ry = oy.clone()                  # the recon: the original, ahead
    ry[H:] = 0
    motion = tuple(torch.zeros((oy.shape[0] // 4, W // 4), dtype=torch.int32,
                               device=dev) for _ in range(4))
    rng = np.random.default_rng(9)
    motion[0][:] = torch.as_tensor(rng.integers(-200, 40, motion[0].shape))
    motion[1][:] = torch.as_tensor(rng.integers(-200, 40, motion[1].shape))
    motion[2][:] = torch.as_tensor(rng.random(motion[2].shape) < 0.6)
    zmaxw = zmaxws[lg]
    sargs = (ry, oy, pos, zcur, zmaxw, motion, nbav, miav, n, 32, W, H, lam,
             16)
    ops, causal = search_ops(pos, zcur, zmaxw, n, 32)
    wsz = n + 64
    spec(name=f"C9 ss_search (scan, {n}x{n})", counter="C9 search",
         path=path, kernel="ss_search_kernel",
         shape=f"{c} CUs of {n}x{n}, radius 32, {causal} causal "
               "displacements", source="hevc_hop_torch/csrc/ss_search.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:198",
         fn=lambda: ss.ss_search(*sargs),
         plain=lambda: ss.ss_search_plain(
             ry, oy, pos, zcur, zmaxw,
             ia.gather_cands(*motion, pos, nbav, miav, n, 16)[3], n, 32, W,
             H, lam),
         nbytes=c * (wsz * wsz + n * n) * 4 + c * (n * n * 4 + 16),
         ops=(0, ops))
    # the library yardstick: cuDNN's grouped float32 convolution of the
    # same windows with the blocks (the correlation alone, TF32 allowed as
    # PyTorch's default)
    ar = torch.arange(wsz, device=dev)
    wy = (pos[:, 1, None].long() - 32 + ar[None]).clamp(0, H - 1)
    wx = (pos[:, 0, None].long() - 32 + ar[None]).clamp(0, W - 1)
    win = ry[wy[:, :, None], wx[:, None, :]].float()[None]
    ker = ss.block_at(oy, pos, n).float()[:, None]
    specs[-1]["library"] = lambda: F.conv2d(win, ker, groups=c)
    specs[-1]["library_call"] = ("torch.nn.functional.conv2d, grouped, "
                                 "float32 (cuDNN; the correlation only)")
    # C9's pre-pass entry on every 16x16 block of the lenslet luma
    ys, xs = np.mgrid[0:H:16, 0:W:16]
    ppos = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], -1).astype(
        np.int32), device=dev)
    zplane4 = wavefront.zaddr4_plane(W, H, 5)
    pz = torch.as_tensor(zplane4[ys.ravel() >> 2, xs.ravel() >> 2].astype(
        np.int32), device=dev)
    pzm = torch.as_tensor(zmax_win_px(zplane4, 16), device=dev)
    yl = oy[:H]
    pops, pcausal = search_ops(ppos, pz, pzm, 16, 32)
    nb = ppos.shape[0]
    rargs = (yl, ppos, pz, pzm, 16, QP, 8, 32, W, H, 16, lam)
    spec(name="C9 ss_search (pre-pass, 16x16)", counter="C9 prepass",
         path="iss", kernel="ss_rd_kernel",
         shape=f"{nb} blocks of 16x16 of the {W}x{H} luma, radius 32, "
               f"{pcausal} causal displacements",
         source="hevc_hop_torch/csrc/ss_search.cu",
         replaces="hevc_hop_tpu/models/ss_partition.py:40",
         fn=lambda: ss_partition.ss_rd_costs(*rargs),
         plain=lambda: ss_partition.ss_rd_costs_plain(*rargs),
         rtol=COST_RTOL,
         nbytes=nb * (80 * 80 + 256) * 4 + nb * 4,
         ops=(nb * 16 * 1024, pops + nb * 256 * 4))
    # C10 on the same level's blocks, after a real search
    mv_i, _, pred0, sse0 = ss.ss_search(*sargs)
    ipred = ss.block_at(oy, pos, n).clone()
    imode = torch.zeros(c, dtype=torch.int32, device=dev)
    aargs = (ry, oy, pos, zcur, zmaxw, motion, nbav, miav, mv_i, pred0, sse0)
    tail = (imode, n, W, H, 8, lam, 16)
    bufs = {k: ipred.clone() for k in ("kernel", "plain")}
    spec(name=f"C10 inter_arms ({n}x{n})", counter="C10 arms", path=path,
         kernel="inter_arms_kernel",
         shape=f"{c} CUs of {n}x{n}: 9 merge candidates, 16 sub-pel",
         source="hevc_hop_torch/csrc/inter_arms.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:410",
         fn=lambda: ia.inter_arms(*aargs, bufs["kernel"].copy_(ipred),
                                  *tail) + (bufs["kernel"],),
         plain=lambda: ia.inter_arms_plain(*aargs,
                                           bufs["plain"].copy_(ipred),
                                           *tail) + (bufs["plain"],),
         nbytes=c * (3 * n * n * 4 + 4 * (n + 7) ** 2 + 64),
         ops=(c * 25 * mc_ops(n, 8), c * 26 * 3 * n * n))
    inter = torch.ones(c, dtype=torch.int32, device=dev)
    mvq = mv_i * 4 + 1
    mbufs = {k: tuple(m.clone() for m in motion[:3])
             for k in ("kernel", "plain")}
    spec(name=f"C10 motion_write ({n}x{n})", counter="C10 motion",
         path=path, kernel="motion_write_kernel",
         shape=f"{c} CUs of {n}x{n}",
         source="hevc_hop_torch/csrc/inter_arms.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:835",
         fn=lambda: (ia.motion_write(*mbufs["kernel"], pos, inter, mvq, n),
                     torch.stack(mbufs["kernel"]))[1],
         plain=lambda: (ia.motion_write_plain(*mbufs["plain"], pos, inter,
                                              mvq, n),
                        torch.stack(mbufs["plain"]))[1],
         nbytes=c * (16 + 3 * 4 * (n // 4) ** 2), ops=c * 3 * (n // 4) ** 2)
    # C8: the encoder's masked chroma and the decoder's luma epilogue
    m = n // 2
    hc_off = H // 2 + 32
    cpos = p.cpos[2 * o:2 * o + 2 * c]
    rc = oc.clone()
    only = (torch.arange(c, device=dev) % 2).to(torch.int32)
    cbase = torch.zeros((2 * c, m, m), dtype=torch.int32, device=dev)
    spec(name=f"C8 interp (chroma, {m}x{m})", counter="C8 chroma",
         path=path, kernel="mc_kernel",
         shape=f"{2 * c} chroma blocks of {m}x{m}, masked write",
         source="hevc_hop_torch/csrc/interp.cu",
         replaces="hevc_hop_tpu/ops/interp.py:94",
         fn=lambda: interp.mc_blocks(rc, cpos, mvq, m, True, H // 2, 8,
                                     hc_off, out=cbase.clone(), only=only),
         plain=lambda: interp.mc_blocks_plain(rc, cpos, mvq, m, True, H // 2,
                                              8, hc_off, out=cbase.clone(),
                                              only=only),
         nbytes=2 * c * ((m + 3) ** 2 + m * m) * 4,
         ops=2 * c * mc_ops(m, 4))
    resi = torch.as_tensor(rng.integers(-30, 30, tuple(oy.shape)).astype(
        np.int32), device=dev)
    lbufs = {k: ry.clone() for k in ("kernel", "plain")}
    spec(name=f"C8 interp (luma, {n}x{n})", counter="C8 luma", path=path,
         kernel="mc_kernel",
         shape=f"{c} luma blocks of {n}x{n}, decode epilogue",
         source="hevc_hop_torch/csrc/interp.cu",
         replaces="hevc_hop_tpu/ops/interp.py:120",
         fn=lambda: (interp.mc_blocks(lbufs["kernel"].copy_(ry), pos, mvq, n,
                                      False, H, resi=resi),
                     lbufs["kernel"])[1],
         plain=lambda: (interp.mc_blocks_plain(lbufs["plain"].copy_(ry), pos,
                                               mvq, n, False, H, resi=resi),
                        lbufs["plain"])[1],
         nbytes=c * ((n + 7) ** 2 + 2 * n * n) * 4,
         ops=c * mc_ops(n, 8))
    # C4 with the iss frame's own inter maps
    maps = ctxs["iss"]["enc"].last_maps
    dm = lambda a: torch.as_tensor(a, device=dev)
    ry2, rcb, rcr = ctxs["iss"]["enc"]._recon_dev
    inter_maps = dict(pred4=dm(maps.pred4), cbf4=dm(maps.cbf4_y),
                      ref4=dm(maps.ref4), mv4x=dm(maps.mv4x),
                      mv4y=dm(maps.mv4y))
    tu4 = dm(maps.tu4)
    npx = H * W * 3 // 2
    spec(name="C4 deblock (inter arm)", counter="C4", path="iss",
         kernel="deblock_kernel",
         shape=f"{W}x{H} frame, both passes, the iss frame's inter maps",
         source="hevc_hop_torch/csrc/deblock.cu",
         replaces="hevc_hop_tpu/ops/deblock.py:138",
         fn=lambda: deblock.deblock_frame(ry2, rcb, rcr, tu4, QP, 31,
                                          **inter_maps),
         plain=lambda: deblock.deblock_frame_plain(ry2, rcb, rcr, tu4, QP,
                                                   31, **inter_maps),
         nbytes=2 * 4 * npx + 8 * tu4.numel(), ops=2 * 50 * npx // 4)
    return _time_specs(specs, checks, launches)


def warp_ops(n):
    """int32 operations of one n x n GT warp: per sample the two map
    coordinates, their truncating divisions and fractions, the clamp, the
    bilinear sum, the rounding and the knife tests (about 45), and the
    SSE's subtract, multiply and add (3)."""
    return 48 * n * n


def gt_anchor_count(pos, zcur, zmax2n, motion, nbav, miav, ring, n,
                    ss_idx=0):
    """The (block, anchor) pairs C12's search runs on these inputs: the
    ring anchors found, and the predictor anchors that are valid, causal
    and not the ring's again."""
    import torch
    from hevc_hop_torch.ops import inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    p_ss = ia.gather_cands(*motion, pos, nbav, miav, n, 16,
                           ss_idx)[3][:, 0]
    valid = (p_ss.abs() < ss.HUGE_PRED // 2).all(-1)
    prd = torch.where(valid[:, None], (p_ss + 2) >> 2, 0)
    ok_p = ss.ss_anchor_ok(pos, zcur, zmax2n, prd, n, W, H) & valid
    dup = (ring[0] == prd).all(-1) & ring[2]
    return int(ring[2].sum()) + int((ok_p & ~dup).sum())


def phase_gt_timing(ctxs, checks, launches):
    """Rows of the kernels line for C9's scan entry with the GT ring, C12's
    two entries and C11's two plane entries, each at the fullest 16x16
    level of a GT path, held once more and timed beside its plain version
    and its bound."""
    import torch
    from hevc_hop_torch.models import partition
    from hevc_hop_torch.ops import gt, inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    from hevc_hop_torch.ops import warp
    dev = torch.device("cuda")
    specs = []

    def level(path):
        enc, frame = ctxs[path]["enc"], ctxs[path]["frame"]
        plans, _, zmaxws, zmax2ns = _last_prep(enc)
        p = plans[4]
        s = int(np.argmax(p.cnt))
        o, c = int(p.off[s]), int(p.cnt[s])
        sl = slice(o, o + c)
        oy, oc = enc._upload(*frame)
        ry = oy.clone()                  # the recon: the original, ahead
        ry[H:] = 0
        rng = np.random.default_rng(12)
        motion = tuple(torch.zeros((oy.shape[0] // 4, W // 4),
                                   dtype=torch.int32, device=dev)
                       for _ in range(4))
        motion[0][:] = torch.as_tensor(rng.integers(-200, 40,
                                                    motion[0].shape))
        motion[1][:] = torch.as_tensor(rng.integers(-200, 40,
                                                    motion[1].shape))
        motion[2][:] = torch.as_tensor(rng.random(motion[2].shape) < 0.6)
        return dict(enc=enc, p=p, o=o, c=c, pos=p.pos[sl], zcur=p.zcur[sl],
                    nbav=p.nbav[sl], miav=p.miav[sl], oy=oy, oc=oc, ry=ry,
                    motion=motion, zmaxw=zmaxws[4], zmax2n=zmax2ns[4],
                    lam=partition.full_lambda(enc.cfg.qp), qp=enc.cfg.qp)

    # C9 with the ring, on the iss-gt path's fullest 16x16 level
    L = level("iss-gt")
    n, c = 16, L["c"]
    sargs = (L["ry"], L["oy"], L["pos"], L["zcur"], L["zmaxw"], L["motion"],
             L["nbav"], L["miav"], n, 32, W, H, L["lam"], 16)
    ops, causal = search_ops(L["pos"], L["zcur"], L["zmaxw"], n, 32)
    wsz = n + 64
    spec = lambda **kw: specs.append(kw)
    spec(name=f"C9 ss_search (scan, GT ring, {n}x{n})", counter="C9 ring",
         path="iss-gt", kernel="ss_search_kernel",
         shape=f"{c} CUs of {n}x{n}, radius 32, {causal} causal "
               "displacements, the anchor ring",
         source="hevc_hop_torch/csrc/ss_search.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:266",
         fn=lambda: ss.ss_search(*sargs, zmax2n=L["zmax2n"]),
         plain=lambda: ss.ss_search_plain(
             L["ry"], L["oy"], L["pos"], L["zcur"], L["zmaxw"],
             ia.gather_cands(*L["motion"], L["pos"], L["nbav"], L["miav"],
                             n, 16)[3], n, 32, W, H, L["lam"], L["zmax2n"]),
         nbytes=c * (wsz * wsz + n * n) * 4 + c * (n * n * 4 + 28),
         ops=(0, ops + causal * 10))

    # C12 on the iss-gt-warped path's fullest level, after a real search
    # and C10's tournament
    G = level("iss-gt-warped")
    c = G["c"]
    gargs = (G["ry"], G["oy"], G["pos"], G["zcur"], G["zmaxw"], G["motion"],
             G["nbav"], G["miav"], n, 32, W, H, G["lam"], 16)
    mv_i, _, pred0, sse0, *ring = ss.ss_search(*gargs, zmax2n=G["zmax2n"])
    ipred = ss.block_at(G["oy"], G["pos"], n).clone()
    imode = torch.zeros(c, dtype=torch.int32, device=dev)
    inter, mv, smode, costs = ia.inter_arms(
        *gargs[:8], mv_i, pred0, sse0, ipred, imode, n, W, H, 8, G["lam"],
        16)
    base = (ipred, inter, mv, smode)
    hc_off = H // 2 + 32
    rc = G["oc"].clone()
    head = (G["ry"], G["oy"], rc, G["pos"], G["zcur"], G["zmax2n"],
            G["motion"], G["nbav"], G["miav"], ring, costs)
    tail = (n, W, H, hc_off, 8, G["lam"], 16)

    def step(fn):
        bufs = tuple(t.clone() for t in base)
        return fn(*head, *bufs, *tail) + bufs

    anchors = gt_anchor_count(G["pos"], G["zcur"], G["zmax2n"], G["motion"],
                              G["nbav"], G["miav"], ring, n)
    flag = step(gt.gt_step)[0]
    nflag = int(flag.sum())
    m = n // 2
    common = dict(counter="C12 search", path="iss-gt-warped",
                  source="hevc_hop_torch/csrc/gt_search.cu",
                  fn=lambda: step(gt.gt_step),
                  plain=lambda: step(gt.gt_step_plain))
    spec(name=f"C12 gt_search ({n}x{n})", kernel="gt_search_kernel",
         shape=f"{c} CUs of {n}x{n}, {anchors} causal anchors of "
               f"{2 * c}, 79 warps each",
         replaces="hevc_hop_tpu/models/ss_scan.py:580",
         nbytes=anchors * (5 * n * n * 4 + n * n * 4 + 64) + c * 48,
         ops=anchors * 79 * warp_ops(n), **common)
    # the decide entry's chroma check runs where the GT cost wins; count
    # the flagged blocks as a floor
    spec(name=f"C12 gt_decide ({n}x{n})", kernel="gt_decide_kernel",
         shape=f"{c} CUs of {n}x{n}, {nflag} GT",
         replaces="hevc_hop_tpu/models/ss_scan.py:796",
         nbytes=c * 120 + nflag * (2 * n * n * 4 + 2 * (n + 3) ** 2 * 4),
         ops=nflag * 2 * (mc_ops(n, 4) + warp_ops(m)),
         **dict(common, counter="C12 decide"))
    # C11: the encoder's masked chroma and the decoder's luma epilogue on
    # the same level's blocks, the GT blocks of the step above selected
    cpos = G["p"].cpos[2 * G["o"]:2 * G["o"] + 2 * c]
    rng = np.random.default_rng(13)
    gmv = torch.as_tensor(rng.integers(-8, 9, (c, 2)) * 4 - 64,
                          dtype=torch.int32, device=dev)
    gtc = torch.as_tensor(rng.integers(-4, 5, (c, 6)), dtype=torch.int32,
                          device=dev)
    only = (torch.arange(c, device=dev) % 2).to(torch.int32)
    sel = int(only.sum())
    cbase = torch.zeros((2 * c, m, m), dtype=torch.int32, device=dev)
    spec(name=f"C11 gt_pred (chroma, {m}x{m})", counter="C11 chroma",
         path="iss-gt-warped", kernel="gt_pred_kernel",
         shape=f"{2 * c} chroma blocks of {m}x{m}, {2 * sel} GT, masked "
               "write",
         source="hevc_hop_torch/csrc/warp.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:522",
         fn=lambda: warp.gt_pred_blocks(rc, cpos, gmv, gtc, m, True, H // 2,
                                        8, hc_off, out=cbase.clone(),
                                        only=only),
         plain=lambda: gt.gt_pred_blocks_plain(rc, cpos, gmv, gtc, m, True,
                                                 H // 2, 8, hc_off,
                                                 out=cbase.clone(),
                                                 only=only),
         nbytes=2 * sel * ((2 * m + 3) ** 2 + m * m) * 4 + c * 36,
         ops=2 * sel * (mc_ops(2 * m, 4) + warp_ops(m)))
    resi = torch.as_tensor(rng.integers(-30, 30, tuple(G["oy"].shape)).astype(
        np.int32), device=dev)
    lbufs = {k: G["ry"].clone() for k in ("kernel", "plain")}
    spec(name=f"C11 gt_pred (luma, {n}x{n})", counter="C11 luma",
         path="iss-gt-warped", kernel="gt_pred_kernel",
         shape=f"{c} luma blocks of {n}x{n}, {sel} GT, decode epilogue",
         source="hevc_hop_torch/csrc/warp.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:514",
         fn=lambda: (warp.gt_pred_blocks(lbufs["kernel"].copy_(G["ry"]),
                                         G["pos"], gmv, gtc, n, False, H,
                                         resi=resi, only=only),
                     lbufs["kernel"])[1],
         plain=lambda: (gt.gt_pred_blocks_plain(
             lbufs["plain"].copy_(G["ry"]), G["pos"], gmv, gtc, n, False, H,
             resi=resi, only=only), lbufs["plain"])[1],
         nbytes=sel * (4 * n * n + 2 * n * n) * 4 + c * 36,
         ops=sel * warp_ops(n))
    return _time_specs(specs, checks, launches)


def phase_pss_timing(ctxs, checks, launches):
    """Rows of the kernels line for the PSS forms, each at the fullest
    32x32 level of the pss-gt path's last picture (the recon: the
    original, ahead; the previous picture: the path's recon of its first;
    random carried motion naming either reference), held once more and
    timed beside its plain version, its bound and, for C9, a library
    call: C9's scan entry with the temporal search (one launch, the SS and
    temporal CTAs), its pre-pass entry with the temporal arm, C10's PSS
    forms and C12 with its PSS decide."""
    import torch
    import torch.nn.functional as F
    from hevc_hop_torch.models import partition, ss_partition, wavefront
    from hevc_hop_torch.models.ss_scan import zmax_win_px
    from hevc_hop_torch.ops import gt, inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    dev = torch.device("cuda")
    ctx = ctxs["pss-gt"]
    enc = ctx["enc"]
    plans, _, zmaxws, zmax2ns = _last_prep(enc)
    lg = 5 if 5 in plans else max(plans)
    p = plans[lg]
    n = p.n
    s_ = int(np.argmax(p.cnt))
    o, c = int(p.off[s_]), int(p.cnt[s_])
    sl = slice(o, o + c)
    pos, zcur, nbav, miav = p.pos[sl], p.zcur[sl], p.nbav[sl], p.miav[sl]
    oy, oc = enc._upload(*ctx["frames"][-1])
    ry = oy.clone()
    ry[H:] = 0
    ref = torch.as_tensor(enc.recon_history[-2][0], device=dev)
    rng = np.random.default_rng(14)
    motion = tuple(torch.zeros((oy.shape[0] // 4, W // 4), dtype=torch.int32,
                               device=dev) for _ in range(4))
    motion[0][:] = torch.as_tensor(rng.integers(-40, 8, motion[0].shape))
    motion[1][:] = torch.as_tensor(rng.integers(-8, 8, motion[1].shape))
    motion[2][:] = torch.as_tensor(rng.random(motion[2].shape) < 0.8)
    motion[3][:] = torch.as_tensor(rng.random(motion[3].shape) < 0.3)
    lam = partition.full_lambda(QP)
    zmaxw, zmax2n = zmaxws[lg], zmax2ns[lg]
    specs = []
    spec = lambda **kw: specs.append(kw)
    sargs = (ry, oy, pos, zcur, zmaxw, motion, nbav, miav, n, 32, W, H, lam,
             16, zmax2n, ref, 16)
    ops_s, causal = search_ops(pos, zcur, zmaxw, n, 32)
    dt = torch.arange(-16, 17, device=dev)
    ty = pos[:, 1, None, None].long() + dt[None, :, None]
    tx = pos[:, 0, None, None].long() + dt[None, None, :]
    inpic = int(((ty >= 0) & (tx >= 0) & (ty + n <= H)
                 & (tx + n <= W)).sum())
    ops_t = inpic * (4 * n * n + 80)
    ws, wt = n + 64, n + 32

    def plain_search():
        p_ss, p_t = ia.gather_cands(*motion, pos, nbav, miav, n, 16,
                                    ss.SS_IDX_PSS)[3:]
        return (ss.ss_search_plain(ry, oy, pos, zcur, zmaxw, p_ss, n, 32, W,
                                   H, lam, zmax2n, seq=True)
                + ss.t_search_plain(ref, oy, pos, p_t, n, 16, W, H, lam))

    spec(name=f"C9 ss_search (scan, PSS: SS with the ring + temporal, "
              f"{n}x{n})", counter="C9 temporal", path="pss-gt",
         kernel="ss_search_kernel",
         shape=f"{c} CUs of {n}x{n}: the SS search at radius 32 ({causal} "
               f"causal displacements) and the temporal one at radius 16 "
               f"({inpic} displacements), one launch of {2 * c} CTAs",
         source="hevc_hop_torch/csrc/ss_search.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:301",
         fn=lambda: (lambda r: r[0] + r[1])(ss.pss_search(*sargs)),
         plain=plain_search,
         nbytes=c * (ws * ws + wt * wt + n * n) * 4
         + c * (2 * n * n * 4 + 44),
         ops=(0, ops_s + ops_t))
    # the library yardstick: the temporal correlation as cuDNN's grouped
    # float32 convolution of the same windows (TF32 allowed, its default)
    ar = torch.arange(wt, device=dev)
    wy = (pos[:, 1, None].long() - 16 + ar[None]).clamp(0, H - 1)
    wx = (pos[:, 0, None].long() - 16 + ar[None]).clamp(0, W - 1)
    win = ref[wy[:, :, None], wx[:, None, :]].float()[None]
    ker = ss.block_at(oy, pos, n).float()[:, None]
    specs[-1]["library"] = lambda: F.conv2d(win, ker, groups=c)
    specs[-1]["library_call"] = ("torch.nn.functional.conv2d, grouped, "
                                 "float32 (cuDNN; the temporal correlation "
                                 "only)")
    # the pre-pass entry with the temporal arm on every 32x32 block
    ys, xs = np.mgrid[0:H:n, 0:W:n]
    ppos = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], -1).astype(
        np.int32), device=dev)
    zplane4 = wavefront.zaddr4_plane(W, H, 5)
    pz = torch.as_tensor(zplane4[ys.ravel() >> 2, xs.ravel() >> 2].astype(
        np.int32), device=dev)
    pzm = torch.as_tensor(zmax_win_px(zplane4, n), device=dev)
    nb = ppos.shape[0]
    pops, _ = search_ops(ppos, pz, pzm, n, 32)
    pt_ = ppos[:, 1, None, None].long() + dt[None, :, None]
    px_ = ppos[:, 0, None, None].long() + dt[None, None, :]
    pin = int(((pt_ >= 0) & (px_ >= 0) & (pt_ + n <= H)
               & (px_ + n <= W)).sum())
    rargs = (oy[:H], ppos, pz, pzm, n, QP, 8, 32, W, H, 16, lam, ref, 16)
    spec(name=f"C9 ss_search (pre-pass, temporal arm, {n}x{n})",
         counter="C9 prepass temporal", path="pss-gt", kernel="ss_rd_kernel",
         shape=f"{nb} blocks of {n}x{n} of the {W}x{H} luma: SS radius 32, "
               f"temporal radius 16 ({pin} displacements)",
         source="hevc_hop_torch/csrc/ss_search.cu",
         replaces="hevc_hop_tpu/models/ss_partition.py:40",
         fn=lambda: ss_partition.ss_rd_costs(*rargs),
         plain=lambda: ss_partition.ss_rd_costs_plain(*rargs),
         rtol=COST_RTOL,
         nbytes=nb * ((n + 64) ** 2 + (n + 32) ** 2 + n * n) * 4 + nb * 4,
         ops=(nb * n * 4 * n * n, pops + pin * (4 * n * n + 80)))
    # C10's PSS form on the same level's blocks, after a real search
    (mv_i, _, pred0, sse0, *ring), (mv_t, _, tpred0, tsse0) = \
        ss.pss_search(*sargs)
    ipred = ss.block_at(oy, pos, n).clone()
    imode = torch.zeros(c, dtype=torch.int32, device=dev)
    aargs = (ry, oy, pos, zcur, zmaxw, motion, nbav, miav, mv_i, pred0, sse0)
    tail = (imode, n, W, H, 8, lam, 16)
    pss = (ref, mv_t, tpred0, tsse0)
    bufs = {k: ipred.clone() for k in ("kernel", "plain")}
    spec(name=f"C10 inter_arms (PSS, {n}x{n})", counter="C10 arms PSS",
         path="pss-gt", kernel="inter_arms_kernel",
         shape=f"{c} CUs of {n}x{n}: 9 merge candidates on either "
               "reference, 16 sub-pel on each of the two",
         source="hevc_hop_torch/csrc/inter_arms.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:982",
         fn=lambda: ia.inter_arms(*aargs, bufs["kernel"].copy_(ipred),
                                  *tail, pss=pss) + (bufs["kernel"],),
         plain=lambda: ia.inter_arms_plain(*aargs,
                                           bufs["plain"].copy_(ipred),
                                           *tail, pss) + (bufs["plain"],),
         nbytes=c * (4 * n * n * 4 + 4 * (n + 7) ** 2 + 80),
         ops=(c * 41 * mc_ops(n, 8), c * 42 * 3 * n * n))
    inter = torch.ones(c, dtype=torch.int32, device=dev)
    refsel = (torch.arange(c, device=dev) % 2).to(torch.int32)
    mvq = mv_i * 4 + 1
    mbufs = {k: tuple(m.clone() for m in motion) for k in ("kernel", "plain")}
    spec(name=f"C10 motion_write (PSS, {n}x{n})", counter="C10 motion PSS",
         path="pss-gt", kernel="motion_write_kernel",
         shape=f"{c} CUs of {n}x{n}, four planes",
         source="hevc_hop_torch/csrc/inter_arms.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:1013",
         fn=lambda: (ia.motion_write(*mbufs["kernel"][:3], pos, inter, mvq,
                                     n, mbufs["kernel"][3], refsel),
                     torch.stack(mbufs["kernel"]))[1],
         plain=lambda: (ia.motion_write_plain(*mbufs["plain"][:3], pos, inter,
                                              mvq, n, mbufs["plain"][3],
                                              refsel),
                        torch.stack(mbufs["plain"]))[1],
         nbytes=c * (20 + 4 * 4 * (n // 4) ** 2), ops=c * 4 * (n // 4) ** 2)
    # C12 with its PSS decide, after C10's PSS form on the same level
    inter0, mv0, smode0, costs, refsel0 = ia.inter_arms(
        *aargs, ipred.clone(), *tail, pss=pss)
    base = (ipred, inter0, mv0, smode0)
    hc_off = H // 2 + 32
    rc = oc.clone()
    head = (ry, oy, rc, pos, zcur, zmax2n, motion, nbav, miav, ring, costs)
    gtail = (n, W, H, hc_off, 8, lam, 16)

    def step(fn):
        b = tuple(t.clone() for t in base)
        r = refsel0.clone()
        return fn(*head, *b, *gtail, r) + b + (r,)

    anchors = gt_anchor_count(pos, zcur, zmax2n, motion, nbav, miav, ring, n,
                              ss.SS_IDX_PSS)
    nflag = int(step(gt.gt_step)[0].sum())
    spec(name=f"C12 gt_decide (PSS, {n}x{n})", counter="C12 decide PSS",
         path="pss-gt", kernel="gt_decide_kernel",
         shape=f"{c} CUs of {n}x{n}, {anchors} causal anchors searched, "
               f"{nflag} GT",
         source="hevc_hop_torch/csrc/gt_search.cu",
         replaces="hevc_hop_tpu/models/ss_scan.py:973",
         fn=lambda: step(gt.gt_step), plain=lambda: step(gt.gt_step_plain),
         nbytes=c * 140 + nflag * (2 * n * n * 4 + 2 * (n + 3) ** 2 * 4),
         ops=nflag * 2 * (mc_ops(n, 4) + warp_ops(n // 2)))
    return _time_specs(specs, checks, launches)


KERNELS = ("checksum_kernel", "intra_kernel", "tq_encode_kernel",
           "tq_encode_rdoq_kernel", "tq_decode_kernel", "rdoq_quant_kernel",
           "deblock_kernel", "partition_rd_kernel",
           "partition_decide_kernel", "sao_stats_kernel", "sao_apply_kernel",
           "mc_kernel", "ss_search_kernel", "ss_rd_kernel",
           "inter_arms_kernel", "motion_write_kernel", "warp_kernel",
           "gt_pred_kernel", "gt_search_kernel", "gt_decide_kernel")


def _profile(fn):
    """Wall time of fn(), the card's busy time within it, and each
    kernel's device time and number of launch records, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer needs a moment after it starts: without it, a window
        # of a few short launches now and then lacks the first records
        time.sleep(0.01)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {k: 0.0 for k in KERNELS}
    calls = {k: 0 for k in KERNELS}
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
                calls[k] += e.count
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1 - busy / 1e3 / (wall * 1e3)
                                  if busy else None),
            "kernel_ms": {k: v / 1e3 for k, v in per.items()},
            "kernel_calls": calls}


def phase_profile(name, ctx):
    """One encode and one decode of a main path's frame, each under
    torch.profiler: the card's idle share of each, and each kernel's
    device time (C2's sums every C2 launch: RMD, chroma, decode). On the
    PSS path the encode is its first PSS picture's (after the ISS one,
    untraced) and the decode the whole sequence's."""
    from hevc_hop_torch.models.decoder import Decoder
    enc, frame = ctx["enc"], ctx["frame"]
    box = {}
    if "frames" in ctx:
        enc.encode_frame(*ctx["frames"][0])
        out = {"encode": _profile(lambda: enc._encode_pss(*frame, 1))}
        box["s"] = ctx["stream"]
    else:
        out = {"encode": _profile(
            lambda: box.setdefault("s", enc.encode_frame(*frame)))}
    out["decode"] = _profile(lambda: Decoder().decode_stream(box["s"]))
    log(f"profile {name}: {json.dumps(out)}")
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
    log_host("start")
    phase_build()
    log_host("built")
    checks = {k: Check() for k in ("C1", "C2", "C3", "C4", "C5", "C6",
                                   "C7", "C8", "C9", "C10", "C11", "C12")}
    phase_kernels(checks)
    phase_rdoq(checks)
    phase_interp(checks)
    phase_warp(checks)
    ps = phase_partition_sao(checks)
    log_host("kernels held")
    paths, ctxs = {}, {}
    for name in PATHS:
        paths[name], ctxs[name] = phase_main_path(name)
        log_host(f"{name} path timed")
    for name, (*_, content) in ISS_PATHS.items():
        run = phase_pss_path if content == "panned" else phase_iss_path
        paths[name], ctxs[name] = run(name)
        log_host(f"{name} path timed")
    gt_share = phase_gt_share(ctxs)
    log_host("gt share timed")
    iss_prepass = phase_iss_kernels(checks, ctxs)
    log_host("lenslet launches held")
    phase_cpu_parity()
    phase_fixture()
    full_fixtures = phase_full_fixtures(ctxs)
    log_host("parity and fixtures done")
    cli_s = phase_cli()
    cli_holo_s = phase_cli_holo(ctxs)
    log_host("CLI done")
    bdrate = phase_bdrate()
    log_host("parity, fixtures, CLI and BD-rate done")
    launches = {k: v["launches"] for k, v in paths.items()}
    rows = (phase_timing(ctxs, ps, checks, launches)
            + phase_iss_timing(ctxs, checks, launches)
            + phase_gt_timing(ctxs, checks, launches)
            + phase_pss_timing(ctxs, checks, launches))
    for name in paths:
        paths[name]["profile"] = phase_profile(name, ctxs[name])
    for r in rows:
        # C7's frame time is that of the arm it runs in, transforms included
        k = r.get("frame_kernel", r["kernel"])
        r["frame_ms"] = {
            name: {side: prof[side]["kernel_ms"][k]
                   if prof[side]["device_busy_ms"] else None
                   for side in ("encode", "decode")}
            for name, prof in ((n, paths[n]["profile"]) for n in paths)}
    log_host("end")
    log(card)
    log(json.dumps({"main_paths": paths, "cli_s": cli_s,
                    "cli_holo_s": cli_holo_s, "card": card,
                    "iss_prepass_check": iss_prepass, "bdrate": bdrate,
                    "gt_share": gt_share,
                    "full_fixtures": full_fixtures}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
