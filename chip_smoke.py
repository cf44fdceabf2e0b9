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
   within COST_RTOL (each count printed). Kernels C4 and C6 in their
   one-launch-a-picture forms (phase_loopfilter): C4 on views of taller
   buffers as the encoders pass them, 1920x1088 and 416x240 (partial
   tiles), 8 and 10 bit, the intra maps and random inter maps, QP 10
   (chroma tc 0), 22 and 37 with offsets, inputs untouched; C6's
   statistics over the three planes at ctb_log2 4-6 with flat CTUs whose
   samples all fall in one band at the largest differences, and its apply
   with random maps of every type (bands wrapping past 31) and partial
   CTUs, against the plain versions and the one-plane forms: 0
   mismatching elements. Kernel C8 (motion compensation)
   at every luma size 4-32 and chroma size 2-16, every phase, 8 and 10
   bit, windows clamped at every edge, in its three forms. Kernel C11 (the
   GT warp) on every golden case of tests/golden/hm_golden.json and a
   sweep of both forms (luma 8-32, chroma 4-16, 8 and 10 bit, corners to
   +-n, the knife edges reached), prediction and safety mask, and its
   plane entries in their masked and add-residual forms. Kernels C10 (the
   arms entry, ISS and PSS) and C12 (the search and decide step, ISS and
   PSS; the search alone on the anchors) bit for bit, floats by their
   bits, against their plain bodies and their split emulations on
   ARMS_W x ARMS_H pictures at n = 8, 16, 32, 8 and 10 bit, noise (the
   10-bit 32x32 SSEs pass 2^24) and flat planes (least costs tie): 0
   mismatching elements, the count logged (phase_arms_exact);
3. main paths, all on the card, each with every launch count set to 0
   just before it and read just after:
   - production: bench.py's production configuration, the all-intra
     encode of 1920x1088 frames with the RD pre-pass, NxN, the residual
     quadtree, RDOQ, SBH, deblocking, SAO and the checksum SEI, and the
     decode of that stream; the frame's wavefront runs as one launch of
     kernel C13 each way (C2's and C3's device code, C7's in its RDOQ
     arm), and no per-level C2 or C3 encode launch; recon ==
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
   - encode frames: IntraEncoder.encode_frames, the two-stage pipeline
     (frame i+1's device programs enqueued before frame i's SAO decision
     and CABAC), on the production configuration over bench.py's four
     distinct frames (synth_class_b seeds FRAMES_SEEDS), its launch counts
     set to 0 just before and read just after: C5, C13, C4, C6 and C1
     once a frame; streams byte for byte those of encode_frame calls, each
     decoding with hash_ok, recon_yuv the last frame's; no
     torch.cuda.synchronize inside _stage1; frame i+1's C13 complete (the
     event behind its launch) when frame i's host SAO decision ends; then
     FRAMES_TURNS turns of both forms, encode s a frame;
   - scan program: on each of the three paths' frames (and the noisy
     frame of the production path), C13's encode entry held against the
     level loop of C2 and C3 launches and against the level loop of their
     plain versions, all on the card (recon, level planes, modes, cbfs),
     and its decode entry on the encode's own dense residual against both
     loops and against the encode's recon: 0 mismatches; the grid it
     chose, and the three scans' times;
   - iss: the lenslet ISS encode (bench.py:88-100's cell with the GT warp
     off, at 1920x1088: quadtree pre-pass with C9's pre-pass entry,
     self-similarity search C9, merge arms, sub-pel refinement and the
     tournament C10, chroma MC C8, RDOQ, SAO, deblocking with the inter
     boundary strengths) of a copy of tools/bdrate.py's lenslet frame and
     its decode, ISS_TIMED_FRAMES timed frames; the picture's wavefront
     runs as one launch of kernel C14 each way (the device code of C2,
     C3, C7, C8, C9, C10, C11 and C12), and the ISS paths fail on any
     per-level launch of those kernels;
   - iss-uniform: the same with uniform 16x16 CUs and in-loop RMD, one
     timed frame;
   - iss-gt: bench.py:88-100's lenslet cell whole, the GT warp on (C9's
     anchor ring, C12's corner search and decision, C11's GT chroma and
     decode), ISS_TIMED_FRAMES timed frames, its GT area printed;
   - iss-gt-warped: tests/test_e2e_iss.py's GT configuration (16x16 CUs,
     QP 37) on a copy of its warped lenslet content at 1920x1088, where
     GT engages (the run fails if it never does), two timed frames;
   - ss scan program: on the four ISS paths' frames, C14's encode entry
     held against the level loop of the card's kernels (recon, level
     planes, every per-CU output) and its decode entry, on the decoder's
     own inputs for the path's stream, against the decode loop and the
     encode's recon; then C14 and the loop in turns in this process
     (encode s, scan_s, decode s); the grid it chose; in the traced part
     at the end C14's device ms per picture each way; and last of all
     both entries against the plain loop on a SS_PLAIN_W x SS_PLAIN_H
     corner of each frame and, at full size, on PLAIN_FULL's pictures;
   - pss-gt: the iss-gt configuration (search_range_t 16) on a low-delay
     holoscopic sequence of PSS_FRAMES pictures through
     HoloEncoder.encode_sequence, an ISS picture then PSS ones whose L0 is
     [the previous picture, the SS reference] (C9's temporal search, its
     pre-pass with the temporal arm, C10's and C12's PSS forms, C8 out of
     the previous picture), on a copy of
     make_jax_fixture.py's pss_frames (the lenslet frame panned one
     sample per frame): every picture hash_ok and equal to the recon
     history, temporal prediction chosen (each PSS picture's share
     printed); then PSS_TIMED_TURNS more codings of the sequence, each PSS
     picture timed; the ISS picture is one C14 launch each way, each PSS
     picture one launch of C14's PSS form each way (C9's, C10's, C12's
     and C8's device code inside it), and the path fails on any per-level
     C2, C3, C8, C9, C10, C11 or C12 launch;
   - pss scan program: on both PSS pictures of the pss-gt sequence, C14's
     PSS form held against the PSS level loop of the card's kernels
     (recon, level planes, every per-CU output with the reference index)
     and its decode entry, on the decoder's own inputs, against the
     decode loop and the encode's recon; C14 and the loop in turns in
     this process (the PSS picture's encode s and scan_s, the sequence's
     decode s); in the traced part at the end its device ms per PSS
     picture each way; and last of all both entries against the plain
     loop on the last PSS picture at full size and on a SS_PLAIN_W x
     SS_PLAIN_H corner of the sequence's first two pictures. Every CU of
     pss-gt's PSS pictures is temporal, so C14's PSS form is also held on
     a two-picture sequence whose PSS picture holds temporal, SS, GT and
     intra CUs (mixed_frames: the warped lenslet content with chroma made
     from its luma, panned MIXED_PAN samples, MIXED_CONFIG), each kind
     required: at full size against the card's loop, and at MIXED_PLAIN's
     sizes against the card's loop and the plain loop, each way;
   - mesh: hevc_hop_torch.parallel's MeshIntraEncoder (16x16 CUs, in-loop
     RMD, RDOQ, SBH, deblocking, SAO off) on a virtual (2 frames, 2 bands)
     mesh on the card over synth_class_b seeds 0 and 1, and
     analysis_step_sharded at n = 16 on the two luma planes over a
     virtual (2, 2) row mesh: both streams equal the single-device
     encoder's and the committed JAX mesh fixture byte for byte, decode
     with hash_ok to last_recons; one frame on a (1, 17) mesh (a halo
     every second CTU row) writes the same stream; one more encode with
     its C2 and C3 launches held against the plain bodies (the fullest
     level and every eighth); C2's analysis entry held at n = 4 to 32;
     MESH_TIMED_TURNS turns, each the mesh's two frames then the
     single-device encoder on them, with the host probes; the bound of
     both level loops (profiles of both and of the analysis come last,
     with the other paths');
   and for the two GT paths the GT tool's share of the encode, each path's
   encoder against a gt=False twin on its frame, in turns in one process;
   then C9's pre-pass entry on every block of the lenslet luma against
   its plain body (in chunks), with the temporal arm on every block of
   the pss-gt path's second picture, and one more encode and decode of
   each ISS path with its C8, C9, C10 and C4 launches held against the
   plain bodies (the ISS pictures through the level loop, whose stream
   must equal C14's; the fullest level of each size and every eighth level),
   and on the GT paths every launch of C9 (with its ring), C12 and C11;
   on the pss-gt path (the sequence through the level loop, whose stream
   must equal C14's) every launch of its PSS pictures' forms (C9's SS and
   temporal searches and its pre-pass, C10, C12) and every C8 and C11
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
   plain version's time per call (CUDA events); before them
   torch.profiler over one more encode and one more decode of each path
   for each kernel's device time per frame and the card's idle share (a
   trace must hold the frame's C13 or C14 record; every trace of the run
   comes in this last part). The kernels of the
   ISS paths get rows the same way: C9's scan entry (with a grouped
   float32 conv2d of the same windows as its library yardstick), its
   pre-pass entry, C10's two entries, C8's two forms and C4 with the ISS
   frame's inter maps; and those of the GT paths: C9's scan entry with
   the ring, C12's search and decide entries, and C11's two plane
   entries; and those of the PSS path, at its last picture's fullest
   32x32 level: C9's scan entry with the temporal search (a grouped
   conv2d of the temporal windows as its library yardstick), its pre-pass
   entry with the temporal arm, C10's PSS forms and C12's PSS decide;
   and those of the mesh path: C2's RMD and C3's RDOQ arm at the fullest
   level of the stacked (2, 2) mesh, and C2's analysis entry at n = 16;
   and C13's encode entry on the production and uniform frames and its
   decode entry on the production frame, whole frames, beside the bound
   of the frame's work (scan_bound) and the plain loop's time; and C14's
   encode entry on the iss picture and its decode entry on the
   iss-gt-warped one, whole pictures, beside the bound of the picture's
   work (ss_encode_work, ss_decode_work), the plain loop's time and the
   card's loop's; and C14's PSS form each way on the pss-gt path's last
   PSS picture, beside the bound of its work (the temporal search
   counted), the card's loop's time and the plain loop's.
   On the ISS paths C8's to C12's device code runs inside C14, and on the
   PSS pictures inside its PSS form, so their rows there count C14's
   launches. The run's total seconds are printed.

It prints the card's name and power limit, one JSON line for the kernels,
one for the main paths, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the run's start, for its total seconds
T_START = time.perf_counter()
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
# int8 on the tensor cores (NVIDIA data sheet, 1979 TOP/s dense, a
# multiply-add counted as two operations): kernel C9's correlation of 8-bit
# samples is a matrix product of the block against the window's rows
PEAK_INT8_OPS = 1979e12

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
# the QP of C5's 10-bit noise check: its 32x32 blocks' SSEs pass 2^24
NOISE_QP = 51


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

# the stage-clock builds of csrc/ss_scan.cu ("so") and csrc/scan.cu
# ("scan"), started by phase_build once the production libraries are built
# and awaited by phase_stage_clock and phase_scan_clock: they compile while
# the phases between run
_CLOCK_BUILD = {}


def phase_build():
    """Every kernel library, one nvcc per source, all started together; the
    CABAC library; then the stage-clock build started in the background."""
    from concurrent.futures import ThreadPoolExecutor
    from hevc_hop_torch import _cuda
    from hevc_hop_torch.entropy import native
    t0 = time.perf_counter()
    _cuda.build_all()
    for name in _cuda.sources():
        _cuda.lib(name)
    native.get_lib()
    log(f"build: {_cuda.sources()} and libhevc_hop.so in "
        f"{time.perf_counter() - t0:.1f} s")
    ex = ThreadPoolExecutor(2)
    _CLOCK_BUILD["so"] = ex.submit(_cuda.variant, "ss_scan", "clock",
                                   CLOCK_FLAGS)
    _CLOCK_BUILD["scan"] = ex.submit(_cuda.variant, "scan", "clock",
                                     CLOCK_FLAGS)
    ex.shutdown(wait=False)
    for name, kernel in (("scan", "C13"), ("ss_scan", "C14"),
                         ("partition", "C5"), ("inter_arms", "C10"),
                         ("gt_search", "C12"), ("deblock", "C4"),
                         ("sao", "C6")):
        log(f"ptxas, csrc/{name}.cu (kernel {kernel}):\n"
            + _cuda.BUILD_LOGS.get(name, "(built before this run)").strip())


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


# C3's encode body on more than the path's cases: (QP, bit depth,
# residuals at +-maxv, RDOQ), each at one plane a size (C3_ENCODE_PLANE:
# the DST and MDCS scans at 4x4 luma, chroma at 16x16)
C3_ENCODE_CASES = ((4, 8, False, False), (51, 8, False, False),
                   (22, 10, False, False), (22, 8, True, False),
                   (37, 10, True, False), (22, 8, False, True),
                   (4, 10, True, True))
C3_ENCODE_PLANE = {4: 0, 8: 0, 16: 1, 32: 0}


def _c3_encode_cases(checks, org, pred, pos, modes, n, c_idx):
    """C3's encode entry against its plain body on C3_ENCODE_CASES: org and
    pred as given (8 bit), scaled to 10 bit, or set to 0 and maxv where the
    other is maxv and 0; the RDOQ arm at the level loop's init type and
    lambda."""
    import torch
    from hevc_hop_torch.models.partition import full_lambda
    from hevc_hop_torch.ops import tq
    for qp, bd, extreme, use_rdoq in C3_ENCODE_CASES:
        maxv = (1 << bd) - 1
        o, p = (org, pred) if bd == 8 else (org * 4 + 3, pred * 4)
        if extreme:
            o = torch.where(o > maxv // 2, maxv, 0).to(torch.int32)
            p = torch.full_like(pred, maxv)
            p[:, ::2] = 0
        rq = (2, full_lambda(qp)) if use_rdoq else None
        outs = []
        for fn in (tq.tq_encode, tq.tq_encode_plain):
            rec = torch.zeros_like(o)
            cp = torch.zeros(o.shape, dtype=torch.int16, device=o.device)
            cbf = fn(o, p.contiguous(), pos, modes, n, c_idx, qp, bd, True,
                     rq, rec, cp)
            outs.append((rec, cp, cbf))
        for i, what in enumerate(("recon", "levels", "cbf")):
            (checks["C7"] if rq else checks["C3"]).add(
                outs[0][i], outs[1][i],
                f"C3 encode{' (RDOQ)' if rq else ''} {what} n={n} "
                f"c={c_idx} qp={qp} {bd} bit{' +-maxv' if extreme else ''}")


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
            if c_idx == C3_ENCODE_PLANE[n]:
                _c3_encode_cases(checks, org, pred, pos, modes, n, c_idx)
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
    # C3's decode entry over a whole synthetic picture: every TU size, all
    # three planes, all-zero TUs and levels at the int16 extremes
    for bd, dst in ((8, True), (10, False)):
        planes, classes = synth_residual_picture(rng, W, H, bd, dst, dev)
        kern = [(c, torch.full_like(o, 777), qp, d)
                for c, o, qp, d in planes]
        tq.tq_decode_picture(kern, classes, bd)
        tq.tq_decode_picture_plain(planes, classes, bd)
        for (_, k, _, _), (_, p, _, _), nm in zip(kern, planes,
                                                  ("y", "cb", "cr")):
            c3.add(k, p, f"C3 decode, a synthetic {W}x{H} picture, "
                   f"{bd} bit, {nm}")
    torch.cuda.synchronize()
    log("kernels: " + ", ".join(
        f"{k} {checks[k].cases} cases {checks[k].mism} mismatches"
        for k in ("C1", "C2", "C3", "C4")))


def synth_residual_picture(rng, w, h, bit_depth, dst, dev):
    """A picture's levels for C3's decode entry: each 32x32 area of the
    luma split at random into TUs of 4x4 to 32x32 (the chroma one size
    down, an NxN CU's chroma one 4x4 TU), each TU all zero, a
    low-frequency corner, sparse noise or a mix of the int16 extremes.
    Returns (planes of tq_decode_picture with zeroed outputs, classes)."""
    import torch
    from hevc_hop_torch.common import rom
    tus = []

    def split(x, y, lg):
        if lg > 2 and rng.random() < (0.3 if lg == 5 else 0.5):
            s = 1 << (lg - 1)
            for dy in (0, s):
                for dx in (0, s):
                    split(x + dx, y + dy, lg - 1)
        else:
            tus.append((x, y, lg))
    for y in range(0, h, 32):
        for x in range(0, w, 32):
            split(x, y, 5)
    ctus = [(x // 2, y // 2, lg - 1) for x, y, lg in tus if lg > 2]
    ctus += sorted({(x // 8 * 4, y // 8 * 4, 2) for x, y, lg in tus
                    if lg == 2})

    def levels(ph, pw, ts):
        lev = np.zeros((ph, pw), np.int16)
        for x, y, lg in ts:
            n = 1 << lg
            kind = rng.integers(0, 4)
            if kind == 1:
                k = rng.integers(1, n + 1)
                lev[y:y + k, x:x + k] = rng.integers(-40, 41, (k, k))
            elif kind == 2:
                lev[y:y + n, x:x + n] = rng.choice([-32768, 32767, 0, 1],
                                                   (n, n))
            elif kind == 3:
                lev[y:y + n, x:x + n] = rng.integers(-300, 301, (n, n)) * (
                    rng.random((n, n)) < 0.2)
        return torch.as_tensor(lev).to(dev)
    qp = int(rng.integers(0, 52))
    qpc = int(rom.chroma_qp_from_luma(qp))
    zeros = lambda ph, pw: torch.zeros((ph, pw), dtype=torch.int32,
                                       device=dev)
    planes = [(levels(h, w, tus), zeros(h, w), qp, dst)] + [
        (levels(h // 2, w // 2, ctus), zeros(h // 2, w // 2), qpc, False)
        for _ in range(2)]
    by = lambda ts, lg: torch.as_tensor(
        np.array([(x, y) for x, y, g in ts if g == lg], np.int32).reshape(
            -1, 2), device=dev)
    classes = [(0, lg, by(tus, lg)) for lg in (2, 3, 4, 5)] + [
        (c, lg, by(ctus, lg)) for c in (1, 2) for lg in (2, 3, 4)]
    return planes, classes


@contextlib.contextmanager
def holding_residual(check, what):
    """While it is entered, every picture's one-launch residual (C3's
    decode entry, as the decoder launches it on the parsed level planes)
    is held against tq_decode_picture_plain on the same planes and
    classes. Yields the list of pictures held."""
    import torch
    from hevc_hop_torch.models import decoder as dmod
    from hevc_hop_torch.ops import tq
    real, held = dmod.tq_decode_picture, []

    def hold(planes, classes, bit_depth):
        real(planes, classes, bit_depth)
        plain = [(c, torch.zeros_like(o), qp, d) for c, o, qp, d in planes]
        tq.tq_decode_picture_plain(plain, classes, bit_depth)
        for (_, o, _, _), (_, p, _, _), nm in zip(planes, plain,
                                                  ("y", "cb", "cr")):
            check.add(o, p, f"C3 decode, {what}, picture {len(held)}, {nm}")
        held.append(len(classes))
    dmod.tq_decode_picture = hold
    try:
        yield held
    finally:
        dmod.tq_decode_picture = real


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
        require(tally["costs_not_bit_equal"] == 0,
                f"C5 bd={bd}: {tally['costs_not_bit_equal']} costs differ "
                "from the plain body's")

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
            ctx = dict(y=y, kern=kern, planes=planes, maps=maps,
                       type3=type3, off=off, band=band)
    # 10-bit noise at QP 51: at 16x16 and 32x32 a block's SSE passes 2^24,
    # where C5 sums it in the compiled reference's order (the 32x32 rows'
    # order differs between the arms) instead of as an exact integer; every
    # cost must equal the plain body's bit for bit
    noise = torch.as_tensor(rng.integers(0, 1024, (384, 512)),
                            dtype=torch.int32, device=dev)
    noisy = {}
    for n in (16, 32):
        got, want = (partition.rd_costs(noise, n, NOISE_QP, 10),
                     partition.rd_costs_plain(noise, n, NOISE_QP, 10))
        noisy[f"rd {n}"] = c5.add_close(got[0], want[0], COST_RTOL,
                                        f"C5 rd n={n} 10-bit noise")
        differ, faults = mode_faults(got, want)
        require(faults == 0, f"C5 rd n={n} 10-bit noise: {faults} of "
                f"{differ} blocks whose modes differ are no near-tie")
        # the residual quadtree's arm: half-size TUs with the CU's mode, and
        # the CU's own size with its mode
        for m in (n // 2, n):
            forced = up2(got[1]) if m < n else got[1].contiguous()
            noisy[f"forced {m} ({n}'s modes)"] = c5.add_close(
                partition.rd_costs_forced(noise, forced, m, NOISE_QP, 10),
                partition.rd_costs_plain(noise, m, NOISE_QP, 10, forced)[0],
                COST_RTOL, f"C5 rd forced n={m} 10-bit noise")
        require(bool((got[0] > 2 ** 24).any()),
                f"C5 10-bit noise: no {n}x{n} cost passes 2^24")
    log("C5 10-bit noise at QP 51, costs not bit-equal to the plain body's: "
        + json.dumps(noisy))
    require(not any(noisy.values()),
            f"C5 10-bit noise: costs differ from the plain body's: {noisy}")
    torch.cuda.synchronize()
    log("kernels at the main path's shapes: " + ", ".join(
        f"{k} {checks[k].cases} cases {checks[k].mism} mismatches"
        for k in ("C5", "C6")))
    return ctx


def _encoder_views(rng, w, h, bit_depth, dev):
    """(y, cb, cr) int32 on the card as the encoders hand them to C4 and
    C6: rows of a luma buffer with padding rows below, and two row ranges
    of one stacked chroma buffer. Blocky content (_blocky)."""
    import torch
    hc, pad = h // 2, 32
    scale = 1 << (bit_depth - 8)
    by = torch.zeros((h + pad, w), dtype=torch.int32, device=dev)
    bc = torch.zeros((2 * hc + 2 * pad, w // 2), dtype=torch.int32,
                     device=dev)
    t = lambda a: torch.as_tensor(a * scale, dtype=torch.int32, device=dev)
    by[:h] = t(_blocky(rng, h, w))
    bc[:hc] = t(_blocky(rng, hc, w // 2))
    bc[hc + pad:2 * hc + pad] = t(_blocky(rng, hc, w // 2))
    return by[:h], bc[:hc], bc[hc + pad:2 * hc + pad]


def _random_inter_maps(rng, w, h, dev):
    import torch
    u = (h // 4, w // 4)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return dict(pred4=t(rng.random(u) < 0.3, torch.uint8),
                cbf4=t(rng.random(u) < 0.3, torch.uint8),
                ref4=t(rng.random(u) < 0.1, torch.uint8),
                mv4x=t(rng.integers(-6, 7, u), torch.int16),
                mv4y=t(rng.integers(-6, 7, u), torch.int16))


def phase_loopfilter(checks):
    """Kernels C4 and C6 as the main paths launch them, one launch a
    picture each: C4 on the encoders' views (1920x1088 and 416x240, whose
    last tiles are partial), 8 and 10 bit, intra and random inter maps, QP
    10, 22 and 37 with offsets; C6's statistics over the three planes at
    ctb_log2 4-6 (416x240 holds 16x16 CTUs only), flat CTUs in one band at
    the largest differences, the one-copy fetch; C6's apply with random
    maps of every type, bands wrapping past 31, partial CTUs, the packed
    upload; each against its plain version, the one-plane forms against
    the three-plane ones."""
    import torch
    from hevc_hop_torch.ops import deblock, sao
    dev = torch.device("cuda")
    c4, c6 = checks["C4"], checks["C6"]
    rng = np.random.default_rng(17)
    for (w, h) in ((W, H), (416, 240)):
        for bd in (8, 10):
            planes = _encoder_views(rng, w, h, bd, dev)
            bases = [p._base if p._base is not None else p for p in planes]
            keep = [b.clone() for b in bases]
            tu4 = torch.as_tensor(rng.integers(2, 6, (h // 4, w // 4)),
                                  dtype=torch.uint8, device=dev)
            for arm, maps in (("intra", {}),
                              ("inter", _random_inter_maps(rng, w, h, dev))):
                for qp, off in ((10, (0, 0)), (22, (0, 0)), (37, (2, -1))):
                    what = f"C4 {w}x{h} {bd} bit {arm} qp={qp}"
                    got = deblock.deblock_frame(*planes, tu4, qp, qp - 2, bd,
                                                *off, **maps)
                    want = deblock.deblock_frame_plain(*planes, tu4, qp,
                                                       qp - 2, bd, *off,
                                                       **maps)
                    dense = deblock.deblock_frame(
                        *(p.contiguous() for p in planes), tu4, qp, qp - 2,
                        bd, *off, **maps)
                    for g, w_, d, nm in zip(got, want, dense,
                                            ("y", "cb", "cr")):
                        c4.add(g, w_, f"{what} {nm}")
                        c4.add(g, d, f"{what} {nm}, views against copies")
            for b, k in zip(bases, keep):
                c4.add(b, k, f"C4 {w}x{h} {bd} bit: the inputs untouched")
    for (w, h), lgs in (((W, H), (4, 5, 6)), ((416, 240), (4, 5, 6))):
        for lg in lgs:
            for bd in (8, 10):
                maxv = (1 << bd) - 1
                org = _encoder_views(rng, w, h, bd, dev)
                pre = tuple((o + torch.as_tensor(
                    rng.integers(-6, 7, tuple(o.shape)) << (bd - 8),
                    dtype=torch.int32, device=dev)).clamp(0, maxv)
                    for o in org)
                for i, (o, p) in enumerate(zip(org, pre)):
                    # a flat CTU in one band, org at both extremes; a flat
                    # CTU at the top band, org 0
                    c = (1 << lg) >> (i > 0)
                    p[:c, c:2 * c] = maxv // 3
                    o[:c, c:2 * c] = torch.as_tensor(
                        rng.choice([0, maxv], (c, c)), dtype=torch.int32,
                        device=dev)
                    p[c:2 * c, :c] = maxv
                    o[c:2 * c, :c] = 0
                what = f"C6 {w}x{h} ctb_log2={lg} {bd} bit"
                c = 1 << lg
                if h % c == 0 and w % c == 0:
                    st = sao.stats_dispatch(org, pre, lg, bd)
                    want = sao.sao_stats_frame_plain(org, pre, lg, bd)
                    c6.add(st.packed, want, f"{what} stats")
                    host = sao.fetch_stats(st)
                    for i in range(3):
                        one = sao.sao_stats_plane(org[i], pre[i],
                                                  lg - (i > 0), bd)
                        for g, f, w_ in zip(one, host[i], st[i]):
                            c6.add(g, w_, f"{what} stats, one plane {i}")
                            c6.add(torch.as_tensor(f), w_.cpu(),
                                   f"{what} stats, fetched plane {i}")
                nn = (-(-h // c), -(-w // c))
                type3 = rng.integers(0, 6, nn + (3,)).astype(np.uint8)
                off = rng.integers(-7, 8, nn + (3, 4)).astype(np.int16)
                band = rng.integers(0, 32, nn + (3,)).astype(np.uint8)
                got = sao.apply_sao_frame(*pre, type3, off, band, lg, bd)
                params = torch.as_tensor(np.concatenate(
                    [type3[..., None], band[..., None], off], -1),
                    dtype=torch.int32, device=dev)
                want = sao.apply_sao_frame_plain(pre, params, lg, bd)
                for i in range(3):
                    c6.add(got[i], want[i], f"{what} apply plane {i}")
                    one = sao.apply_sao_plane(
                        pre[i], params[:, :, i, 0], params[:, :, i, 2:],
                        params[:, :, i, 1], lg - (i > 0), bd)
                    c6.add(one, want[i], f"{what} apply, one plane {i}")
    torch.cuda.synchronize()
    log("loop filters, one launch a picture: " + ", ".join(
        f"{k} {checks[k].cases} cases {checks[k].mism} mismatches"
        for k in ("C4", "C6")))


def _tie_costs(rng, by, bx, costs, nxn=True, rqt=True):
    """Decision inputs of a by x bx CTU grid for the arm (nxn, rqt), built
    from a few values, each comparison of the arm's decision made an exact
    float32 tie (when one exists) and then won, kept or lost by 64 at
    random; ``costs`` is _decide_costs(qp). Returns the six cost grids,
    the four mode grids and the count of exact ties per comparison."""
    mc, sc, nc, cc = (np.float32(c) for c in costs)
    f32 = np.float32
    vals = np.array([96, 160, 224, 352], np.float32)

    def pick(h, w, scale=1):
        return rng.choice(vals, (h, w)).astype(np.float32) * f32(scale)

    def s4(a):
        return ((a[0::2, 0::2] + a[0::2, 1::2]) + a[1::2, 0::2]) \
            + a[1::2, 1::2]

    def near(target, add):
        x = (target - add).astype(np.float32)
        for _ in range(4):
            s = (x + add).astype(np.float32)
            x = np.where(s < target, np.nextafter(x, f32(np.inf)),
                         np.where(s > target,
                                  np.nextafter(x, f32(-np.inf)), x))
        return (x + f32(64) * rng.integers(-1, 2, x.shape)).astype(
            np.float32)

    def up2(a):
        return np.repeat(np.repeat(a, 2, 0), 2, 1)

    # the sub-TU costs at the scale of the costs they are held against; a
    # CU held against its split gets sub-TU costs 8 times as high, so that
    # the TU split does not take it; without the TU-split arm every CU is
    # held against its split
    rd4 = pick(8 * by, 8 * bx)
    to_split16 = (rng.random((2 * by, 2 * bx)) < 0.5) | (not rqt)
    to_split32 = (rng.random((by, bx)) < 0.5) | (not rqt)
    f16 = pick(4 * by, 4 * bx, 4) * np.where(up2(to_split16), f32(8), 1)
    f32_ = pick(2 * by, 2 * bx, 16) * np.where(up2(to_split32), f32(8), 1)
    nxn8 = s4(rd4) + nc
    rd8 = near(nxn8, mc) if nxn else pick(4 * by, 4 * bx, 4)
    best8 = np.minimum(rd8 + mc, nxn8) if nxn else rd8 + mc
    cut16, split16 = s4(f16) + cc, s4(best8) + sc
    rd16 = np.where(to_split16, near(split16, mc), near(cut16, mc))
    cu16 = np.minimum(rd16 + mc, cut16) if rqt else rd16 + mc
    lvl16 = np.where(cu16 <= split16, cu16, split16)
    cut32, split32 = s4(f32_) + cc, s4(lvl16) + sc
    rd32 = np.where(to_split32, near(split32, mc), near(cut32, mc))
    cu32 = np.minimum(rd32 + mc, cut32) if rqt else rd32 + mc
    ties = {"nxn8 == cu8": int((rd8 + mc == nxn8).sum()) if nxn else 0,
            "cut16 == cu16": int((rd16 + mc == cut16).sum()) if rqt else 0,
            "cu16 == split16": int((cu16 == split16).sum()),
            "cut32 == cu32": int((rd32 + mc == cut32).sum()) if rqt else 0,
            "cu32 == split32": int((cu32 == split32).sum())}
    modes = [rng.integers(0, 35, (k * by, k * bx)).astype(np.int32)
             for k in (8, 4, 2, 1)]
    return (rd4, rd8, rd16, rd32, f16, f32_), modes, ties


def _strided(rng, h, w, lo, hi, dev, offset):
    """An int32 [h, w] view of a wider, taller buffer on the card, its
    samples in [lo, hi): from row 1, column 3 with ``offset`` (base and
    row stride not multiples of 16 bytes: C1's scalar arm), else from the
    origin of rows padded to a multiple of 4 samples plus 4."""
    import torch
    if offset:
        buf = torch.as_tensor(rng.integers(lo, hi, (h + 2, w + 5)),
                              dtype=torch.int32, device=dev)
        return buf[1:1 + h, 3:3 + w]
    buf = torch.as_tensor(rng.integers(lo, hi, (h, (w + 3) // 4 * 4 + 4)),
                          dtype=torch.int32, device=dev)
    return buf[:, :w]


def phase_checksum_decide(checks):
    """Kernel C1 and C5's decide entry on the inputs that reach their
    scalar arms, odd shapes and ties. C1: strided views of wider buffers
    with an unaligned base (the scalar arm) and aligned ones, odd widths,
    1920x1088 and 416x240 planes, 8 and 10 bit; a 10-bit 4096x2176
    picture; a 4096x2176 picture of 16-bit samples (the arm above 8 bit)
    whose luma sum passes 2^32 (a 10-bit picture of that size cannot: its
    sum stays under 3.5e9); two launches back to back on one stream with
    different grids, and one on a second stream, each with its ticket
    counter back at 0 after it; against _checksum_plain, and the largest
    also against checksum_digests_np. C5 decide: costs with exact ties
    (_tie_costs) at 1920x1088 and on a 13x7 CTU grid, every arm, against
    decide_plain. 0 mismatches."""
    import torch
    from hevc_hop_torch.models import partition
    from hevc_hop_torch.ops import hashes
    dev = torch.device("cuda")
    c1, c5 = checks["C1"], checks["C5"]
    rng = np.random.default_rng(23)
    cases = []
    for (w, h) in ((W, H), (416, 240), (66, 34), (1922, 1090)):
        for bd in (8, 10):
            for offset in (True, False):
                planes = [_strided(rng, hh, ww, 0, 1 << bd, dev, offset)
                          for hh, ww in ((h, w), (h // 2, (w + 1) // 2),
                                         ((h + 1) // 2, w // 2))]
                cases.append((f"{w}x{h} {bd} bit, views "
                              + ("from an unaligned base" if offset
                                 else "of padded rows"), planes, bd))
    cases.append(("one plane 33x17 (odd width)", [_strided(
        rng, 17, 33, 0, 256, dev, False)], 8))
    cases.append(("two planes 1920x1088 and 7x9, unaligned", [
        _strided(rng, H, W, 0, 1024, dev, True),
        _strided(rng, 7, 9, 0, 1024, dev, True)], 10))
    for what, planes, bd in cases:
        got = hashes.plane_checksums(planes, bd)
        want = [hashes._checksum_plain(p, bd) for p in planes]
        c1.add(got, want, f"C1 {what}")
    # 4096x2176: a 10-bit picture, and one whose samples' low and high
    # bytes are both the position mask's complement (each sample adds
    # 510 before the wrap: 4.5e9 on the luma)
    big_w, big_h = 4096, 2176
    pic10 = [torch.as_tensor(rng.integers(0, 1024, (hh, ww)),
                             dtype=torch.int32, device=dev)
             for hh, ww in ((big_h, big_w), (big_h // 2, big_w // 2),
                            (big_h // 2, big_w // 2))]
    top, raw = [], 0
    for hh, ww in ((big_h, big_w), (big_h // 2, big_w // 2),
                   (big_h // 2, big_w // 2)):
        x = torch.arange(ww, device=dev)[None, :]
        y = torch.arange(hh, device=dev)[:, None]
        xm = ((x & 255) ^ (y & 255) ^ (x >> 8) ^ (y >> 8)) & 255
        v = (255 - xm) * 257
        top.append(v.to(torch.int32))
        # the luma's sum in int64, without the wrap
        raw = raw or int((((v & 255) ^ xm) + ((v >> 8) ^ xm)).sum())
    require(raw > 1 << 32, f"C1: the 16-bit luma's sum {raw} stays under "
            "2^32")
    for what, planes, bd in (("4096x2176 10 bit", pic10, 10),
                             ("4096x2176 16-bit samples, luma sum "
                              f"{raw} past 2^32", top, 16)):
        got = hashes.checksum_digests(*planes, bit_depth=bd)
        want = [hashes._digest(hashes._checksum_plain(p, bd))
                for p in planes]
        host = hashes.checksum_digests_np(*(p.cpu().numpy() for p in planes),
                                          bit_depth=bd)
        c1.add([list(d) for d in got], [list(d) for d in want],
               f"C1 {what}")
        c1.add([list(d) for d in got], [list(d) for d in host],
               f"C1 {what}, against checksum_digests_np")
    # back to back on one stream, then on a second stream: a ticket counter
    # left off 0 by a launch would make the next one's sums wrong
    outs = [torch.empty(3, dtype=torch.int32, pin_memory=True)
            for _ in range(3)]
    runs = ((pic10, 10), (cases[0][1], 8), (top[:1], 16))
    hashes.checksum_launch(*runs[0], outs[0])
    hashes.checksum_launch(*runs[1], outs[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hashes.checksum_launch(*runs[2], outs[2])
    torch.cuda.synchronize()
    for i, ((planes, bd), out) in enumerate(zip(runs, outs)):
        got = [v & 0xFFFFFFFF for v in out.tolist()[:len(planes)]]
        want = [hashes._checksum_plain(p, bd) for p in planes]
        c1.add(got, want, f"C1 launch {i} of three back to back")
    for (_, st), ws in hashes._WORKSPACE.items():
        require(int(ws[-1]) == 0, f"C1: stream {st}'s ticket counter is "
                f"{int(ws[-1])} after its launches")
    ctas = hashes._resident_ctas(dev)[0]
    grids = [hashes.band_plan(tuple(tuple(p.shape) for p in pl), ctas)[2]
             for pl, _ in runs]
    log(f"C1: {ctas} CTAs resident; the back-to-back launches' grids "
        f"{grids}")
    for (by, bx) in ((H // 32, W // 32), (7, 13)):
        for qp in (22, 32):
            for arm in ("plain", "nxn", "rqt"):
                nxn, rqt = arm != "plain", arm == "rqt"
                costs, modes, ties = _tie_costs(
                    rng, by, bx, partition._decide_costs(qp), nxn, rqt)
                tc = [torch.as_tensor(c, device=dev) for c in costs]
                tm = [torch.as_tensor(m, device=dev) for m in modes]
                args = (tc[0] if nxn else None, *tc[1:4],
                        tc[4] if rqt else None, tc[5] if rqt else None,
                        tm[0] if nxn else None, *tm[1:])
                got = partition._decide(*args, qp)
                want = partition.decide_plain(*args, qp)
                for g, w_, nm in zip(got, want,
                                     ("depth8", "mode4", "tulog8")):
                    c5.add(g, w_, f"C5 decide {arm} {nm}, {bx}x{by} CTUs, "
                           f"QP {qp}, exact ties")
                hist = torch.bincount(got[0].flatten(), minlength=4)
                log(f"C5 decide {arm} {bx}x{by} CTUs QP {qp}: ties "
                    f"{json.dumps(ties)}, depth8 histogram {hist.tolist()}")
    torch.cuda.synchronize()
    log("C1 and C5's decide entry on their edge cases: " + ", ".join(
        f"{k} {checks[k].cases} cases {checks[k].mism} mismatches"
        for k in ("C1", "C5")))


def _counters():
    """(name, module, attribute) of every kernel's launch count; the
    kernels of csrc/tq.cu (encode, its RDOQ arm, decode), csrc/partition.cu,
    csrc/sao.cu, csrc/interp.cu (luma, chroma), csrc/ss_search.cu (scan,
    and among its launches those with the GT ring and those with the
    temporal search; pre-pass, and among them those with the temporal
    arm), csrc/inter_arms.cu (arms, motion, and among each the PSS form),
    csrc/warp.cu (window, luma, chroma) and csrc/gt_search.cu (search,
    decide, and among the latter the PSS form) count apart; C2's analysis
    entry (parallel/mesh.py) counts apart from its other launches; C13's
    two entries (csrc/scan.cu) and C14's (csrc/ss_scan.cu), its ISS and
    PSS forms, count apart."""
    from hevc_hop_torch.models import (partition, ss_partition, ss_scan,
                                       wavefront_scan)
    from hevc_hop_torch.ops import (deblock, gt, hashes, inter_arms, interp,
                                    intra, rdoq, sao, ss_search, tq, warp)
    from hevc_hop_torch.parallel import mesh
    return [("C1", hashes, "LAUNCHES"), ("C2", intra, "LAUNCHES"),
            ("C2 analysis", mesh, "LAUNCHES"),
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
            ("C12 decide PSS", gt, "PSS_DECIDE_LAUNCHES"),
            ("C13 encode", wavefront_scan, "SCAN_ENCODE_LAUNCHES"),
            ("C13 decode", wavefront_scan, "SCAN_DECODE_LAUNCHES"),
            ("C14 encode", ss_scan, "SCAN_ISS_ENCODE_LAUNCHES"),
            ("C14 decode", ss_scan, "SCAN_ISS_DECODE_LAUNCHES"),
            ("C14 PSS encode", ss_scan, "SCAN_PSS_ENCODE_LAUNCHES"),
            ("C14 PSS decode", ss_scan, "SCAN_PSS_DECODE_LAUNCHES")]


def require_loopfilter_launches(launches, pictures, cfg, what):
    """One C4 launch a picture each way (encode and decode), one C6
    statistics launch a picture's SAO encode, one C6 apply launch a
    picture each way."""
    want = {"C4": 2 * pictures * bool(cfg.deblocking),
            "C6 stats": pictures * bool(cfg.sao),
            "C6 apply": 2 * pictures * bool(cfg.sao)}
    got = {k: launches[k] for k in want}
    require(got == want, f"{what}: the loop filters' launches {got}, not "
            f"{want}")


PATHS = {
    # bench.py's production configuration: RDOQ (C7's device code, in
    # C13) on every TU
    "production": (dict(sao=True), TIMED_FRAMES,
                   ("C1", "C13 encode", "C13 decode", "C3 decode", "C4",
                    "C5 rd", "C5 decide", "C6 stats", "C6 apply")),
    # the same with RDOQ off
    "quadtree": (dict(sao=True, rdoq=False), QUADTREE_TIMED_FRAMES,
                 ("C1", "C13 encode", "C13 decode", "C3 decode", "C4",
                  "C5 rd", "C5 decide", "C6 stats", "C6 apply")),
    "uniform": (dict(cu_log2=4, rdoq=False), UNIFORM_TIMED_FRAMES,
                ("C1", "C13 encode", "C13 decode", "C3 decode", "C4")),
}
# the level loop's per-level launches, which C13 replaces on the
# single-device intra paths
LOOP_KERNELS = ("C2", "C3 encode", "C3 encode (RDOQ)")


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


def phase_main_path(name, checks):
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
    with holding_residual(checks["C3"], f"the {name} path") as held:
        stream, e_s, d_s = _roundtrip(enc, frame, name)
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"{name} path launches: {launches}")
    require(all(launches[k] > 0 for k in needed),
            f"a kernel was not launched on the {name} path: {launches}")
    require(launches["C13 encode"] == 1 and launches["C13 decode"] == 1,
            f"the {name} frame did not launch C13 once each way: {launches}")
    require(launches["C3 decode"] == 1 and len(held) == 1,
            f"the {name} frame's residual was not one C3 decode launch, "
            f"held: {launches}, {held}")
    require(all(launches[k] == 0 for k in LOOP_KERNELS),
            f"the {name} path launched the level loop's kernels: "
            f"{launches}")
    require_loopfilter_launches(launches, 1, enc.cfg, f"the {name} path")
    y = frame[0]
    mse = np.mean((enc.recon_yuv[0].astype(np.float64) - y) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    require(psnr > 25, f"Y-PSNR {psnr:.2f} dB")

    # timed: more frames each way, one after another (the first frame
    # built the schedule and loaded the kernels)
    enc_s, dec_s, probes, dec_stats = [], [], [], {}
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
        dec_stats = dict(dec2.last_stats)
    stats = dict(enc.last_stats)
    sched = next(reversed(wavefront_scan._SCHEDULES.values()))
    # K6's floor: the bound of the frame's scan work, whole (C13's) and
    # summed over the level loop's launches
    extra_out = {"scan_bound_ms": scan_bound(
                     sched.plans, enc.cfg.rdoq, name == "uniform")[0],
                 "level_loop_bound_ms": level_loop_bound(
                     sched.plans, enc.cfg.rdoq, name == "uniform")}
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
           "last_stats": stats, "decode_last_stats": dec_stats,
           "launches": launches, **extra_out}
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


def _scan_inputs(enc, frame):
    """The wavefront's inputs as IntraEncoder._stage1 builds them on the
    card: (scan_encode's positional arguments, its keywords, the
    schedule)."""
    import torch
    from hevc_hop_torch.common import rom
    cfg = enc.cfg
    pad = 1 << cfg.ctb_log2
    hc, hc_off = H // 2, H // 2 + pad
    dev = torch.device("cuda")
    up = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    org_y = torch.zeros((H + pad, W), dtype=torch.int32, device=dev)
    org_y[:H] = up(frame[0])
    org_c = torch.zeros((2 * hc_off, W // 2), dtype=torch.int32, device=dev)
    org_c[:hc] = up(frame[1])
    org_c[hc_off:hc_off + hc] = up(frame[2])
    depth8, mode4, tulog8 = enc._decide(org_y[:H], None)
    sched = enc._schedule(depth8, tulog8)
    modes = None if mode4 is None else enc._given_modes(sched, mode4)
    args = (org_y, org_c, sched.plans, sched.nsteps, cfg.qp,
            rom.chroma_qp_from_luma(cfg.qp), cfg.bit_depth,
            cfg.strong_intra_smoothing, cfg.sbh, modes)
    return args, dict(use_rdoq=cfg.rdoq, init_type=2), sched


def _scan_decode_inputs(args, sched, encoded):
    """The decoder's inputs to scan_decode for an encode's output: the
    dense residual of its levels (kernel C3's decode entry, as
    models/decoder.py builds it), its luma modes and its chroma modes."""
    import torch
    from hevc_hop_torch.ops import tq
    org_y, org_c, plans = args[:3]
    qp, qp_c, bd, modes = args[4], args[5], args[6], args[9]
    _, _, coef_y, coef_c, outs = encoded
    hc, hc_off = H // 2, org_c.shape[0] // 2
    resi_y, resi_c = torch.zeros_like(org_y), torch.zeros_like(org_c)
    luma_pos, chroma_pos = sched.tu_pos
    for log2, pos in sorted(luma_pos.items()):
        tq.tq_decode(coef_y[:H], pos, 1 << log2, qp, bd, log2 == 2,
                     resi_y[:H])
    for lo in (0, hc_off):
        for log2, pos in sorted(chroma_pos.items()):
            tq.tq_decode(coef_c[lo:lo + hc], pos, 1 << log2, qp_c, bd,
                         False, resi_c[lo:lo + hc])
    luma, chroma = {}, {}
    for log2, p in plans.items():
        luma[log2] = outs[log2][0]
        given = modes[log2][1] if modes is not None else None
        chroma[log2] = (given if given is not None else luma[log2][
            torch.as_tensor(p.cidx, dtype=torch.long,
                            device=org_y.device)].contiguous())
    return resi_y, resi_c, luma, chroma


def _hold_scan(chk, got, want, what):
    """Two scan_encode results, plane by plane and output by output."""
    for a, b, nm in zip(got[:4], want[:4], ("ry", "rc", "coef_y",
                                            "coef_c")):
        chk.add(a, b, f"{what}: {nm}")
    require(set(got[4]) == set(want[4]), f"{what}: sizes")
    for log2 in want[4]:
        for a, b, nm in zip(got[4][log2], want[4][log2],
                            ("best", "cbf_y", "cbf_c")):
            chk.add(a, b, f"{what}: {nm} {1 << log2}x{1 << log2}")


# the pipelined encode's frames: bench.py's four distinct class-B frames
FRAMES_SEEDS = (0, 1, 2, 3)
FRAMES_TURNS = 3


def phase_encode_frames():
    """IntraEncoder.encode_frames, the two-stage pipeline, on the
    production configuration over synth_class_b seeds FRAMES_SEEDS. Every
    launch count is set to 0 just before one pipelined run and read just
    after: C5, C13, C4, C6 and C1 launched for every frame, no per-level C2
    or C3 launch. The run's streams must equal those of encode_frame calls
    on a fresh encoder byte for byte (each decoded with hash_ok, the last
    to recon_yuv); torch.cuda.synchronize must never be called inside
    _stage1; and for every frame i but the last, when its host SAO
    decision ends, the event that _stage1 recorded behind frame i+1's C13
    launch (its loop-filter mark) must read complete. Then FRAMES_TURNS
    turns of both forms, encode s a frame; returns the record."""
    import torch
    from hevc_hop_torch.models import wavefront_scan
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_torch.ops import hashes, sao
    frames = [synth_class_b(W, H, seed=s) for s in FRAMES_SEEDS]
    cfg = EncoderConfig(width=W, height=H, qp=QP, **PATHS["production"][0])
    single = IntraEncoder(cfg)
    want = [single.encode_frame(*f) for f in frames]
    for i, stream in enumerate(want):
        dec = Decoder()
        (pic,) = dec.decode_stream(stream)
        require(dec.hash_ok == [True], f"encode_frames: frame {i}'s "
                "encode_frame stream does not decode with hash_ok")
    enc = IntraEncoder(cfg)
    staged, stage_stats, seen, in_stage1, syncs = [], [], [], [False], [0]
    stage1, stage2 = enc._stage1, enc._stage2
    sync, choose, digests = (torch.cuda.synchronize, sao.choose_sao_params,
                             hashes.checksum_digests)
    # per frame: events just before and after its C13 launch, and the
    # host's clock just after it
    launch, c13 = wavefront_scan._launch, []

    def spy1(*a, **k):
        in_stage1[0] = True
        try:
            st = stage1(*a, **k)
        finally:
            in_stage1[0] = False
        staged.append(st)
        return st

    def spy2(st):
        out = stage2(st)
        stage_stats.append(dict(enc.last_stats))
        return out

    def counted(*a, **k):
        syncs[0] += in_stage1[0]
        return sync(*a, **k)

    def after_scan(i):
        """Whether frame i's event behind its C13 launch reads complete
        (None where there is no frame i)."""
        if i >= len(staged):
            return None
        return dict(staged[i]["clock"].marks)["loopfilter_s"].query()

    def timed_launch(entry, *a, **k):
        if entry != "hh_scan_encode":
            return launch(entry, *a, **k)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        launch(entry, *a, **k)
        e1.record()
        c13.append((e0, e1, time.perf_counter()))

    def decision(*a, **k):
        i = len(seen)
        t0, before = time.perf_counter(), after_scan(i + 1)
        out = choose(*a, **k)
        t1 = time.perf_counter()
        seen.append({"frame": i, "next_c13_done_at_start": before,
                     "next_c13_done_at_end": after_scan(i + 1),
                     "decision_ms": (t1 - t0) * 1e3,
                     "next_c13_launch_to_decision_ms":
                         (t0 - c13[i + 1][2]) * 1e3 if i + 1 < len(c13)
                         else None})
        return out

    def checksum(*a, **k):
        i = len(seen) - 1
        nxt = staged[i + 1]["ready"].query() if i + 1 < len(staged) else None
        seen[i]["next_frame_done_at_checksum"] = nxt
        return digests(*a, **k)

    counters = _counters()
    enc._stage1, enc._stage2 = spy1, spy2
    torch.cuda.synchronize = counted
    sao.choose_sao_params, hashes.checksum_digests = decision, checksum
    wavefront_scan._launch = timed_launch
    try:
        torch.cuda.synchronize()
        for _, m, attr in counters:
            setattr(m, attr, 0)
        got = enc.encode_frames(frames)
        launches = {k: getattr(m, attr) for k, m, attr in counters}
    finally:
        del enc._stage1, enc._stage2
        torch.cuda.synchronize = sync
        sao.choose_sao_params, hashes.checksum_digests = choose, digests
        wavefront_scan._launch = launch
    n = len(frames)
    for r, (e0, e1, _) in zip(seen, c13):
        r["c13_ms"] = e0.elapsed_time(e1)
    log(f"encode_frames launches: {launches}")
    for k in ("C13 encode", "C5 decide", "C4", "C6 stats", "C6 apply",
              "C1"):
        require(launches[k] == n, f"encode_frames: {k} launched "
                f"{launches[k]} times for {n} frames: {launches}")
    require(launches["C5 rd"] >= n and launches["C13 decode"] == 0
            and all(launches[k] == 0 for k in LOOP_KERNELS),
            f"encode_frames: launches {launches}")
    require(got == want, "encode_frames: the streams differ from "
            "encode_frame's: " + str([a == b for a, b in zip(got, want)]))
    for a, b, nm in zip(pic, enc.recon_yuv, ("y", "cb", "cr")):
        require(np.array_equal(a, b), f"encode_frames: recon_yuv {nm} is "
                "not the last frame's decoded picture")
    require(len(staged) == n and syncs[0] == 0,
            f"encode_frames: {syncs[0]} torch.cuda.synchronize calls inside "
            f"_stage1 over {len(staged)} frames")
    log(f"encode_frames overlap: {json.dumps(seen)}")
    require(len(seen) == n and all(r["next_c13_done_at_end"]
                                   for r in seen[:-1]),
            "encode_frames: a frame's SAO decision ended before the next "
            f"frame's C13 had run: {seen}")
    # turns of both forms on one encoder, encode s a frame
    times = {"encode_frames": [], "encode_frame": []}
    for turn in range(FRAMES_TURNS):
        order = ("encode_frames", "encode_frame")
        for form in (order if turn % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (enc.encode_frames(frames) if form == "encode_frames"
                   else [enc.encode_frame(*f) for f in frames])
            torch.cuda.synchronize()
            times[form].append((time.perf_counter() - t0) / n)
            require(out == want, f"encode_frames: a {form} turn differs")
    keys = ("upload_s", "decide_s", "scan_s", "loopfilter_s", "fetch_s",
            "sao_s", "maps_s", "entropy_s", "checksum_s", "total_s")
    med = {form: float(np.median(v)) for form, v in times.items()}
    rec = {"frames": n, "seeds": list(FRAMES_SEEDS), "bytes": [len(s)
                                                             for s in got],
           "launches": launches, "stage1_syncs": syncs[0], "overlap": seen,
           "encode_s_per_frame": med, "turns": times,
           "pipelined_last_stats": [{k: st[k] for k in keys}
                                    for st in stage_stats]}
    log(f"encode_frames: encode s a frame, medians of {FRAMES_TURNS} turns: "
        f"encode_frames {med['encode_frames']:.4f}, encode_frame "
        f"{med['encode_frame']:.4f}")
    log(f"encode_frames record: {json.dumps(rec)}")
    return rec


def phase_scan_program(ctxs, checks):
    """Kernel C13 on each intra path's frame (and the production path's
    noisy frame, whose partition goes down to 4x4): its encode entry
    against the level loop of C2 and C3 launches and the level loop of
    their plain versions, on the card; its decode entry, on the dense
    residual of the encode's own levels, against both decode loops and
    against the encode's recon. Returns (a record per frame, the inputs of
    each path's main frame for its kernel rows)."""
    import torch
    from hevc_hop_torch.models import wavefront_scan as ws
    chk = checks["C13"]
    out, rows = [], {}
    for name in PATHS:
        enc = ctxs[name]["enc"]
        frames = [("main", ctxs[name]["frame"])]
        if name == "production":
            frames.append(("noisy", synth_class_b(W, H, **NOISY)))
        for what, frame in frames:
            args, kws, sched = _scan_inputs(enc, frame)
            work = sched.work
            enc_runs = {
                "C13": lambda: ws.scan_encode(*args, **kws, work=work),
                "loop": lambda: ws.scan_encode_loop(*args, **kws),
                "plain": lambda: ws.scan_encode_loop(*args, **kws,
                                                     plain=True)}
            res, secs = {}, {}
            for route, fn in enc_runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[route] = fn()
                torch.cuda.synchronize()
                secs[f"encode_{route}_s"] = time.perf_counter() - t0
                if route == "C13":
                    grid = ws.LAST_LAUNCH
            for other in ("loop", "plain"):
                _hold_scan(chk, res["C13"], res[other],
                           f"C13 encode, {name} {what} frame, against the "
                           f"{other}")
            dec_in = _scan_decode_inputs(args, sched, res["C13"])
            dargs = (*dec_in[:2], sched.plans, sched.nsteps, *dec_in[2:],
                     args[6], args[7])
            dec_runs = {
                "C13": lambda: ws.scan_decode(*dargs, work=work),
                "loop": lambda: ws.scan_decode_loop(*dargs),
                "plain": lambda: ws.scan_decode_loop(*dargs, plain=True)}
            dec = {}
            for route, fn in dec_runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dec[route] = fn()
                torch.cuda.synchronize()
                secs[f"decode_{route}_s"] = time.perf_counter() - t0
            for other in ("loop", "plain"):
                for a, b, nm in zip(dec["C13"], dec[other], ("ry", "rc")):
                    chk.add(a, b, f"C13 decode, {name} {what} frame, "
                            f"against the {other}: {nm}")
            for a, b, nm in zip(dec["C13"], res["C13"][:2], ("ry", "rc")):
                chk.add(a, b, f"C13 decode, {name} {what} frame, against "
                        f"the encode's recon: {nm}")
            rec = {"path": name, "frame": what,
                   "blocks": len(work.host_items),
                   "levels": len(work.host_off) - 1,
                   "widest_level": work.widest,
                   "grid_ctas_per_sm_smem_threads_cluster": grid,
                   **secs}
            log(f"scan program: {json.dumps(rec)}")
            out.append(rec)
            if what == "main":
                rows[name] = dict(args=args, kws=kws, sched=sched,
                                  dargs=dargs, secs=secs)
    log(f"scan program: C13 held in {chk.cases} comparisons, "
        f"{chk.mism} mismatching elements")
    return out, rows


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
    operations, or (int32, float32) or (int32, float32, int8) operations:
    the CUDA cores run the first two at 33.5 and 67 T/s, the tensor cores
    int8 at 1979 T/s, and the floor is the largest of the times."""
    ops = ops if isinstance(ops, tuple) else (ops,)
    to = max(o / p for o, p in zip(
        ops, (PEAK_INT32_OPS, PEAK_FP32_OPS, PEAK_INT8_OPS))) * 1e3
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


def residual_picture_case(sc, maps):
    """The inputs of C3's decode entry over an 8-bit I frame at QP, as the
    decoder builds them from its parsed maps and the schedule sc: (planes
    of tq_decode_picture for "kernel" and "plain", each with outputs of
    its own, those outputs, classes, TUs, operations). The operations are
    what these levels need: each TU's dequantiser, and the inverse
    transform of each TU that holds a level."""
    import torch
    from hevc_hop_torch.common import rom
    dev = torch.device("cuda")
    cp = torch.as_tensor(maps.coef).to(dev)
    ny, nc = maps.coef_y.size, maps.coef_cb.size
    qpc = rom.chroma_qp_from_luma(QP)
    host = (maps.coef_y, maps.coef_cb, maps.coef_cr)
    lev = [cp[:ny].view(H, W), cp[ny:ny + nc].view(H // 2, W // 2),
           cp[ny + nc:].view(H // 2, W // 2)]
    luma_pos, chroma_pos = sc.tu_pos
    classes = [(0, lg, p) for lg, p in luma_pos.items()] + [
        (c, lg, p) for c in (1, 2) for lg, p in chroma_pos.items()]
    outs = {k: [torch.zeros(tuple(lv.shape), dtype=torch.int32, device=dev)
                for lv in lev] for k in ("kernel", "plain")}
    planes = {k: [(lv, o, q, i == 0) for i, (lv, o, q) in enumerate(
        zip(lev, outs[k], (QP, qpc, qpc)))] for k in outs}
    ops = tus = 0
    for pi, lg, pos in classes:
        n = 1 << lg
        coded = sum(bool(host[pi][y:y + n, x:x + n].any())
                    for x, y in pos.cpu().numpy())
        ops += pos.shape[0] * 5 * n * n + coded * transform_ops(n, True)
        tus += pos.shape[0]
    return planes, outs, classes, tus, ops


def phase_timing(ctxs, ps, checks, launches, scan_rows):
    """First every launch form of both main paths is held against its
    plain version at the path's own shapes. Then each kernel, at the
    largest launch a main path gives it (C2 and C3 encode: the fullest
    wavefront level of the uniform path, 16x16 with RMD, and of the
    quadtree path, 32x32 with given modes; C3 decode, C4, C1, C5 and C6:
    the whole frame; C13: the whole frame), is held again and timed beside
    its plain version. On these paths C2's, C3's and C7's device code runs
    inside C13, so their rows count C13's launches. ``ps`` holds
    phase_partition_sao's inputs, ``scan_rows`` phase_scan_program's."""
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
             nbytes, ops, **more):
        specs.append(dict(name=name, counter=counter, path=path,
                          kernel=kernel, shape=shape, source=source,
                          replaces=replaces, fn=fn, plain=plain,
                          nbytes=nbytes, ops=ops, **more))

    # C2's, C3's and C7's device code on the intra paths runs in C13
    in_c13 = dict(launched_in="C13 encode", frame_kernel="scan_encode_kernel")

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
             c * c2bytes, c * c2ops, **in_c13)

        def tq_enc(fn, k):
            rec, cp, _ = bufs[k]
            return fn(org, pred, pos, best, n, 0, QP, 8, True, None, rec,
                      cp), rec, cp

        spec(f"C3 tq (encode, {n}x{n})", "C3 encode", path,
             "tq_encode_kernel", f"{c} luma blocks of {n}x{n}, encode entry",
             "hevc_hop_torch/csrc/tq.cu", "hevc_hop_tpu/ops/quant.py:54",
             lambda: tq_enc(tq.tq_encode, "kernel"),
             lambda: tq_enc(tq.tq_encode_plain, "plain"),
             c * (n * n * (4 + 4 + 4 + 2) + 16), c * tq_encode_ops(n),
             **in_c13)

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
             (c * (tq_encode_ops(n) - 7 * n * n + ri), c * rf), **in_c13)
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
             c * (n * n * (4 + 4) + 4), (c * ri, c * rf), **in_c13)

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

    def picture_row(path, sc, maps):
        """C3's decode entry as the decoder launches it: every TU of the
        frame's three planes in one launch, on its own parsed levels."""
        planes, outs, classes, tus, ops = residual_picture_case(sc, maps)
        spec("C3 tq (decode, a picture)", "C3 decode", path,
             "tq_decode_kernel",
             f"the {path} frame's {tus} TUs of three planes in "
             f"{len(classes)} classes, one launch",
             "hevc_hop_torch/csrc/tq.cu", "hevc_hop_tpu/models/decoder.py:45",
             lambda: (tq.tq_decode_picture(planes["kernel"], classes, 8),
                      *outs["kernel"])[1:],
             lambda: (tq.tq_decode_picture_plain(planes["plain"], classes,
                                                 8), *outs["plain"])[1:],
             3 * H * W // 2 * (2 + 4) + 8 * tus, ops)

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
    picture_row("quadtree", qsched, qmaps)

    # C13, whole frames: the production frame each way, the uniform one's
    # encode (its in-loop RMD)
    from hevc_hop_torch.models import wavefront_scan as ws
    for path, side in (("production", "encode"), ("uniform", "encode"),
                       ("production", "decode")):
        r = scan_rows[path]
        sc, cfg = r["sched"], ctxs[path]["enc"].cfg
        work = sc.work
        if side == "encode":
            fn = (lambda a=r["args"], k=r["kws"], w_=work:
                  ws.scan_encode(*a, **k, work=w_))
        else:
            fn = lambda a=r["dargs"], w_=work: ws.scan_decode(*a, work=w_)
        nb, ops = scan_work(sc.plans, cfg.rdoq, path == "uniform",
                            side == "decode")
        form = ("in-loop RMD" if path == "uniform" else "given modes, "
                + ("RDOQ" if cfg.rdoq else "dead-zone quantizer"))
        spec(f"C13 scan ({side}, {path} frame)", f"C13 {side}", path,
             f"scan_{side}_kernel",
             f"{W}x{H} frame, {len(work.host_items)} blocks in "
             f"{len(work.host_off) - 1} levels, one launch"
             + (f", {form}" if side == "encode" else ""),
             "hevc_hop_torch/csrc/scan.cu",
             "hevc_hop_tpu/models/wavefront_scan.py:"
             + ("217" if side == "encode" else "322"),
             fn, None, nb, ops, held=True,
             plain_ms=r["secs"][f"{side}_plain_s"] * 1e3,
             loop_ms=r["secs"][f"{side}_loop_s"] * 1e3)

    npx = H * W * 3 // 2
    # one read and one write of the three planes, one read of tu4
    spec("C4 deblock", "C4", "uniform", "deblock_kernel",
         f"{W}x{H} picture, three planes, one launch",
         "hevc_hop_torch/csrc/deblock.cu",
         "hevc_hop_tpu/ops/deblock.py:166",
         lambda: deblock.deblock_frame(ry, rcb, rcr, tu4, QP, 31),
         lambda: deblock.deblock_frame_plain(ry, rcb, rcr, tu4, QP, 31),
         2 * 4 * npx + tu4.numel(), 2 * 40 * npx // 4)
    spec("C1 checksum", "C1", "uniform", "checksum_kernel",
         f"{W}x{H} frame, three planes", "hevc_hop_torch/csrc/checksum.cu",
         "hevc_hop_tpu/ops/hashes.py:18",
         lambda: hashes.plane_checksums([ry, rcb, rcr]),
         lambda: [hashes._checksum_plain(q, 8) for q in (ry, rcb, rcr)],
         4 * npx + 12, 10 * npx, every=True, flushed=True)
    # C5 and C6 on the whole frame (inputs of phase_partition_sao, 8 bit)
    yq, kern = ps["y"], ps["kern"]
    orgs = tuple(o for o, _, _, _ in ps["planes"])
    pres = tuple(p for _, p, _, _ in ps["planes"])
    type3, off, band = ps["type3"], ps["off"], ps["band"]
    params = torch.as_tensor(np.concatenate(
        [type3[..., None], band[..., None], off], -1), dtype=torch.int32,
        device=dev)
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
         4 * grids + 4 * (2 * (H // 8) * (W // 8) + nb4), 400 * ctus,
         every=True)
    # the statistics read org and pre once and write 3 x 96 counters a
    # CTU position; the apply reads pre and the packed parameters once and
    # writes the three planes
    spec("C6 sao (stats)", "C6 stats", "quadtree", "sao_stats_kernel",
         f"{W}x{H} picture, three planes, 32x32 CTUs, one launch",
         "hevc_hop_torch/csrc/sao.cu", "hevc_hop_tpu/ops/sao.py:100",
         lambda: sao.stats_dispatch(orgs, pres, 5, 8).packed,
         lambda: sao.sao_stats_frame_plain(orgs, pres, 5, 8),
         2 * 4 * npx + 3 * 96 * 4 * ctus, 60 * npx)
    spec("C6 sao (apply)", "C6 apply", "quadtree", "sao_apply_kernel",
         f"{W}x{H} picture, three planes, 32x32 CTUs, the RDO's maps, "
         "one launch", "hevc_hop_torch/csrc/sao.cu",
         "hevc_hop_tpu/ops/sao.py:58",
         lambda: sao.apply_sao_frame(*pres, type3, off, band, 5, 8),
         lambda: sao.apply_sao_frame_plain(pres, params, 5, 8),
         2 * 4 * npx + 3 * 6 * 4 * ctus, 20 * npx)
    return _time_specs(specs, checks, launches)


def _traced_ms(fn, kernel, name, every=False):
    """(device ms per call of fn's launches of ``kernel``, traces taken,
    device records per call, the kernel's own ms per call): a call of
    small launches is bound by the host, so its host time is mostly
    Python. With ``every`` the ms count every device record of the call
    (fills, copies), not only the kernel's. A trace now and then lacks some of the launches' records, so
    one counts only if it holds them all."""
    inner, ms, traces, records, own = 10, None, 0, None, None
    while ms is None and traces < 6:
        traces += 1
        prof = _profile(lambda: [fn() for _ in range(inner)])
        count = prof["kernel_calls"][kernel]
        if count and count == count // inner * inner:
            own = prof["kernel_ms"][kernel] / inner
            ms = prof["device_busy_ms"] / inner if every else own
            records = prof["device_records"] / inner
        else:
            log(f"{name}: trace {traces} holds {count} records of "
                f"{kernel} for {inner} calls; traced again")
    require(ms is not None and ms > 0,
            f"no complete trace of {kernel} in {traces} tries")
    return ms, traces, records, own


def _flushed_ms(fn, kernel, inner=10):
    """The device ms of fn's launches of ``kernel`` with the 50 MB L2
    flushed before each call (256 MB written between calls), from a
    profiler trace after a warm-up one."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def run():
        for _ in range(inner):
            flush.fill_(0)
            fn()
    _profile(run)
    prof = _profile(run)
    require(prof["kernel_calls"][kernel] >= inner,
            f"the flushed trace holds {prof['kernel_calls'][kernel]} "
            f"records of {kernel} for {inner} calls")
    return prof["kernel_ms"][kernel] / prof["kernel_calls"][kernel]


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
        # a held spec was held against its plain version by its own phase
        got, want = (((), ()) if sp.get("held") else (fn(), plain()))
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
                           "C14 encode", "C14 PSS encode",
                           "C10 arms", "C12 search", "C12 decide",
                           "C9 temporal", "C9 prepass temporal",
                           "C10 arms PSS", "C12 decide PSS")
        call_ms = time_ms(fn, reps=3 if slow else 7, inner=3 if slow else 10)
        pms = (sp["plain_ms"] if "plain_ms" in sp else
               time_ms(plain, reps=1 if slow else 5, inner=1))
        ms, traces, records, own = _traced_ms(fn, sp["kernel"], name,
                                              sp.get("every", False))
        b_ms, by = bound(sp["nbytes"], sp["ops"])
        # on the main paths C7's device code (rdoq_block) runs inside C3's
        # RDOQ arm, or inside C13, and C2's and C3's inside C13 on the
        # intra paths: their launches there are that kernel's; only these
        # comparisons launch the entries themselves
        launched = sp.get("launched_in", "C3 encode (RDOQ)" if counter == "C7"
                          else counter)
        fused = {}
        if launched != counter:
            fused = {"launched_in": launched,
                     "frame_kernel": sp.get("frame_kernel",
                                            "tq_encode_rdoq_kernel"),
                     "standalone_launches_by_path": {
                         k: v[counter] for k, v in launches.items()}}
        if "loop_ms" in sp:
            fused["level_loop_ms"] = sp["loop_ms"]
        if sp.get("flushed"):
            fused["l2_flushed_ms"] = _flushed_ms(fn, sp["kernel"])
        if "float_ops" in sp:
            fb_ms, fby = bound(sp["nbytes"], sp["float_ops"])
            fused["float_form_bound_ms"] = fb_ms
            fused["float_form_bound_by"] = fby
        if "wide" in sp:
            wd = sp["wide"]
            wb_ms, wby = bound(sp["nbytes"] * wd["times"],
                               tuple(o * wd["times"] for o in sp["ops"]))
            fused["at_more_cus"] = {
                "cus": wd["cus"],
                "ms": _traced_ms(wd["fn"], sp["kernel"], name)[0],
                "library_ms": time_ms(wd["library"]), "bound_ms": wb_ms,
                "bound_by": wby}
        rows.append({"name": name, "route": "cuda", "source": sp["source"],
                     "replaces": sp["replaces"], "path": sp["path"],
                     "kernel": sp["kernel"],
                     "launches": launches[sp["path"]][launched],
                     "launches_by_path": {k: v[launched]
                                          for k, v in launches.items()},
                     "max_abs_err": check.err, "mismatches": check.mism,
                     "ms": ms, "kernel_ms": own, "call_ms": call_ms,
                     "profile_traces": traces,
                     "device_records_per_call": records,
                     "ms_counts_every_record": sp.get("every", False),
                     "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": (time_ms(sp["library"])
                                    if sp.get("library") else None),
                     "library_call": sp.get("library_call"),
                     "shape": sp["shape"], **fused})
    return rows


# ---------------------------------------------------------------------------
# The lenslet ISS slice: kernels C8, C9, C10, C11, C12 and C4's inter arm;
# an ISS picture's wavefront as one launch of kernel C14 each way.

# bench.py:88-100's lenslet cell at 1920x1088 with the GT warp off
ISS_CONFIG = dict(qp=QP, mi_size=16, search_range=32, quadtree=True,
                  sao=True, rdoq=True, sbh=True, gt=False)
ISS_TIMED_FRAMES = 3
# an ISS picture: C14 each way (C2's, C3's, C7's, C8's, C9's, C10's, C11's
# and C12's device code), C3's decode entry, C4, C1
_ISS_KERNELS = ("C1", "C3 decode", "C4", "C14 encode", "C14 decode")
# the level loop's per-level launches, which C14 replaces on an ISS picture
# and, in its PSS form, on a PSS one (the PSS forms of C9, C10 and C12
# count among these too)
ISS_LOOP_KERNELS = ("C2", "C3 encode", "C3 encode (RDOQ)", "C8 luma",
                    "C8 chroma", "C9 search", "C9 ring", "C10 arms",
                    "C10 motion", "C11 luma", "C11 chroma", "C12 search",
                    "C12 decide")
_PREPASS_KERNELS = ("C5 rd", "C5 decide", "C6 stats", "C6 apply",
                    "C9 prepass")
# a PSS picture: C14's PSS form each way (C9's temporal search, C10's and
# C12's PSS forms, C8 from the previous picture inside it) and the
# pre-pass's temporal arm
_PSS_KERNELS = ("C14 PSS encode", "C14 PSS decode", "C9 prepass temporal")
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
               _ISS_KERNELS + _PREPASS_KERNELS, "lenslet"),
    # tests/test_e2e_iss.py's GT configuration (test_gt_roundtrip_and_
    # engages: 16x16 CUs, QP 37, SAO off) at full size on its warped
    # lenslet content, where the GT arm wins 24 times the area
    "iss-gt-warped": (dict(qp=37, cu_log2=4, search_range=32, mi_size=16,
                           gt=True), 2, _ISS_KERNELS, "warped"),
    # bench.py:88-100's lenslet cell whole on a low-delay holoscopic
    # sequence (HoloEncoder.encode_sequence: an ISS picture, then PSS ones
    # whose L0 is [the previous picture, the SS reference]): a plenoptic
    # video camera panning one sample per frame (pss_frames)
    "pss-gt": (dict(ISS_CONFIG, gt=True, search_range_t=16),
               PSS_TIMED_TURNS,
               _ISS_KERNELS + _PREPASS_KERNELS + _PSS_KERNELS,
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
                # the same into another plane where a mask selects (a PSS
                # picture's temporal blocks read the previous picture)
                gonly = t(rng.random(len(g)) < 0.5)
                dk, dp = plane.clone(), plane.clone()
                interp.mc_blocks(plane, gpos, gmv, n, chroma, h, bd, hc_off,
                                 resi=resi, only=gonly, dst=dk)
                interp.mc_blocks_plain(plane, gpos, gmv, n, chroma, h, bd,
                                       hc_off, resi=resi, only=gonly, dst=dp)
                c8.add(dk, dp, what + " masked decode epilogue, another "
                       "plane")
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
                c11.add(warp.gt_pred_blocks(plane, *args),
                        gt.gt_pred_blocks_plain(plane, *args),
                        what + " prediction")
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


def phase_iss_path(name, checks):
    """An ISS main path on the card: the launch counts of one encode and
    its decode (set to 0 just before, read just after; the picture's
    residual one C3 launch, held against its plain version), then the
    timed frames."""
    import torch
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    extra, timed, needed, content = ISS_PATHS[name]
    frame, content = path_frame(content)
    enc = HoloEncoder(HoloConfig(width=W, height=H, **extra))
    counters = _counters()
    for _, m, attr in counters:
        setattr(m, attr, 0)
    with holding_residual(checks["C3"], f"the {name} path") as held:
        stream, e_s, d_s = _roundtrip(enc, frame, name)
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"{name} path launches: {launches}")
    require(all(launches[k] > 0 for k in needed),
            f"a kernel was not launched on the {name} path: {launches}")
    require(launches["C14 encode"] == 1 and launches["C14 decode"] == 1,
            f"the {name} picture did not launch C14 once each way: "
            f"{launches}")
    require(launches["C3 decode"] == 1 and len(held) == 1,
            f"the {name} picture's residual was not one C3 decode launch, "
            f"held: {launches}, {held}")
    require(all(launches[k] == 0 for k in ISS_LOOP_KERNELS),
            f"the {name} picture launched the level loop's kernels: "
            f"{launches}")
    require_loopfilter_launches(launches, 1, enc.cfg, f"the {name} path")
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


def phase_pss_path(name, checks):
    """The PSS main path on the card: the launch counts of one
    encode_sequence of the PSS_FRAMES pictures and its decode (set to 0
    just before, read just after; each picture's residual one C3 launch,
    held against its plain version); every picture hash_ok and equal to the
    encoder's recon history; temporal prediction chosen; the ISS picture
    one C14 launch each way, each PSS picture one launch of C14's PSS form
    each way, and no launch of the level loop's kernels. Then the sequence
    coded PSS_TIMED_TURNS more times picture by picture, each PSS picture
    timed (host_probes beside it), and its decode timed; in the first
    turn each picture alone launches its C14 form once and none of the
    level loop's kernels."""
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
    with holding_residual(checks["C3"], f"the {name} path") as held:
        pics = dec.decode_stream(stream)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"{name} path launches: {launches}")
    require(all(launches[k] > 0 for k in needed),
            f"a kernel was not launched on the {name} path: {launches}")
    require(launches["C3 decode"] == PSS_FRAMES and len(held) == PSS_FRAMES,
            f"{name}: the pictures' residuals were not one C3 decode launch "
            f"each, held: {launches}, {held}")
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
    require(launches["C14 encode"] == 1 and launches["C14 decode"] == 1,
            f"{name}: the ISS picture did not launch C14 once each way: "
            f"{launches}")
    require(launches["C14 PSS encode"] == PSS_FRAMES - 1
            and launches["C14 PSS decode"] == PSS_FRAMES - 1,
            f"{name}: the PSS pictures did not launch C14's PSS form once "
            f"each way each: {launches}")
    require(all(launches[k] == 0 for k in ISS_LOOP_KERNELS),
            f"{name}: the sequence launched the level loop's kernels: "
            f"{launches}")
    require_loopfilter_launches(launches, PSS_FRAMES, enc.cfg,
                                f"the {name} path")
    for turn in range(turns):
        for _, m, attr in counters:
            setattr(m, attr, 0)
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out = [enc.encode_frame(*frames[0])]
        torch.cuda.synchronize()
        iss_s.append(time.perf_counter() - t0_)
        if turn == 0:
            # the ISS picture alone: one C14, no level loop
            alone = {k: getattr(m, attr) for k, m, attr in counters}
            require(alone["C14 encode"] == 1 and all(
                alone[k] == 0 for k in ISS_LOOP_KERNELS),
                f"{name}: the ISS picture's launches {alone}")
        for poc in range(1, PSS_FRAMES):
            probes.append(host_probes())
            for _, m, attr in counters:
                setattr(m, attr, 0)
            t0_ = time.perf_counter()
            out.append(enc._encode_pss(*frames[poc], poc))
            torch.cuda.synchronize()
            pss_s.append(time.perf_counter() - t0_)
            if turn == 0:
                # the PSS picture alone: one launch of C14's PSS form
                alone = {k: getattr(m, attr) for k, m, attr in counters}
                require(alone["C14 PSS encode"] == 1 and all(
                    alone[k] == 0 for k in ISS_LOOP_KERNELS),
                    f"{name}: PSS picture {poc}'s launches {alone}")
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


# kernel C14's comparison with the plain loop runs on this corner of each
# ISS path's frame (the plain loop takes seconds at this size on the card);
# at full size the plain loop holds C14 on PLAIN_FULL's encodes and
# decodes (the kernels line's plain times), the card's loop on all four
SS_PLAIN_W, SS_PLAIN_H = 256, 192
PLAIN_FULL = {"encode": "iss", "decode": "iss-gt-warped"}
SS_PATHS = ("iss", "iss-uniform", "iss-gt", "iss-gt-warped")
# Every CU of pss-gt's PSS pictures is temporal. C14's PSS form is also
# held on a two-picture sequence whose PSS picture holds temporal, SS, GT
# and intra CUs alike (tests/test_torch_pss_scan_program.py's gt-cu16-qp37
# case: iss-gt-warped's configuration with a temporal search radius of 4,
# its warped lenslet content panned MIXED_PAN samples a picture, here with
# chroma made from the luma so that a chroma prediction's source shows):
# at full size against the card's loop, and at MIXED_PLAIN's sizes against
# the card's loop and the plain loop
MIXED_CONFIG = dict(qp=37, cu_log2=4, search_range=32, search_range_t=4,
                    mi_size=16, gt=True)
MIXED_PAN = 8
MIXED_PLAIN = ((SS_PLAIN_W, SS_PLAIN_H), (512, 384))
MIXED_CONTENT = ("synth_warped_lenslet(w, h, 16, seed=5), cb = 64 + y/2, "
                 f"cr = 191 - y/2, panned {MIXED_PAN} samples, noise +-2")
SS_REF = 1     # a PSS picture's L0 = [previous picture, SS]


def mixed_frames(w, h):
    """The mixed sequence's two pictures: synth_warped_lenslet(w, h, 16)
    with chroma made from its luma (64 + y // 2 and 191 - y // 2 at the
    chroma sites), then it rolled by MIXED_PAN samples (the chroma by half
    as many); each luma plus default_rng(7) noise in [-2, 2], clipped."""
    y0, _, _ = synth_warped_lenslet(w, h, 16, seed=5)
    cb0 = (64 + y0[::2, ::2] // 2).astype(np.int32)
    cr0 = (191 - y0[::2, ::2] // 2).astype(np.int32)
    rng = np.random.default_rng(7)
    frames = []
    for t in range(2):
        y = np.roll(y0, t * MIXED_PAN, axis=1) + rng.integers(-2, 3, (h, w))
        frames.append((y.clip(0, 255).astype(np.int32),
                       np.roll(cb0, t * MIXED_PAN // 2, axis=1),
                       np.roll(cr0, t * MIXED_PAN // 2, axis=1)))
    return frames


def _cu_kinds(outs):
    """The count of each kind of CU among a PSS picture's per-CU outputs
    (scan_encode_pss's outs): temporal (inter, reference index 0), SS
    (inter, the SS index), GT and intra."""
    k = dict(temporal_cus=0, ss_cus=0, gt_cus=0, intra_cus=0)
    for o in outs.values():
        inter, gt = o[0] != 0, o[7] != 0
        k["temporal_cus"] += int((inter & (o[1] == 0) & ~gt).sum())
        k["ss_cus"] += int((inter & (o[1] == SS_REF) & ~gt).sum())
        k["gt_cus"] += int(gt.sum())
        k["intra_cus"] += int((~inter & ~gt).sum())
    return k


def _ss_scan_inputs(enc, frame):
    """The ISS scan's inputs as HoloEncoder._encode_picture builds them on
    the card: (scan_encode_iss's positional arguments, the work list)."""
    from hevc_hop_torch.common import rom
    cfg = enc.cfg
    org_y, org_c = enc._upload(*frame)
    (plans, nsteps, zmaxw, zmax2n, work), mode4 = enc._frame_prep(
        org_y[:cfg.height])
    modes = None if mode4 is None else enc._xs_with_modes(plans, mode4)
    return (org_y, org_c, plans, nsteps, zmaxw, cfg.qp,
            rom.chroma_qp_from_luma(cfg.qp), cfg.bit_depth,
            cfg.strong_intra_smoothing, cfg.width, cfg.height,
            cfg.search_range, cfg.mi_size, cfg.rdoq, cfg.sbh, modes,
            zmax2n), work


def _ss_decode_inputs(stream):
    """The decoder's own call of scan_decode_ss on a one-picture stream:
    (its arguments, its work list)."""
    from hevc_hop_torch.models import ss_scan
    from hevc_hop_torch.models.decoder import Decoder
    seen = {}
    orig = ss_scan.scan_decode_ss

    def record(*a, work):
        seen["args"], seen["work"] = a, work
        return orig(*a, work=work)

    ss_scan.scan_decode_ss = record
    try:
        dec = Decoder()
        dec.decode_stream(stream)
    finally:
        ss_scan.scan_decode_ss = orig
    require(dec.hash_ok == [True], "the decode of the held stream")
    return seen["args"], seen["work"]


# the per-CU outputs of an ISS picture's encode scan; a PSS picture's add
# the reference index after the inter flag
SS_OUT_NAMES = ("inter", "mv", "imode", "cbf_y", "cbf_cb", "cbf_cr",
                "gtflag", "gtc")
PSS_OUT_NAMES = ("inter", "refsel") + SS_OUT_NAMES[1:]


def _hold_ss_scan(chk, got, want, what):
    """Two scan_encode_iss or scan_encode_pss results, plane by plane and
    output by output."""
    for a, b, nm in zip(got[:4], want[:4], ("ry", "rc", "coef_y",
                                            "coef_c")):
        chk.add(a, b, f"{what}: {nm}")
    require(set(got[4]) == set(want[4]), f"{what}: sizes")
    for lg in want[4]:
        names = PSS_OUT_NAMES if len(want[4][lg]) == 9 else SS_OUT_NAMES
        require(len(got[4][lg]) == len(names), f"{what}: outputs")
        for a, b, nm in zip(got[4][lg], want[4][lg], names):
            chk.add(a, b, f"{what}: {nm} {1 << lg}x{1 << lg}")


class _LevelLoop:
    """Within it, the encoder and the decoder run ISS and PSS pictures
    through the level loop (C14's plain version's form, on the card's
    kernels)."""

    def __enter__(self):
        from hevc_hop_torch.models import ss_scan
        self.saved = (ss_scan.scan_encode_iss, ss_scan.scan_decode_ss,
                      ss_scan.scan_encode_pss, ss_scan.scan_decode_pss)
        ss_scan.scan_encode_iss = (lambda *a, work, **k:
                                   ss_scan.scan_encode_iss_loop(*a, **k))
        ss_scan.scan_decode_ss = (lambda *a, work, **k:
                                  ss_scan.scan_decode_ss_loop(*a, **k))
        ss_scan.scan_encode_pss = (lambda *a, work, **k:
                                   ss_scan.scan_encode_pss_loop(*a, **k))
        ss_scan.scan_decode_pss = (lambda *a, work, **k:
                                   ss_scan.scan_decode_pss_loop(*a, **k))

    def __exit__(self, *exc):
        from hevc_hop_torch.models import ss_scan
        (ss_scan.scan_encode_iss, ss_scan.scan_decode_ss,
         ss_scan.scan_encode_pss, ss_scan.scan_decode_pss) = self.saved


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_ss_scan_plain(ctxs, ss_rows, checks):
    """Kernel C14 against the plain loop (the kernels' plain versions on
    the card): on a SS_PLAIN_W x SS_PLAIN_H corner of each ISS path's frame
    both entries, and at full size PLAIN_FULL's picture each way, whose
    times are the C14 rows' plain times; its PSS form as _pss_plain says.
    It runs last, after every trace. Returns the plain loop's seconds per
    path."""
    from hevc_hop_torch.models import ss_scan
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    chk = checks["C14"]
    out = {}
    for name in SS_PATHS:
        r, frame = ss_rows[name], ctxs[name]["frame"]
        args, dargs, c14, dec = r["args"], r["dargs"], r["c14"], r["dec"]
        secs = r["secs"]
        if PLAIN_FULL["encode"] == name:
            plain, secs["encode_plain_s"] = _timed(
                lambda: ss_scan.scan_encode_iss_loop(*args, plain=True))
            _hold_ss_scan(chk, c14, plain, f"C14 encode, {name} frame, "
                          "against the plain loop")
        if PLAIN_FULL["decode"] == name:
            dplain, secs["decode_plain_s"] = _timed(
                lambda: ss_scan.scan_decode_ss_loop(*dargs, plain=True))
            for a, b, nm in zip(dec, dplain, ("ry", "rc")):
                chk.add(a, b, f"C14 decode, {name} frame, against the "
                        f"plain loop: {nm}")
        # the plain loop on a corner of the frame, each way
        small = (frame[0][:SS_PLAIN_H, :SS_PLAIN_W],
                 frame[1][:SS_PLAIN_H // 2, :SS_PLAIN_W // 2],
                 frame[2][:SS_PLAIN_H // 2, :SS_PLAIN_W // 2])
        small = tuple(np.ascontiguousarray(p) for p in small)
        senc = HoloEncoder(HoloConfig(width=SS_PLAIN_W, height=SS_PLAIN_H,
                                      **ISS_PATHS[name][0]))
        sargs, swork = _ss_scan_inputs(senc, small)
        s14 = ss_scan.scan_encode_iss(*sargs, work=swork)
        splain, secs["small_encode_plain_s"] = _timed(
            lambda: ss_scan.scan_encode_iss_loop(*sargs, plain=True))
        _hold_ss_scan(chk, s14, splain, f"C14 encode, {name} "
                      f"{SS_PLAIN_W}x{SS_PLAIN_H} corner, against the plain "
                      "loop")
        sdargs, sdwork = _ss_decode_inputs(senc.encode_frame(*small))
        sdec = ss_scan.scan_decode_ss(*sdargs, work=sdwork)
        sdplain, secs["small_decode_plain_s"] = _timed(
            lambda: ss_scan.scan_decode_ss_loop(*sdargs, plain=True))
        for a, b, nm in zip(sdec, sdplain, ("ry", "rc")):
            chk.add(a, b, f"C14 decode, {name} {SS_PLAIN_W}x{SS_PLAIN_H} "
                    f"corner, against the plain loop: {nm}")
        out[name] = {k: v for k, v in secs.items() if "plain" in k}
    out.update(_pss_plain(ss_rows["pss-gt"], ctxs["pss-gt"]["frames"], chk))
    log(f"ss scan plain: {json.dumps(out)}; C14 held in {chk.cases} "
        f"comparisons, {chk.mism} mismatching elements")
    return out


def _pss_plain(row, frames, chk):
    """C14's PSS form against the plain loop, each way: on the pss-gt
    path's last PSS picture at full size (``row``, as
    phase_pss_scan_program held it; its times are the C14 PSS rows' plain
    times), on a SS_PLAIN_W x SS_PLAIN_H corner of the path's first two
    pictures (a temporal CU required) and on the mixed sequence at
    MIXED_PLAIN's sizes (each kind of CU required), the last two against
    the card's loop too. Returns the plain loop's seconds by picture."""
    from hevc_hop_torch.models import ss_scan
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    at = f"pss-gt picture {row['poc']}"
    secs = {}
    plain, secs["encode_plain_s"] = _timed(
        lambda: ss_scan.scan_encode_pss_loop(*row["args"], plain=True))
    _hold_ss_scan(chk, row["c14"], plain, f"C14 PSS encode, {at}, against "
                  "the plain loop")
    dplain, secs["decode_plain_s"] = _timed(
        lambda: ss_scan.scan_decode_pss_loop(*row["dargs"], plain=True))
    for a, b, nm in zip(row["dec"], dplain, ("ry", "rc")):
        chk.add(a, b, f"C14 PSS decode, {at}, against the plain loop: {nm}")
    small = [tuple(np.ascontiguousarray(p) for p in (
        f[0][:SS_PLAIN_H, :SS_PLAIN_W],
        f[1][:SS_PLAIN_H // 2, :SS_PLAIN_W // 2],
        f[2][:SS_PLAIN_H // 2, :SS_PLAIN_W // 2])) for f in frames[:2]]
    senc = HoloEncoder(HoloConfig(width=SS_PLAIN_W, height=SS_PLAIN_H,
                                  **ISS_PATHS["pss-gt"][0]))
    corner = f"pss-gt {SS_PLAIN_W}x{SS_PLAIN_H} corner"
    held, = _hold_pss(chk, _pss_calls(senc, small), corner, plain=True)
    require(_cu_kinds(held["c14"][4])["temporal_cus"] > 0,
            f"{corner}: no temporal CU")
    for side in ("encode", "decode"):
        secs[f"small_{side}_plain_s"] = held["secs"][f"{side}_plain_s"]
    out = {"pss-gt": secs}
    for w, h in MIXED_PLAIN:
        what = f"mixed {w}x{h}"
        menc = HoloEncoder(HoloConfig(width=w, height=h, **MIXED_CONFIG))
        held, = _hold_pss(chk, _pss_calls(menc, mixed_frames(w, h)), what,
                          plain=True)
        kinds = _cu_kinds(held["c14"][4])
        require(all(kinds.values()), f"{what}: a kind of CU is missing: "
                f"{kinds}")
        out[what] = dict(kinds, **held["secs"])
    return out


def _device_ms(fn, kernel, tries=3):
    """Device ms of the one launch of ``kernel`` that fn makes, from the
    first of ``tries`` profiler traces that holds its record; the run fails
    if none does."""
    for t in range(1, tries + 1):
        prof = _profile(fn)
        if prof["kernel_calls"][kernel] == 1:
            return prof["kernel_ms"][kernel]
        log(f"{kernel}: trace {t} holds {prof['kernel_calls'][kernel]} "
            "records of its one launch; traced again")
    require(False, f"no complete trace of {kernel} in {tries} tries")


def phase_ss_scan_device(ss_program, ss_rows):
    """C14's device ms per picture on each ISS path, and on the pss-gt
    path's last PSS picture, each way, from the profiler, into the path's
    record."""
    from hevc_hop_torch.models import ss_scan
    for name, r in ss_rows.items():
        rec = ss_program[name]
        if r.get("pss"):
            enc_fn, dec_fn = ss_scan.scan_encode_pss, ss_scan.scan_decode_pss
            form = "ss_scan_pss"
        else:
            enc_fn, dec_fn = ss_scan.scan_encode_iss, ss_scan.scan_decode_ss
            form = "ss_scan"
        rec["c14_encode_device_ms"] = _device_ms(
            lambda: enc_fn(*r["args"], work=r["work"]),
            f"{form}_encode_kernel")
        rec["c14_decode_device_ms"] = _device_ms(
            lambda: dec_fn(*r["dargs"], work=r["dwork"]),
            f"{form}_decode_kernel")
        log(f"ss scan device: {name}: encode "
            f"{rec['c14_encode_device_ms']} ms, decode "
            f"{rec['c14_decode_device_ms']} ms a picture")


def phase_ss_scan_program(ctxs, checks):
    """Kernel C14 on each ISS path's frame: its encode entry against the
    level loop of the card's kernels (every output), its decode entry on
    the decoder's own inputs for the path's stream against the decode loop
    and the encode's recon. Then C14 and the loop in turns (C14, loop,
    loop, C14) through the encoder and the decoder: encode s, scan_s,
    decode s. C14's device ms (phase_ss_scan_device) and the plain loop
    (phase_ss_scan_plain) come after the timing phases. Returns (a record
    per path, the inputs of the kernels line's C14 rows and of those
    phases)."""
    import torch
    from hevc_hop_torch.models import ss_scan
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    chk = checks["C14"]
    out, rows = {}, {}
    for name in SS_PATHS:
        ctx = ctxs[name]
        enc, frame, stream = ctx["enc"], ctx["frame"], ctx["stream"]
        args, work = _ss_scan_inputs(enc, frame)
        secs = {}
        c14, secs["encode_C14_s"] = _timed(
            lambda: ss_scan.scan_encode_iss(*args, work=work))
        grid = ss_scan.LAST_LAUNCH
        require_cluster_launch(grid, f"C14 encode, {name}")
        loop, secs["encode_loop_s"] = _timed(
            lambda: ss_scan.scan_encode_iss_loop(*args))
        _hold_ss_scan(chk, c14, loop, f"C14 encode, {name} frame, against "
                      "the level loop")
        dargs, dwork = _ss_decode_inputs(stream)
        dec, secs["decode_C14_s"] = _timed(
            lambda: ss_scan.scan_decode_ss(*dargs, work=dwork))
        dloop, secs["decode_loop_s"] = _timed(
            lambda: ss_scan.scan_decode_ss_loop(*dargs))
        for a, b, c_, nm in zip(dec, dloop, c14[:2], ("ry", "rc")):
            chk.add(a, b, f"C14 decode, {name} frame, against the loop: "
                    f"{nm}")
            chk.add(a, c_, f"C14 decode, {name} frame, against the "
                    f"encode's recon: {nm}")
        # turns through the encoder and the decoder
        turns = {"C14": [], "loop": []}
        for route in ("C14", "loop", "loop", "C14"):
            with (_LevelLoop() if route == "loop"
                  else contextlib.nullcontext()):
                again, e_s = _timed(lambda: enc.encode_frame(*frame))
                require(again == stream, f"{name}: the {route} turn's "
                        "stream differs")
                d = Decoder()
                _, d_s = _timed(lambda: d.decode_stream(stream))
                require(d.hash_ok == [True], f"{name}: a turn's decode")
                turns[route].append((e_s, enc.last_stats["scan_s"], d_s,
                                     d.last_stats["scan_s"]))
        med = {r: np.median(np.array(v), axis=0) for r, v in turns.items()}
        gts = sum(int(o[6].sum()) for o in c14[4].values())
        rec = {"path": name, "groups": len(work.host_groups),
               "cus": len(work.host_items), "widest_group": work.widest,
               "gt_cus": gts, "decode_groups": len(dwork.host_groups),
               "launch": grid, "turns": turns, **secs,
               **{f"{k}_{r}": float(med[r][i]) for r in med
                  for i, k in enumerate(("encode_s", "scan_s", "decode_s",
                                         "decode_scan_s"))}}
        log(f"ss scan program: {json.dumps(rec)}")
        out[name] = rec
        rows[name] = dict(args=args, work=work, dargs=dargs, dwork=dwork,
                          secs=secs, c14=c14, dec=dec)
    log(f"ss scan program: C14 held in {chk.cases} comparisons, "
        f"{chk.mism} mismatching elements")
    return out, rows


def _recorded(name, run):
    """The calls of ss_scan.<name> that run() makes, as [(its positional
    arguments, its work list)]."""
    from hevc_hop_torch.models import ss_scan
    seen = []
    orig = getattr(ss_scan, name)

    def record(*a, work):
        seen.append((a, work))
        return orig(*a, work=work)

    setattr(ss_scan, name, record)
    try:
        run()
    finally:
        setattr(ss_scan, name, orig)
    return seen


def _pss_calls(enc, frames, stream=None):
    """``enc`` codes the sequence ``frames`` (into ``stream``, where given)
    and the decoder decodes it: the encoder's own scan_encode_pss calls and
    the decoder's own scan_decode_pss calls, [((arguments, work list),
    (arguments, work list))], one pair per PSS picture."""
    from hevc_hop_torch.models.decoder import Decoder
    got = []
    encs = _recorded("scan_encode_pss",
                     lambda: got.append(enc.encode_sequence(frames)))
    require(stream is None or got[0] == stream, "the held sequence's "
            "stream differs")
    dec = Decoder()
    decs = _recorded("scan_decode_pss", lambda: dec.decode_stream(got[0]))
    require(dec.hash_ok == [True] * len(frames) and dec.concealed == [],
            f"the held sequence's decode: hash_ok {dec.hash_ok}")
    require(len(encs) == len(decs) == len(frames) - 1,
            f"{len(encs)} PSS encodes, {len(decs)} PSS decodes")
    return list(zip(encs, decs))


def _hold_pss(chk, calls, what, plain=False, gt=True):
    """C14's PSS form on each PSS picture's recorded inputs (``calls``,
    from _pss_calls), each way, against the level loop of the card's
    kernels and, with ``plain``, the plain loop: recon, level planes and
    every per-CU output, the reference index too; its decode against the
    encode's recon as well. Returns, per picture, its inputs, C14's
    results, the seconds each way and C14's grid."""
    from hevc_hop_torch.models import ss_scan
    routes = (("level", False), ("plain", True))[:2 if plain else 1]
    out = []
    for poc, ((args, work), (dargs, dwork)) in enumerate(calls, start=1):
        at = f"{what} picture {poc}"
        secs = {}
        c14, secs["encode_C14_s"] = _timed(
            lambda: ss_scan.scan_encode_pss(*args, work=work))
        grid = ss_scan.LAST_LAUNCH
        require_cluster_launch(grid, f"C14 PSS encode, {at}")
        dec, secs["decode_C14_s"] = _timed(
            lambda: ss_scan.scan_decode_pss(*dargs, work=dwork))
        for a, b, nm in zip(dec, c14[:2], ("ry", "rc")):
            chk.add(a, b, f"C14 PSS decode, {at}, against the encode's "
                    f"recon: {nm}")
        for route, p in routes:
            key = "plain" if p else "loop"
            loop, secs[f"encode_{key}_s"] = _timed(
                lambda: ss_scan.scan_encode_pss_loop(*args, plain=p))
            _hold_ss_scan(chk, c14, loop, f"C14 PSS encode, {at}, against "
                          f"the {route} loop")
            dloop, secs[f"decode_{key}_s"] = _timed(
                lambda: ss_scan.scan_decode_pss_loop(*dargs, plain=p))
            for a, b, nm in zip(dec, dloop, ("ry", "rc")):
                chk.add(a, b, f"C14 PSS decode, {at}, against the {route} "
                        f"loop: {nm}")
        out.append(dict(args=args, work=work, dargs=dargs, dwork=dwork,
                        c14=c14, dec=dec, secs=secs, grid=grid, pss=True,
                        poc=poc))
    return out


def _pss_record(r):
    """What phase_pss_scan_program prints of a held PSS picture."""
    return {"poc": r["poc"], "groups": len(r["work"].host_groups),
            "cus": len(r["work"].host_items),
            "widest_group": r["work"].widest, **_cu_kinds(r["c14"][4]),
            "decode_groups": len(r["dwork"].host_groups),
            "launch": r["grid"], **r["secs"]}


def phase_pss_scan_program(ctxs, checks):
    """Kernel C14's PSS form on every PSS picture of the pss-gt sequence,
    at full size, on the encoder's and the decoder's own inputs (the
    sequence coded and decoded again, its stream unchanged): its encode
    entry against the level loop of the card's kernels (recon, level
    planes and every per-CU output, the reference index too), its decode
    entry against the decode loop and the encode's recon: 0 mismatches.
    Then C14 and the loop in turns (C14, loop, loop, C14) through the
    encoder (the ISS picture, then the first PSS one, which is timed) and
    the decoder (the sequence). Every CU of those pictures is temporal, so
    the mixed sequence's PSS picture (temporal, SS, GT and intra CUs, each
    kind required) is held at full size the same way. Its device ms
    (phase_ss_scan_device) and the plain loop (_pss_plain) come at the
    end. Returns (a record, the last PSS picture's inputs and results for
    those phases and the kernels line's C14 PSS rows)."""
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
    chk = checks["C14"]
    ctx = ctxs["pss-gt"]
    enc, frames, stream = ctx["enc"], ctx["frames"], ctx["stream"]
    held = _hold_pss(chk, _pss_calls(enc, frames, stream), "pss-gt")
    pics = [_pss_record(r) for r in held]
    # turns through the encoder and the decoder
    turns = {"C14": [], "loop": []}
    for route in ("C14", "loop", "loop", "C14"):
        with (_LevelLoop() if route == "loop"
              else contextlib.nullcontext()):
            first = enc.encode_frame(*frames[0])
            again, e_s = _timed(lambda: enc._encode_pss(*frames[1], 1))
            require(stream.startswith(first + again),
                    f"pss-gt: the {route} turn's stream differs")
            scan_s = enc.last_stats["scan_s"]
            d = Decoder()
            _, d_s = _timed(lambda: d.decode_stream(stream))
            require(d.hash_ok == [True] * PSS_FRAMES,
                    "pss-gt: a turn's decode")
            turns[route].append((e_s, scan_s, d_s, d.last_stats["scan_s"]))
    med = {r: np.median(np.array(v), axis=0) for r, v in turns.items()}
    # the mixed sequence at full size
    what = f"mixed {W}x{H}"
    menc = HoloEncoder(HoloConfig(width=W, height=H, **MIXED_CONFIG))
    with _GtLevels("mixed", pss=True):
        mixed, = _hold_pss(chk, _pss_calls(menc, mixed_frames(W, H)), what)
    mixed = dict(_pss_record(mixed), frame=f"{W}x{H}", config=MIXED_CONFIG,
                 content=MIXED_CONTENT)
    require(all(mixed[k] > 0 for k in _cu_kinds({})),
            f"{what}: a kind of CU is missing: {mixed}")
    rec = {"path": "pss-gt", "pictures": pics, "turns": turns,
           "mixed": mixed,
           **{f"{k}_{r}": float(med[r][i]) for r in med
              for i, k in enumerate(("pss_encode_s", "pss_scan_s",
                                     "decode_sequence_s",
                                     "pss_decode_scan_s"))}}
    log(f"pss scan program: {json.dumps(rec)}")
    log(f"pss scan program: C14 held in {chk.cases} comparisons, "
        f"{chk.mism} mismatching elements")
    return rec, held[-1]


# Kernel C14's stage clocks (csrc/ss_scan.cu's Stamp, built with
# -DHH_STAGE_CLOCK into a library of its own): the read phase's stages in
# their order, with the stamp each ends at, then the phases' stamps
CLOCK_STAGES = (("intra", 1), ("C9 SS search", 2), ("C9 temporal search", 3),
                ("cluster sync 1", 4), ("C9 merge", 5),
                ("cluster sync 2", 6),
                ("C10 merge", 16), ("C10 SS half-pel", 17),
                ("C10 SS quarter-pel", 18), ("C10 temporal half-pel", 19),
                ("C10 temporal quarter-pel", 20), ("C10 chain end", 7),
                ("C12 window", 22),
                *((f"C12 iteration {it}", 23 + it + 1) for it in range(-1, 6)),
                ("C12 anchor 0", 8), ("C12 anchor 1", 9),
                ("cluster sync 3", 10), ("C10 tournament", 21),
                ("C12 decide", 11), ("chroma", 12))
CLOCK_SYNC1, CLOCK_WRITE, CLOCK_SYNC2, CLOCK_STAMPS = 13, 14, 15, 37
# the write phase's C3 stages (ss_scan.cu TqMark: ns a CTA's write tasks of
# a group spent in each, slot CLOCK_TQ + common.cuh Mark)
CLOCK_TQ = 30
CLOCK_TQ_STAGES = (("forward", 2), ("quant", 3), ("sbh", 4), ("recon", 5))
# the slot that holds each CTA's SM index + 1
CLOCK_SM = 36
# the search parts' stamps (SS, temporal), the two anchors', and each of
# C10's chains' (merge, SS refinement, temporal refinement)
CLOCK_SEARCH, CLOCK_ANCHORS = (2, 3), (8, 9)
CLOCK_CHAINS = ((16,), (17, 18), (19, 20))
CLOCK_PATHS = ("iss", "iss-gt", "iss-gt-warped", "pss-gt")
CLOCK_FLAGS = ["-DHH_STAGE_CLOCK"]


class _ClockLibrary:
    """Within it, the wrappers launch kernel ``name`` (C14's ss_scan by
    default) from the library ``so`` (the stage-clock build) in place of
    the production one."""

    def __init__(self, so, name="ss_scan"):
        self.so, self.name = so, name

    def __enter__(self):
        from hevc_hop_torch import _cuda
        self.saved = _cuda._libs.get(self.name)
        _cuda._libs[self.name] = self.so

    def __exit__(self, *exc):
        from hevc_hop_torch import _cuda
        _cuda._libs[self.name] = self.saved


def stage_split(clk):
    """The stage split of one C14 encode from its stamps clk [groups, CTAs,
    CLOCK_STAMPS] (ns, 0 where a CTA did not run the stage), in us summed
    over the groups: per read-phase stage the longest time any CTA of the
    group spent in it (a CTA's stage runs from its previous stamp to this
    one); the read phase (the group's first start to its last read end),
    grid sync 1 (from there to the last CTA out of it), the write phase and
    grid sync 2 alike; and the groups' time (first start to last out of
    sync 2). The write phase's C3 stages (CLOCK_TQ_STAGES) are split as
    the read phase's are: per stage the longest any CTA of the group spent
    in it, summed over the groups."""
    clk = np.asarray(clk, dtype=np.int64)
    start = clk[:, :, 0]
    last = start.copy()
    stage = {}
    for name, k in CLOCK_STAGES:
        s = clk[:, :, k]
        stage[name] = np.where(s > 0, s - last, 0).max(axis=1)
        last = np.where(s > 0, s, last)
    g0 = start.min(axis=1)
    read_end = last.max(axis=1)
    s1 = clk[:, :, CLOCK_SYNC1].max(axis=1)
    wr = clk[:, :, CLOCK_WRITE].max(axis=1)
    s2 = clk[:, :, CLOCK_SYNC2].max(axis=1)
    phase = {"read phase": read_end - g0, "grid sync 1": s1 - read_end,
             "write phase": wr - s1, "grid sync 2": s2 - wr}
    group = s2 - g0
    us = lambda v: float(v.sum() / 1e3)
    write = {name: us(clk[:, :, CLOCK_TQ + k].max(axis=1))
             for name, k in CLOCK_TQ_STAGES}
    return {"groups": int(clk.shape[0]), "groups_us": us(group),
            "group_us_median": float(np.median(group) / 1e3),
            "group_us_max": float(group.max() / 1e3),
            "stage_us": {k: us(v) for k, v in stage.items()},
            "phase_us": {k: us(v) for k, v in phase.items()},
            "write_stage_us": write}


def phase_stage_clock(ss_rows, checks):
    """C14's stage clocks on the encode of CLOCK_PATHS' pictures (pss-gt:
    its last PSS picture): the stage-clock build of csrc/ss_scan.cu
    (-DHH_STAGE_CLOCK), its outputs held against the production
    library's, the cluster layout required from its stamps
    (require_cluster_stamps), then stage_split of them, with the launch's
    shape."""
    import torch
    from hevc_hop_torch import _cuda
    from hevc_hop_torch.models import ss_scan
    t0 = time.perf_counter()
    so = (_CLOCK_BUILD["so"].result() if "so" in _CLOCK_BUILD else
          _cuda.variant("ss_scan", "clock", CLOCK_FLAGS))
    log(f"stage clock: its build awaited {time.perf_counter() - t0:.1f} s")
    set_clock = so.hh_ss_scan_clock
    set_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    chk = checks["C14"]
    out = {}
    for name in CLOCK_PATHS:
        r = ss_rows[name]
        fn = ss_scan.scan_encode_pss if r.get("pss") else \
            ss_scan.scan_encode_iss
        groups = len(r["work"].host_groups)
        ctas = torch.cuda.get_device_properties(0).multi_processor_count * 8
        buf = torch.zeros((groups, ctas, CLOCK_STAMPS), dtype=torch.int64,
                          device="cuda")
        with _ClockLibrary(so):
            torch.cuda.synchronize()
            _cuda.check("ss_scan", set_clock(buf.data_ptr(), ctas))
            got = fn(*r["args"], work=r["work"])
            torch.cuda.synchronize()
            _cuda.check("ss_scan", set_clock(None, 0))
            launch = ss_scan.LAST_LAUNCH
        _hold_ss_scan(chk, got, r["c14"], f"C14 stage-clock build, {name}, "
                      "against the production library")
        clk = buf[:, :launch["grid"]].cpu().numpy()
        anchor_stamps = require_cluster_stamps(
            clk, launch["ctas_per_cu"], f"C14 stage clocks, {name}",
            r["args"][-1] is not None)
        rec = {"path": name, "launch": launch, "anchor_stamps": anchor_stamps,
               **stage_split(clk)}
        log(f"stage clock: {json.dumps(rec)}")
        out[name] = rec
    return out



# Kernel C13's stage clocks (csrc/scan.cu's Clock, built with
# -DHH_STAGE_CLOCK into a library of its own): per level and CTA the ns the
# CTA spent in each stage, slot plane * 6 + stage (C13_MARKS, common.cuh
# Mark; planes luma, cb, cr), the RMD's merge (C13_CLOCK_MERGE), the wait at
# the grid sync; then the level's start and the CTA's way out of its sync
C13_MARKS = ("chain", "predict", "fwd", "quant", "sbh", "recon")
C13_PLANES = ("luma", "cb", "cr")
C13_CLOCK_MERGE = 3 * len(C13_MARKS)
C13_CLOCK_WAIT, C13_CLOCK_START, C13_CLOCK_END = 19, 20, 21
C13_CLOCK = 22
C13_CLOCK_PATHS = ("production", "uniform")


def scan_stage_split(clk):
    """The stage split of one C13 encode from its clocks clk [levels, CTAs,
    C13_CLOCK] (ns), in us summed over the levels: per stage the longest
    time any CTA of the level spent in it; the levels' time (first start
    to last way out of the sync); the grid sync's own cost (the least wait
    of any CTA of a level) and the CTAs' mean wait; CTAs at work per
    level."""
    clk = np.asarray(clk, dtype=np.int64)
    nm = len(C13_MARKS)
    stage = {f"{C13_PLANES[j // nm]} {C13_MARKS[j % nm]}":
             float(clk[:, :, j].max(axis=1).sum() / 1e3)
             for j in range(C13_CLOCK_MERGE)}
    stage["RMD merge"] = float(clk[:, :, C13_CLOCK_MERGE].max(axis=1).sum()
                               / 1e3)
    start = np.where(clk[:, :, C13_CLOCK_START] > 0,
                     clk[:, :, C13_CLOCK_START],
                     np.iinfo(np.int64).max).min(axis=1)
    level = clk[:, :, C13_CLOCK_END].max(axis=1) - start
    wait = clk[:, :, C13_CLOCK_WAIT]
    busy = (clk[:, :, :C13_CLOCK_WAIT].sum(axis=2) > 0).sum(axis=1)
    return {"levels": int(clk.shape[0]),
            "levels_us": float(level.sum() / 1e3),
            "level_us_median": float(np.median(level) / 1e3),
            "stage_us": stage,
            "grid_sync_us": float(wait.min(axis=1).sum() / 1e3),
            "wait_us_mean": float(wait.mean(axis=1).sum() / 1e3),
            "busy_ctas_mean": float(busy.mean()),
            "busy_ctas_max": int(busy.max())}


def require_plane_stamps(clk, work, grid, rmd, what):
    """C13's layout from its clocks clk [levels, CTAs, C13_CLOCK]. With
    the modes given, in every level whose three tasks per item fit the
    grid, each item's planes ran on CTAs of their own: as many CTAs coded
    luma as the level has items, as many coded chroma as it has chroma
    blocks, and no CTA coded both. With the RMD, in every level at least
    two CTAs ran a share of the 35 modes. Returns the levels checked."""
    nm = len(C13_MARKS)
    luma = clk[:, :, 0:nm].sum(axis=2) > 0
    chroma = clk[:, :, nm:C13_CLOCK_MERGE].sum(axis=2) > 0
    off, items = work.host_off, work.host_items
    checked = 0
    for s in range(len(off) - 1):
        lv = items[off[s]:off[s + 1]]
        if rmd:
            parts = int((clk[s, :, 1] > 0).sum())
            require(parts >= 2, f"{what}: level {s}: the RMD ran on {parts} "
                    "CTA")
            checked += 1
            continue
        if 3 * len(lv) > grid:
            continue
        nl, nc = int(luma[s].sum()), int(chroma[s].sum())
        both = int((luma[s] & chroma[s]).sum())
        want_c = 2 * int((lv[:, 2] >= 0).sum())
        require(nl == len(lv) and nc == want_c and both == 0,
                f"{what}: level {s}: {nl} luma CTAs for {len(lv)} items, "
                f"{nc} chroma CTAs for {want_c} blocks, {both} CTAs with "
                "both")
        checked += 1
    require(checked > 0, f"{what}: no level checked")
    return checked


def phase_scan_clock(scan_rows, checks):
    """C13's stage clocks on the encode of C13_CLOCK_PATHS' frames: the
    stage-clock build of csrc/scan.cu (-DHH_STAGE_CLOCK), its outputs held
    against the production library's, the layout required from its clocks
    (require_plane_stamps), then scan_stage_split of them, with the
    launch's shape."""
    import torch
    from hevc_hop_torch import _cuda
    from hevc_hop_torch.models import wavefront_scan as ws
    t0 = time.perf_counter()
    so = (_CLOCK_BUILD["scan"].result() if "scan" in _CLOCK_BUILD else
          _cuda.variant("scan", "clock", CLOCK_FLAGS))
    log(f"scan clock: its build awaited {time.perf_counter() - t0:.1f} s")
    set_clock = so.hh_scan_clock
    set_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    chk = checks["C13"]
    out = {}
    for name in C13_CLOCK_PATHS:
        r = scan_rows[name]
        args, kws, work = r["args"], r["kws"], r["sched"].work
        want = ws.scan_encode(*args, **kws, work=work)
        levels = len(work.host_off) - 1
        ctas = torch.cuda.get_device_properties(0).multi_processor_count * 8
        buf = torch.zeros((levels, ctas, C13_CLOCK), dtype=torch.int64,
                          device="cuda")
        with _ClockLibrary(so, "scan"):
            torch.cuda.synchronize()
            _cuda.check("scan", set_clock(buf.data_ptr(), ctas))
            got = ws.scan_encode(*args, **kws, work=work)
            torch.cuda.synchronize()
            _cuda.check("scan", set_clock(None, 0))
            launch = ws.LAST_LAUNCH
        _hold_scan(chk, got, want, f"C13 stage-clock build, {name}, against "
                   "the production library")
        grid = launch[0]
        clk = buf[:, :grid].cpu().numpy()
        rmd = args[9] is None
        checked = require_plane_stamps(clk, work, grid, rmd,
                                       f"C13 stage clocks, {name}")
        rec = {"path": name, "launch": launch, "rmd": rmd,
               "levels_checked": checked, **scan_stage_split(clk)}
        log(f"scan clock: {json.dumps(rec)}")
        out[name] = rec
    return out

# kernel C9's scan entry held at every CU size and both bit depths on a
# lenslet plane of this size
C9_SPLIT_W, C9_SPLIT_H = 512, 384
C9_SPLIT_BLOCKS = 8


def phase_c9_split(checks):
    """Kernel C9's scan entry (a cluster of CTAs per block, the
    displacements split between them) against its plain body on the card
    at n = 8, 16 and 32, 8 and 10 bit, on a lenslet plane: the SS search
    with the GT anchor ring (radius 32), then the PSS launch (the SS search
    in F10's order beside the temporal search, radius 16, over the plane
    panned 3 samples), every output; and against the emulation of its
    arithmetic (ops/ss_search.py ss_search_split, t_search_split, run on
    the card), whose counts show the entries that stayed exact below 2^24
    and those that took the ordered form (required at 32x32 and 10 bit,
    absent at 8-bit 16x16 and less; at 32x32 the SS search has no causal
    displacement within radius 32, the temporal one shows the region) and
    the anchor ring found (n < 32)."""
    import torch
    from hevc_hop_torch.models import wavefront
    from hevc_hop_torch.models.partition import full_lambda
    from hevc_hop_torch.models.ss_scan import zmax_win_px
    from hevc_hop_torch.ops import inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    dev = torch.device("cuda")
    w, h, lam = C9_SPLIT_W, C9_SPLIT_H, full_lambda(QP)
    chk = checks["C9"]
    zplane = wavefront.zaddr4_plane(w, h, 5)
    out = {}
    for bd in (8, 10):
        rng = np.random.default_rng(bd)
        y = synth_lenslet(w, h, 13, seed=bd)[0] << (bd - 8)
        maxv = (1 << bd) - 1
        recon = np.zeros((h + 32, w), np.int32)
        recon[:h] = y
        org = recon.copy()
        org[:h] = np.clip(y + rng.integers(-3, 4, y.shape), 0, maxv)
        ref = recon.copy()
        ref[:h] = np.roll(y, 3, axis=1)
        recon, org, ref = (torch.as_tensor(a, device=dev)
                           for a in (recon, org, ref))
        motion = (
            torch.as_tensor(rng.integers(-200, 40, ((h + 32) // 4, w // 4)),
                            dtype=torch.int32, device=dev),
            torch.as_tensor(rng.integers(-200, 40, ((h + 32) // 4, w // 4)),
                            dtype=torch.int32, device=dev),
            torch.as_tensor(rng.random(((h + 32) // 4, w // 4)) < 0.6,
                            dtype=torch.int32, device=dev),
            torch.as_tensor(rng.integers(0, 2, ((h + 32) // 4, w // 4)),
                            dtype=torch.int32, device=dev))
        for n in (8, 16, 32):
            ys, xs = np.mgrid[96:h - n + 1:3 * n, 0:w - n + 1:5 * n]
            pos = np.stack([xs.ravel(), ys.ravel()], -1)[:C9_SPLIT_BLOCKS]
            b = len(pos)
            zcur = torch.as_tensor(
                zplane[pos[:, 1] >> 2, pos[:, 0] >> 2].astype(np.int32),
                device=dev)
            pos = torch.as_tensor(pos.astype(np.int32), device=dev)
            zmaxw = torch.as_tensor(zmax_win_px(zplane, n), device=dev)
            zmax2n = torch.as_tensor(zmax_win_px(zplane, 2 * n, ifm=2),
                                     device=dev)
            nbav = torch.as_tensor(rng.random((b, 5)) < 0.7, device=dev)
            miav = torch.as_tensor(rng.random((b, 3)) < 0.7, device=dev)
            args = (recon, org, pos, zcur, zmaxw, motion, nbav, miav, n, 32,
                    w, h, lam, 16, zmax2n)
            at = f"C9 split n={n} {bd} bit"
            got = ss.ss_search(*args)
            want = ss.ss_search_motion_plain(*args)
            emu, reg = ss.ss_search_split(recon, org, pos, zcur, zmaxw,
                                          ia.gather_cands(
                                              *motion, pos, nbav, miav, n,
                                              16)[3], n, 32, w, h, lam,
                                          zmax2n)
            for g, w_, e, nm in zip(got, want, emu, (
                    "mv", "cost", "pred", "sse", "anchor", "gt_rate",
                    "gt_ok")):
                chk.add(g, w_, f"{at}: {nm} against the plain body")
                chk.add(g, e, f"{at}: {nm} against the emulation")
            pargs = args + (ref, 16)
            gs, gt = ss.pss_search(*pargs)
            ws, wt = ss.pss_search_plain(*pargs)
            p_ss, p_t = ia.gather_cands(*motion, pos, nbav, miav, n, 16,
                                        ss.SS_IDX_PSS)[3:]
            es, _ = ss.ss_search_split(recon, org, pos, zcur, zmaxw, p_ss,
                                       n, 32, w, h, lam, zmax2n, seq=True)
            et, treg = ss.t_search_split(ref, org, pos, p_t, n, 16, w, h,
                                         lam)
            for g, w_, e, nm in zip(gs + gt, ws + wt, es + et, (
                    "mv", "cost", "pred", "sse", "anchor", "gt_rate",
                    "gt_ok", "temporal mv", "temporal cost",
                    "temporal pred", "temporal sse")):
                chk.add(g, w_, f"{at} PSS: {nm} against the plain body")
                chk.add(g, e, f"{at} PSS: {nm} against the emulation")
            # at 32x32 no displacement within radius 32 is causal (its
            # window's interpolation margin reaches the CU's own first
            # samples): the SS search takes index 0 there
            big = n == 32 or bd == 10
            ss_ok = (reg["none_valid"] == b if n == 32 else
                     reg["ring"] > 0 and (reg["ordered"] > 0) == big)
            require(ss_ok and (treg["ordered"] > 0) == big,
                    f"{at}: the sums' regions {reg}, temporal {treg}")
            out[f"n{n}_{bd}bit"] = {"blocks": b, "ss": reg, "temporal": treg}
    log(f"c9 split: {json.dumps(out)}")
    log(f"c9 split: C9 held in {chk.cases} comparisons, {chk.mism} "
        "mismatching elements")
    require(chk.mism == 0, "C9's split search differs from its plain body")
    return out


# kernels C10's arms entry and C12's step held bit for bit against their
# plain bodies and their split emulations on planes of this size: every
# CU size and bit depth, noise (at 10-bit 32x32 the SSEs pass 2^24) and
# flat planes (candidates tie)
ARMS_W, ARMS_H = 256, 192
ARMS_BLOCKS = 8


def _bits(t):
    """t with a float32 tensor's bits as int32, to compare bit for bit."""
    import torch
    return t.view(torch.int32) if t.is_floating_point() else t


def arms_case(n, bd, flat, seed, dev):
    """The inputs of C10's arms entry and C12's step on an ARMS_W x ARMS_H
    picture at bit depth bd: noise planes (recon, original, previous
    picture and chroma drawn independently) or flat ones (every candidate's
    prediction alike, C9's full-pel cost priced above them, half the blocks
    without their first three merge candidates, so that candidates tie);
    ARMS_BLOCKS blocks of n x n with random carried motion (every
    reference index 0 on ISS, as an ISS picture carries it), full-pel
    results and anchors. Returns (the arms entry's ISS arguments, pss,
    the PSS form's motion planes, the GT step's extra arguments)."""
    import torch
    from hevc_hop_torch.models import wavefront
    from hevc_hop_torch.models.partition import full_lambda
    from hevc_hop_torch.models.ss_scan import zmax_win_px
    w, h, b = ARMS_W, ARMS_H, ARMS_BLOCKS
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                  device=dev)

    def plane(rows, cols, lo):
        p = np.zeros((rows, cols), np.int32)
        p[:lo] = (maxv // 2 if flat else
                  rng.integers(0, maxv + 1, (lo, cols)))
        return p

    recon, org, ref = (t(plane(h + 32, w, h)) for _ in range(3))
    hc_off = h // 2 + 16
    rc = plane(2 * hc_off, w // 2, h // 2)
    rc[hc_off:hc_off + h // 2] = rc[:h // 2][::-1]
    zplane = wavefront.zaddr4_plane(w, h, 5)
    ys, xs = np.mgrid[h // 2:h - n + 1:n, w // 4:w - n + 1:2 * n]
    pos = np.stack([xs.ravel(), ys.ravel()], -1)[:b].astype(np.int32)
    zcur = zplane[pos[:, 1] >> 2, pos[:, 0] >> 2].astype(np.int32)
    shape4 = ((h + 32) // 4, w // 4)
    motion = tuple(t(a) for a in (
        rng.integers(-200, 40, shape4), rng.integers(-200, 40, shape4),
        rng.random(shape4) < 0.6, np.zeros(shape4)))
    pmotion = motion[:3] + (t(rng.integers(0, 2, shape4)),)
    nbav = rng.random((b, 5)) < 0.7
    if flat:
        nbav[::2, :3] = False
    miav = rng.random((b, 3)) < 0.7
    sse0 = (np.full(b, 1e6) if flat else rng.uniform(1e3, 1e8, b)).astype(
        np.float32)
    sse0[-1] = 3e38      # C9 found nothing: no refinement
    lam = full_lambda(32)
    head = (recon, org, t(pos), t(zcur), t(zmax_win_px(zplane, n)), motion,
            t(nbav, torch.bool), t(miav, torch.bool),
            t(rng.integers(-2 * n, n, (b, 2))),
            t(rng.integers(0, maxv + 1, (b, n, n))), t(sse0, torch.float32),
            t(rng.integers(0, maxv + 1, (b, n, n))),
            t(rng.integers(0, 35, b)), n, w, h, bd, lam, 16)
    tsse0 = rng.uniform(1e3, 1e8, b).astype(np.float32)
    pss = (ref, t(rng.integers(-n, n, (b, 2))),
           t(rng.integers(0, maxv + 1, (b, n, n))), t(tsse0, torch.float32))
    ring = (t(rng.integers(-2 * n, 1, (b, 2))),
            t(rng.uniform(2, 20, b), torch.float32),
            t(rng.random(b) < 0.9, torch.bool))
    gt_in = dict(rc=t(rc), zmax2n=t(zmax_win_px(zplane, 2 * n, ifm=2)),
                 ring=ring, hc_off=hc_off)
    return head, pss, pmotion, gt_in


def phase_arms_exact(checks, dev="cuda"):
    """Kernels C10 and C12 bit for bit: on arms_case's inputs at n = 8, 16
    and 32, 8 and 10 bit, noise and flat, C10's arms entry (ISS and PSS
    forms), C12's step after it (ISS and PSS) and C12's search alone on the
    anchors, each against its plain body and its split emulation
    (ops/inter_arms.py inter_arms_split, ops/gt.py gt_search_split) on the
    card, every output and in-place plane, floats by their bits. Requires
    0 mismatching elements in each, the SSE past 2^24 in the 10-bit 32x32
    noise case (both kernels), and ties among the least costs on the flat
    planes. Returns the counts."""
    import torch
    from hevc_hop_torch.ops import gt, inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    c10, c12 = checks["C10"], checks["C12"]
    out = {}
    mism = {"C10": 0, "C12": 0}

    def hold(chk, key, got, want, what):
        require(len(got) == len(want), f"{what}: outputs")
        for k, (g, w_) in enumerate(zip(got, want)):
            m, e = _mismatch(_bits(g), _bits(w_))
            chk.cases += 1
            chk.mism += m
            mism[key] += m
            if m:
                log(f"{what}: output {k}: {m} mismatching elements")

    for n in (8, 16, 32):
        for bd in (8, 10):
            for flat in (False, True):
                at = f"n={n} {bd} bit {'flat' if flat else 'noise'}"
                iss, pss, pmotion, gi = arms_case(
                    n, bd, flat, 100 * n + bd + flat, torch.device(dev))
                st, gst = {}, {}
                for form, extra in (("ISS", {}), ("PSS", {"pss": pss})):
                    head = iss if form == "ISS" else (
                        iss[:5] + (pmotion,) + iss[6:])
                    ip = head[11]
                    runs = []
                    for fn in (ia.inter_arms, ia.inter_arms_plain,
                               lambda *a, **k: ia.inter_arms_split(
                                   *a, **k, stats=st)):
                        args = head[:11] + (ip.clone(),) + head[12:]
                        runs.append(tuple(fn(*args, **extra)) + (args[11],))
                    hold(c10, "C10", runs[0], runs[1],
                         f"C10 {at} {form} against the plain body")
                    hold(c10, "C10", runs[0], runs[2],
                         f"C10 {at} {form} against the emulation")
                    plain = runs[1]
                    refsel = plain[4] if form == "PSS" else None
                    base = (plain[-1], plain[0], plain[1], plain[2]) + (
                        () if refsel is None else (refsel,))
                    steps = []
                    for fn in (gt.gt_step, gt.gt_step_plain):
                        bufs = tuple(x.clone() for x in base)
                        r = fn(head[0], head[1], gi["rc"], head[2], head[3],
                               gi["zmax2n"], head[5], head[6], head[7],
                               gi["ring"], plain[3], *bufs[:4], n, ARMS_W,
                               ARMS_H, gi["hc_off"], bd, head[17], 16,
                               *bufs[4:])
                        steps.append(tuple(r) + bufs)
                    hold(c12, "C12", steps[0], steps[1],
                         f"C12 {at} {form} against the plain body")
                head = iss
                blocks = ss.block_at(head[1], head[2], n)
                anchor = gi["ring"][0]
                want = gt.gt_search_plain(head[0], blocks, head[2], anchor, n,
                                          head[17], ARMS_H, bd)
                emu = gt.gt_search_split(head[0], blocks, head[2], anchor, n,
                                         head[17], ARMS_H, bd, stats=gst)
                hold(c12, "C12", emu, want,
                     f"C12 search {at}: the emulation against the plain "
                     "body")
                out[at] = {"C10": st, "C12 search": gst}
    log(f"arms exact: {json.dumps(out)}")
    log(f"arms exact: C10 {mism['C10']} and C12 {mism['C12']} mismatching "
        f"elements; C10 held in {c10.cases}, C12 in {c12.cases} "
        "comparisons")
    require(mism["C10"] == 0 and mism["C12"] == 0,
            f"C10 or C12 differs from its plain body: {mism}")
    big = out["n=32 10 bit noise"]
    require(big["C10"]["past_2_24"] > 0 and big["C12 search"]["past_2_24"] > 0,
            f"the 10-bit 32x32 noise case never passed 2^24: {big}")
    ties = sum(v["C10"]["merge_ties"] + v["C10"]["refine_ties"]
               for k, v in out.items() if k.endswith("flat"))
    require(ties > 0, f"no tie among the least costs on flat planes: {out}")
    return {"cases": out, "mismatches": mism}


def require_cluster_launch(launch, what):
    """C14's encode launch ran its read phase on clusters: more than one
    CTA per CU (the launch's cluster dimension). That the CTAs of a cluster
    shared a CU's work, the anchors on two of them, the stage clocks show
    (require_cluster_stamps)."""
    require(launch["ctas_per_cu"] > 1,
            f"{what}: {launch['ctas_per_cu']} CTA per CU: {launch}")


def require_cluster_stamps(clk, per_cu, what, gt):
    """From the stamps clk [groups, CTAs, CLOCK_STAMPS] of one C14 encode
    (clusters of per_cu consecutive CTAs): in every group some cluster had
    more than one CTA stamp a search part (C9's displacements split) and
    more than one CTA stamp one of C10's chains (the merge, the SS and the
    temporal refinement), no CTA stamped two chains, and with the GT on
    C12's anchors ran on two CTAs: each anchor stamped in some group, and
    no CTA stamped both. Returns the two anchors' stamp counts ([0, 0]
    with the GT off)."""
    g, ctas = clk.shape[:2]
    per = lambda m: m.reshape(g, ctas // per_cu, per_cu).sum(2).max(1)
    searched = ((clk[:, :, CLOCK_SEARCH[0]] > 0)
                | (clk[:, :, CLOCK_SEARCH[1]] > 0))
    most = per(searched)
    require((most > 1).all(), f"{what}: groups whose CUs each searched on "
            f"one CTA: {np.flatnonzero(most <= 1).tolist()[:10]}")
    chains = np.stack([(clk[:, :, list(ks)] > 0).any(2)
                       for ks in CLOCK_CHAINS])
    most = per(chains.any(0))
    require((most > 1).all(), f"{what}: groups whose CUs ran C10's chains "
            f"on one CTA: {np.flatnonzero(most <= 1).tolist()[:10]}")
    two = int((chains.sum(0) > 1).sum())
    require(two == 0, f"{what}: {two} CTAs stamped two of C10's chains")
    if gt:
        a0, a1 = (clk[:, :, k] > 0 for k in CLOCK_ANCHORS)
        require(a0.any() and a1.any() and not (a0 & a1).any(),
                f"{what}: C12's anchors did not run on two CTAs "
                f"({int(a0.sum())}, {int(a1.sum())} stamps, "
                f"{int((a0 & a1).sum())} CTAs with both)")
        return [int(a0.sum()), int(a1.sum())]
    return [0, 0]


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


# The level with the most GT CUs of a path's level loop, by key: (GT CUs,
# the arguments of its ss_scan.gt_step call as they stood before the call)
GT_LEVELS = {}


def _clone_args(a):
    """A copy of a call's arguments: tensors cloned, tuples copied."""
    import torch
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, (tuple, list)):
        return type(a)(_clone_args(x) for x in a)
    return a


class _GtLevels:
    """Within it, ss_scan.gt_step keeps in GT_LEVELS[key] the call of its
    ISS form (or with ``pss`` its PSS form) that set the most GT flags (its
    in-place arguments as they stood before it)."""

    def __init__(self, key, pss=False):
        self.key, self.pss = key, pss

    def __enter__(self):
        from hevc_hop_torch.models import ss_scan
        self.saved = ss_scan.gt_step

        def call(*a, **k):
            # (..., lam, mi_size, refsel): refsel None or left out on ISS
            a = a + (k.get("refsel"),) if len(a) == 22 else a
            before = _clone_args(a[11:15] + a[22:])
            out = self.saved(*a)
            nf = int(out[0].sum())
            if ((a[22] is not None) == self.pss
                    and nf > GT_LEVELS.get(self.key, (0,))[0]):
                GT_LEVELS[self.key] = (nf, _clone_args(a[:11]) + before[:4]
                                       + a[15:22] + before[4:])
            return out

        ss_scan.gt_step = call

    def __exit__(self, *exc):
        from hevc_hop_torch.models import ss_scan
        ss_scan.gt_step = self.saved


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
    outputs. Every picture runs here through the level loop
    (scan_encode_iss_loop, scan_decode_ss_loop and their PSS forms),
    whose launches C14 replaces on the main paths; the held stream must
    equal the path's, which C14 wrote."""
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
        sargs = (recon, org, pos, zcur, zmaxw, motion, nbav, miav, n, radius,
                 w, h, lam, mi, zmax2n, ref, radius_t)
        got = orig["ps"](*sargs)
        want = ss.pss_search_plain(*sargs)
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
        with _LevelLoop():
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
    # the integer sums: bit-equal to the plain body wherever every 8-bit
    # sum stays below 2^24 (n = 8 and 16)
    for k in ("not_bit_equal_n8", "not_bit_equal_n16",
              "temporal_not_bit_equal_n8", "temporal_not_bit_equal_n16"):
        require(tally[k] == 0, f"C9 pre-pass: {k} = {tally[k]}")
    # inputs that take the float arm (sums past 2^24): a 10-bit copy of the
    # lenslet luma (and of the pss-gt pictures, with the temporal arm) and
    # a bright copy of the pss-gt pictures at 32x32, on a 512x256 corner
    y0 = ctxs["pss-gt"]["frames"][0][0]
    y1 = ctxs["pss-gt"]["frames"][1][0]
    bright = lambda a: np.clip(a // 4 + 190, 0, 255)
    lens = lenslet_frame(W, H, mi=16)[0]
    floats = {"10bit": (lens * 4 + 1, None, 10, (8, 16, 32)),
              "10bit_temporal": (y1 * 4 + 1, y0 * 4 + 2, 10, (8, 16, 32)),
              "bright_temporal": (bright(y1), bright(y0), 8, (32,))}
    for name, (yy, rr, bd, sizes) in floats.items():
        yt = torch.as_tensor(np.ascontiguousarray(yy, np.int32), device=dev)
        rt = (None if rr is None else torch.as_tensor(
            np.ascontiguousarray(rr, np.int32), device=dev))
        for n in sizes:
            ys, xs = np.mgrid[0:256:n, 0:512:n]
            ys, xs = ys.ravel(), xs.ravel()
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                          device=dev)
            args = (yt, t(np.stack([xs, ys], -1)),
                    t(zplane4[ys >> 2, xs >> 2]), t(zmax_win_px(zplane4, n)),
                    n, QP, bd, 32, W, H, 16, lam) + (
                        () if rt is None else (rt, 16))
            got = ss_partition.ss_rd_costs(*args)
            want = ss_partition.ss_rd_costs_plain(*args)
            tally[f"{name}_not_bit_equal_n{n}"] = c9.add_close(
                got, want, COST_RTOL, f"C9 pre-pass {name} n={n}")
            tally[f"{name}_causal_n{n}"] = int((want < 1e37).sum())
    log(f"C9 pre-pass entry on inputs past 2^24: {json.dumps(tally)}")
    log_host("pre-pass entries held")
    held = {}
    for name in ISS_PATHS:
        c = ctxs[name]
        with _GtLevels(name):
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
    """(plans, nsteps, zmaxw, zmax2n, C14's work list) of the partition the
    encoder coded last."""
    return enc._prep_cache[next(reversed(enc._prep_cache))]


# the K13 row's search also timed over this many times its CUs
WIDE = 16


def search_ops(pos, zcur, zmaxw, n, radius):
    """Float32 operations of the pre-pass's search (its float sums) over
    blocks pos at the causal displacements these inputs have (the kernel
    skips the others): per displacement 2 n^2 multiply-adds (correlation
    and ref^2, two operations each) and the SSE, rate and compare (about
    12 + 10 per predictor, counted as 80)."""
    import torch
    d = torch.arange(-radius, radius + 1, device=pos.device)
    ty = pos[:, 1, None, None].long() + d[None, :, None]
    tx = pos[:, 0, None, None].long() + d[None, None, :]
    inb = (ty >= 0) & (tx >= 0) & (ty + n <= H) & (tx + n <= W)
    zm = zmaxw[ty.clamp(0, H - n), tx.clamp(0, W - n)]
    causal = int((inb & (zm < zcur[:, None, None])).sum())
    return causal * (4 * n * n + 80), causal


def prepass_bytes(nb, *planes):
    """Bytes of C9's pre-pass entry over nb blocks, the least its function
    needs: each sample of the planes it reads (the original luma, zmaxw
    and on a PSS picture the previous luma) once, whatever the blocks'
    windows share, and each block's position, z address and cost."""
    return sum(p.numel() * p.element_size() for p in planes) + nb * 16


def scan_search_ops(counts, n, radius, bits=8):
    """(int32, float32, int8) operations of kernel C9's scan search
    (search_part) of the blocks whose valid displacements number counts
    [B], the least its function needs: per valid displacement corr's n^2
    multiply-adds (two operations each; int8 at 8 bit, int32 at 10 bit)
    and the SSE, rate and compare (about 12 + 10 per predictor, counted as
    80, float32); per block with one, ref^2's box sums of its squared
    window of side w = n + 2 radius (w^2 squares, then sliding sums of
    width n along the w rows and of n rows along the d = 2 radius + 1
    columns, an add and a subtract each) and org^2 (n^2 multiply-adds).
    Entries whose sums pass 2^24 and take the reference's ordered float
    form are not counted: a floor."""
    w, d = n + 2 * radius, 2 * radius + 1
    valid, live = int(counts.sum()), int((counts > 0).sum())
    corr = 2 * n * n * valid
    box = live * (w * w + 2 * w * d + 2 * d * d + 2 * n * n)
    return ((box + corr, 80 * valid, 0) if bits > 8 else
            (box, 80 * valid, corr))


def add_ops(*ops):
    """The sum of operation tuples, element by element."""
    return tuple(sum(o[k] for o in ops if k < len(o))
                 for k in range(max(len(o) for o in ops)))


def mc_ops(n, taps):
    """int32 operations of one n x n MC: two separable stages of ``taps``
    multiply-adds per sample (the first over n + taps - 1 rows), plus the
    shifts, offsets and clip (4 per sample)."""
    return 2 * taps * n * (n + taps - 1) + 2 * taps * n * n + 4 * n * n


# the standalone entries whose device code C14 runs on an ISS picture, and
# the side it runs them on: their rows on the ISS paths count C14's
# launches (the pss-gt path's PSS pictures launch the entries themselves,
# standalone_launches_by_path)
IN_C14 = {"C9 search": "encode", "C9 ring": "encode", "C10 arms": "encode",
          "C10 motion": "encode", "C8 chroma": "encode",
          "C12 search": "encode", "C12 decide": "encode",
          "C11 chroma": "encode", "C8 luma": "decode", "C11 luma": "decode"}


def _in_c14(kw):
    """A kernel row's spec, marked as run inside C14 where it is."""
    side = IN_C14.get(kw["counter"])
    if side is None or kw["path"] not in SS_PATHS:
        return kw
    return dict(kw, launched_in=f"C14 {side}",
                frame_kernel=f"ss_scan_{side}_kernel")


def _causal_counts(pos, zcur, zmaxw, n, radius):
    """[B] the causal displacements of each block (search_ops's count), in
    chunks of blocks."""
    import torch
    d = torch.arange(-radius, radius + 1, device=pos.device)
    out = []
    for i in range(0, pos.shape[0], 512):
        p, z = pos[i:i + 512], zcur[i:i + 512]
        ty = p[:, 1, None, None].long() + d[None, :, None]
        tx = p[:, 0, None, None].long() + d[None, None, :]
        inb = (ty >= 0) & (tx >= 0) & (ty + n <= H) & (tx + n <= W)
        zm = zmaxw[ty.clamp(0, H - n), tx.clamp(0, W - n)]
        out.append((inb & (zm < z[:, None, None])).flatten(1).sum(1))
    return torch.cat(out)


def _in_picture_counts(pos, n, radius):
    """[B] the displacements within radius whose n x n block lies in the
    picture (the temporal search's, which has no causal test)."""
    import torch
    d = torch.arange(-radius, radius + 1, device=pos.device)
    ty = pos[:, 1, None, None].long() + d[None, :, None]
    tx = pos[:, 0, None, None].long() + d[None, None, :]
    inb = (ty >= 0) & (tx >= 0) & (ty + n <= H) & (tx + n <= W)
    return inb.flatten(1).sum(1)


def ss_encode_work(args, outs, pss=False):
    """(bytes, (int32, float32, int8) operations) of kernel C14's encode of
    one ISS picture (``args`` scan_encode_iss's) or, with ``pss``, one PSS
    picture (``args`` scan_encode_pss's), counted on this run's data: each
    original sample (and on a PSS picture each previous-picture sample)
    read once and each recon sample and level written once, each CU's
    outputs; per CU C2's RMD or given mode, C9's sums over its causal
    displacements (scan_search_ops) and on a PSS picture over the temporal
    search's displacements in the picture, C10's 16 sub-pel MCs and their
    SSEs where a displacement was causal (and the temporal refinement's 16)
    and the intra SSE, C12's 79 warps for a CU that codes the GT (at least
    one anchor searched), the chroma prediction, and C3's luma and chroma
    work (RDOQ's where on). Merge candidates and the anchors no GT CU kept
    are not counted: a floor."""
    if pss:
        (_, _, _, _, plans, _, zmaxw, _, _, bits, _, _, _, radius, radius_t,
         _, rdoq, _, modes, _) = args
    else:
        (_, _, plans, _, zmaxw, _, _, bits, _, _, _, radius, _, rdoq, _,
         modes, _) = args
    gi = 7 if pss else 6        # the GT flag among the outputs
    nbytes, oi, of, o8 = 0, 0, 0, 0
    for lg, p in plans.items():
        n, m, t = p.n, p.n // 2, len(p.vpos)
        causal = _causal_counts(p.pos, p.zcur, zmaxw[lg], n, radius)
        live = int((causal > 0).sum())
        oi += t * (given_mode_ops(n) if modes is not None else rmd_ops(n))
        oi, of, o8 = add_ops((oi, of, o8),
                             scan_search_ops(causal, n, radius, bits))
        oi += live * 16 * mc_ops(n, 8)
        of += (t + 16 * live) * 3 * n * n
        if pss:
            oi, of, o8 = add_ops((oi, of, o8), scan_search_ops(
                _in_picture_counts(p.pos, n, radius_t), n, radius_t, bits))
            oi += t * 16 * mc_ops(n, 8)
            of += 16 * t * 3 * n * n
            nbytes += t * ((n * n + 2 * m * m) * 4 + 4)
        oi += int(outs[lg][gi].sum()) * 79 * warp_ops(n)
        oi += 2 * t * 5 * m * m
        for b, k in ((t, n), (2 * t, m)):
            ti, tf = _tq_work(b, k, rdoq)
            oi, of = oi + ti, of + tf
        nbytes += t * (n * n * 10 + 2 * m * m * 10 + 64)
    return nbytes, (oi, of, o8)


def ss_decode_work(dargs, pss=False):
    """(bytes, int32 operations) of kernel C14's decode of one ISS picture
    (``dargs`` scan_decode_ss's) or, with ``pss``, one PSS picture
    (scan_decode_pss's): each residual sample read and each recon sample
    written once, each CU's mode, MV and corners, and each
    previous-picture sample a temporal CU predicts from; per CU its
    prediction (C2's given mode, C8's MC or C11's warp with its chroma
    interpolation) and the clipped add."""
    plans, gt = (dargs[4], dargs[13]) if pss else (dargs[2], dargs[10])
    nbytes, ops = 0, 0
    for lg, p in plans.items():
        n, m, t = p.n, p.n // 2, len(p.vpos)
        intra = int(p.cnt_a.sum())
        gts = 0 if gt is None else int(gt[lg][0].sum())
        ops += intra * (given_mode_ops(n) + 2 * 5 * m * m)
        ops += (t - intra - gts) * (mc_ops(n, 8) + 2 * mc_ops(m, 4))
        ops += gts * (warp_ops(n) + 2 * (mc_ops(2 * m, 4) + warp_ops(m)))
        ops += t * 3 * (n * n + 2 * m * m)
        nbytes += t * (8 * (n * n + 2 * m * m) + 40)
        if pss:
            nbytes += int(dargs[9][lg][0].sum()) * 4 * (n * n + 2 * m * m)
    return nbytes, ops


def phase_ss_scan_timing(ss_rows, checks, launches):
    """Rows of the kernels line for C14: its encode entry on PLAIN_FULL's
    encode frame and its decode entry on PLAIN_FULL's decode frame, and
    its PSS form each way on the pss-gt path's last PSS picture, whole
    pictures, held by phase_ss_scan_program and phase_pss_scan_program,
    beside the bound of the picture's work and the card's loop's time (the
    plain loop's, at full size, comes from phase_ss_scan_plain, at the
    end)."""
    from hevc_hop_torch.models import ss_scan
    specs = []
    sides = list(PLAIN_FULL.items()) + [("encode", "pss-gt"),
                                        ("decode", "pss-gt")]
    for side, path in sides:
        r = ss_rows[path]
        pss = bool(r.get("pss"))
        if pss:
            fns = (ss_scan.scan_encode_pss, ss_scan.scan_decode_pss)
            form, tag, lines = "ss_scan_pss", "PSS ", (879, 1124)
            where = f"picture {r['poc']}"
            what = f"PSS {where}"
        else:
            fns = (ss_scan.scan_encode_iss, ss_scan.scan_decode_ss)
            form, tag, lines = "ss_scan", "", (714, 1060)
            where, what = "frame", "picture"
        if side == "encode":
            fn, a, work, line = fns[0], r["args"], r["work"], lines[0]
            nbytes, ops = ss_encode_work(a, r["c14"][4], pss)
        else:
            fn, a, work, line = fns[1], r["dargs"], r["dwork"], lines[1]
            nbytes, ops = ss_decode_work(a, pss)
        specs.append(dict(
            name=f"C14 ss_scan {tag}({side}, {path} {where})",
            counter=f"C14 {tag}{side}", path=path,
            kernel=f"{form}_{side}_kernel",
            shape=(f"{W}x{H} {what}, {len(work.host_items)} CUs in "
                   f"{len(work.host_groups)} groups, one launch"),
            source="hevc_hop_torch/csrc/ss_scan.cu",
            replaces=f"hevc_hop_tpu/models/ss_scan.py:{line}",
            fn=lambda fn=fn, a=a, w_=work: fn(*a, work=w_), plain=None,
            held=True, nbytes=nbytes, ops=ops, plain_ms=None,
            loop_ms=r["secs"][f"{side}_loop_s"] * 1e3))
    return _time_specs(specs, checks, launches)


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
        specs.append(_in_c14(kw))

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
    cnt = _causal_counts(pos, zcur, zmaxw, n, 32)
    causal = int(cnt.sum())
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
         ops=scan_search_ops(cnt, n, 32))
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
    # the same search and convolution over WIDE times the CUs (each block
    # WIDE times): a level of the wavefront holds too few CUs to fill the
    # card, and the time's growth with the count says how far the row's
    # time is latency
    wargs = (ry, oy, pos.repeat(WIDE, 1), zcur.repeat(WIDE), zmaxw, motion,
             nbav.repeat(WIDE, 1), miav.repeat(WIDE, 1)) + sargs[8:]
    wwin, wker = win.repeat(1, WIDE, 1, 1), ker.repeat(WIDE, 1, 1, 1)
    specs[-1]["wide"] = dict(
        times=WIDE, cus=WIDE * c, fn=lambda: ss.ss_search(*wargs),
        library=lambda: F.conv2d(wwin, wker, groups=WIDE * c))
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
    pcounts = _causal_counts(ppos, pz, pzm, 16, 32)
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
         nbytes=prepass_bytes(nb, yl, pzm),
         # as the K13 row counts its search (the correlation int8 on the
         # tensor cores), plus the transform round trip; the count of the
         # float-order form (every sum in float32) beside it
         ops=add_ops(scan_search_ops(pcounts, 16, 32),
                     (nb * 16 * 1024, nb * 256 * 4)),
         float_ops=(nb * 16 * 1024, pops + nb * 256 * 4))
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
         shape=f"{W}x{H} picture, three planes, one launch, the iss "
               "frame's inter maps",
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
        plans, _, zmaxws, zmax2ns = _last_prep(enc)[:4]
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
    cnt = _causal_counts(L["pos"], L["zcur"], L["zmaxw"], n, 32)
    causal = int(cnt.sum())
    wsz = n + 64
    spec = lambda **kw: specs.append(_in_c14(kw))
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
         ops=add_ops(scan_search_ops(cnt, n, 32), (0, causal * 10)))

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
    # the decide entry where GT wins: the level of iss-gt-warped's level
    # loop with the most GT CUs (phase_iss_kernels), as it stood
    spec(**_gt_level_row("iss-gt-warped", "C12 decide",
                         "hevc_hop_tpu/models/ss_scan.py:796"))
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
    forms and C12 with its PSS decide. On the path a PSS picture runs the
    scan entry's, C10's and C12's device code inside C14's PSS form, whose
    launches those rows count; the pre-pass entry launches on its own."""
    import torch
    import torch.nn.functional as F
    from hevc_hop_torch.models import partition, ss_partition, wavefront
    from hevc_hop_torch.models.ss_scan import zmax_win_px
    from hevc_hop_torch.ops import gt, inter_arms as ia
    from hevc_hop_torch.ops import ss_search as ss
    dev = torch.device("cuda")
    ctx = ctxs["pss-gt"]
    enc = ctx["enc"]
    plans, _, zmaxws, zmax2ns = _last_prep(enc)[:4]
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
    in_c14 = dict(launched_in="C14 PSS encode",
                  frame_kernel="ss_scan_pss_encode_kernel")
    spec = lambda **kw: specs.append(
        kw if kw["counter"] == "C9 prepass temporal" else dict(kw, **in_c14))
    sargs = (ry, oy, pos, zcur, zmaxw, motion, nbav, miav, n, 32, W, H, lam,
             16, zmax2n, ref, 16)
    cnt = _causal_counts(pos, zcur, zmaxw, n, 32)
    causal = int(cnt.sum())
    tcnt = _in_picture_counts(pos, n, 16)
    inpic = int(tcnt.sum())
    dt = torch.arange(-16, 17, device=dev)
    ws, wt = n + 64, n + 32

    def plain_search():
        r = ss.pss_search_plain(*sargs)
        return r[0] + r[1]

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
         ops=add_ops(scan_search_ops(cnt, n, 32),
                     scan_search_ops(tcnt, n, 16)))
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
    pcounts = _causal_counts(ppos, pz, pzm, n, 32)
    ptcounts = _in_picture_counts(ppos, n, 16)
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
         nbytes=prepass_bytes(nb, oy[:H], pzm, ref[:H]),
         # both arms as the K13 row counts its searches, plus the round trip
         ops=add_ops(scan_search_ops(pcounts, n, 32),
                     scan_search_ops(ptcounts, n, 16),
                     (nb * n * 4 * n * n, nb * n * n * 4)),
         float_ops=(nb * n * 4 * n * n, pops + pin * (4 * n * n + 80)))
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
    # the PSS decide where GT wins: the level of the mixed sequence's PSS
    # level loop with the most GT CUs (phase_pss_scan_program)
    spec(**_gt_level_row("mixed", "C12 decide PSS",
                         "hevc_hop_tpu/models/ss_scan.py:973"))
    return _time_specs(specs, checks, launches)


def _gt_level_row(key, counter, replaces):
    """The kernels line's spec of C12's decide entry on GT_LEVELS[key]: the
    recorded level's search and decide on copies of its arguments, the
    bound counted by its GT CUs (each a chroma check of cb and cr and a
    prediction copied), as the other decide rows count."""
    from hevc_hop_torch.ops import gt
    require(key in GT_LEVELS, f"C12 decide: no level of {key} set a GT flag")
    nflag, a = GT_LEVELS[key]
    c, n, pss = a[3].shape[0], a[15], a[22] is not None

    def step(fn):
        x = _clone_args(a)
        return tuple(fn(*x)) + tuple(x[11:15]) + ((x[22],) if pss else ())

    form = "PSS, " if pss else ""
    return dict(name=f"C12 gt_decide ({form}{n}x{n}, GT level)",
                counter=counter, path="pss-gt" if pss else key,
                kernel="gt_decide_kernel",
                shape=f"{c} CUs of {n}x{n}, {nflag} GT, the {key} level "
                      "with the most GT CUs",
                source="hevc_hop_torch/csrc/gt_search.cu",
                replaces=replaces, fn=lambda: step(gt.gt_step),
                plain=lambda: step(gt.gt_step_plain),
                nbytes=c * (140 if pss else 120)
                + nflag * (2 * n * n * 4 + 2 * (n + 3) ** 2 * 4),
                ops=nflag * 2 * (mc_ops(n, 4) + warp_ops(n // 2)))


# ---------------------------------------------------------------------------
# The mesh slice: MeshIntraEncoder (K19) and the sharded analysis (K20).

# the mesh-intra-1080p cell: 16x16 CUs with in-loop RMD, RDOQ, SBH and
# deblocking on, SAO off, two frames on a virtual (2 frames, 2 bands) mesh
MESH_CONFIG = dict(qp=QP, cu_log2=4, sao=False)
MESH_SHAPE = (2, 2)
MESH_SEEDS = (0, 1)
MESH_TIMED_TURNS = 3
MESH_FIXTURE = "jax_mesh_1920x1088_qp32"
# the analysis: n = 16 on the path, 4, 8 and 32 held once each
ANALYSIS_N = 16


def _mesh_fixture():
    """(streams, meta) of the committed JAX mesh fixture: the .bin holds
    the frames' streams one after the other, the .json their lengths."""
    base = os.path.join(ROOT, "tests", "torch_fixtures", MESH_FIXTURE)
    with open(base + ".bin", "rb") as f:
        blob = f.read()
    with open(base + ".json") as f:
        meta = json.load(f)
    cuts = np.cumsum([0] + meta["bytes"])
    require(cuts[-1] == len(blob), f"{MESH_FIXTURE}: .bin length")
    return [blob[a:b] for a, b in zip(cuts[:-1], cuts[1:])], meta


def _hold_mesh_launches(enc, frames, checks, every=8):
    """The mesh's level loop (C13's plain version for the mesh: C2 and C3
    launches over the stacked slabs, the halo refresh after every level)
    on the card, with its C2 and C3 launches held against the plain
    bodies on the same inputs, at the fullest level and every
    ``every``-th level (luma RMD, C3's encode in its RDOQ arm, chroma with
    the luma mode, C3's chroma encode); the loop goes on with the kernels'
    outputs. Returns (held launches per form, the loop's scan_encode
    results, and the fullest level's luma C2 and C3 arguments)."""
    import torch
    from hevc_hop_torch.models import wavefront_scan as ws
    from hevc_hop_torch.ops import intra, tq
    c2, c3 = checks["C2"], checks["C3"]
    orig = (ws.intra_blocks, ws.tq_encode)
    plans = enc._build()[1]
    fullest = {p.n: int(p.cnt.max()) for p in plans.values()}
    calls, held, box = {}, {}, {}

    def pick(kind, n, b, c_idx):
        # a chroma launch holds the cb and cr blocks of luma blocks of 2n
        k = calls[(kind, n)] = calls.get((kind, n), -1) + 1
        return b == (c_idx + 1) * fullest[n << c_idx] or k % every == 0

    def c2_held(plane, pos, avail, modes, n, c_idx, bit_depth=8,
                strong=True, org=None, resi=None):
        got = intra.intra_blocks(plane, pos, avail, modes, n, c_idx,
                                 bit_depth, strong, org=org, resi=resi)
        if pick("C2", n, pos.shape[0], c_idx):
            want = intra.intra_blocks_plain(plane, pos, avail, modes, n,
                                            c_idx, bit_depth, strong,
                                            org=org, resi=resi)
            for g, w_, part in zip(got, want, ("prediction", "modes")):
                if w_ is not None:
                    c2.add(g, w_, f"C2 mesh c_idx {c_idx} {n}x{n} {part}")
            what = "C2 luma RMD" if org is not None else "C2 chroma"
            held[what] = held.get(what, 0) + 1
            if org is not None and pos.shape[0] == fullest[n]:
                box["c2"] = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in (plane, pos, avail, modes, n,
                                            c_idx, bit_depth, strong, org))
        return got

    def c3_held(org, pred, pos, modes, n, c_idx, qp, bit_depth, sbh, rdoq,
                recon, coefp):
        if not pick("C3", n, pos.shape[0], c_idx):
            return tq.tq_encode(org, pred, pos, modes, n, c_idx, qp,
                                bit_depth, sbh, rdoq, recon, coefp)
        rp, cp = recon.clone(), coefp.clone()
        if c_idx == 0 and pos.shape[0] == fullest[n]:
            box["c3"] = (org.clone(), pred.clone(), pos.clone(),
                         modes.clone(), n, c_idx, qp, bit_depth, sbh, rdoq)
        want = tq.tq_encode_plain(org, pred, pos, modes, n, c_idx, qp,
                                  bit_depth, sbh, rdoq, rp, cp)
        got = tq.tq_encode(org, pred, pos, modes, n, c_idx, qp, bit_depth,
                           sbh, rdoq, recon, coefp)
        chk = checks["C7"] if rdoq else c3
        for g, w_, part in ((got, want, "cbf"), (recon, rp, "recon"),
                            (coefp, cp, "levels")):
            chk.add(g, w_, f"C3 mesh c_idx {c_idx} {n}x{n} encode {part}")
        what = f"C3 encode{' (RDOQ)' if rdoq else ''} " + (
            "chroma" if c_idx else "luma")
        held[what] = held.get(what, 0) + 1
        return got

    args, kws, refresh = _mesh_scan_args(enc, frames)
    ws.intra_blocks, ws.tq_encode = c2_held, c3_held
    try:
        loop = ws.scan_encode_loop(*args, **kws, after_level=refresh)
        torch.cuda.synchronize()
    finally:
        ws.intra_blocks, ws.tq_encode = orig
    return held, loop, box


def _scan_blocks(plans):
    """(luma size, luma blocks, chroma size, chroma blocks of cb and cr)
    of every level and size of a schedule's packed plans."""
    for p in plans.values():
        nc = 4 if p.n == 4 else p.n // 2
        for c, cc in zip(p.cnt, p.ccnt):
            if c:
                yield p.n, int(c), nc, 2 * int(cc)


def _tq_work(b, m, use_rdoq):
    """(int32, float32) operations of C3's encode work on b blocks of m x m
    (its RDOQ arm's, with ``use_rdoq``)."""
    if not use_rdoq:
        return b * tq_encode_ops(m), 0
    ri, rf = rdoq_ops(m)
    return b * (tq_encode_ops(m) - 7 * m * m + ri), b * rf


def level_loop_bound(plans, use_rdoq, rmd=True):
    """Least time (ms) of a level loop's C2 and C3 launches: for every
    level and size, the bound of its luma prediction (RMD, or the given
    mode), luma encode, chroma prediction and chroma encode launches
    (each the larger of its bytes and its operations, counted as the
    kernel rows count them), summed."""
    total = 0.0
    for n, c, nc, cc in _scan_blocks(plans):
        launches = [
            (c * (4 * n * n * 2 + 4 * (4 * n + 1) + 4 * n + 1 + 16),
             c * rmd_ops(n)) if rmd else
            (c * (4 * n * n + 4 * (4 * n + 1) + 4 * n + 1 + 12),
             c * given_mode_ops(n)),
            (c * (n * n * (4 + 4 + 4 + 2) + 16), _tq_work(c, n, use_rdoq))]
        if cc:
            # chroma: one prediction, no reference smoothing
            launches += [
                (cc * (4 * nc * nc + 4 * (4 * nc + 1) + 4 * nc + 1 + 12),
                 cc * 5 * nc * nc),
                (cc * (nc * nc * (4 + 4 + 4 + 2) + 16),
                 _tq_work(cc, nc, use_rdoq))]
        total += sum(bound(nb, ops)[0] for nb, ops in launches)
    return total


def scan_bound(plans, use_rdoq, rmd=True, decode=False):
    """(least ms, what bounds it) of kernel C13's whole frame."""
    return bound(*scan_work(plans, use_rdoq, rmd, decode))


def scan_work(plans, use_rdoq, rmd=True, decode=False):
    """(bytes, (int32, float32) operations) of kernel C13's whole frame:
    the bytes it must move (each original and residual sample read once, each recon
    sample and level written once, each block's chain, availability,
    position, mode and cbf once; the prediction never leaves the SM) and
    the operations of its blocks' work, counted as level_loop_bound
    counts them, in one sum each."""
    nbytes, ops_i, ops_f = 0, 0, 0
    for n, c, nc, cc in _scan_blocks(plans):
        for b, m, luma in ((c, n, True), (cc, nc, False)):
            if not b:
                continue
            chain = 4 * (4 * m + 1) + 4 * m + 1 + 16
            nbytes += b * (m * m * (4 + 4 + (0 if decode else 2)) + chain)
            if decode:
                ops_i += b * (given_mode_ops(m) + 3 * m * m)
                continue
            if luma:
                ops_i += b * (rmd_ops(m) if rmd else given_mode_ops(m))
            else:
                ops_i += b * 5 * m * m
            ti, tf = _tq_work(b, m, use_rdoq)
            ops_i, ops_f = ops_i + ti, ops_f + tf
    return nbytes, (ops_i, ops_f)


def phase_mesh(checks):
    """The mesh-intra-1080p path: MeshIntraEncoder on a virtual (2, 2)
    mesh on the card and analysis_step_sharded, with every launch count
    set to 0 just before and read just after; checks, held launches, the
    (1, 17) mesh, the timed turns against the single-device encoder, the
    profiles and the analysis at every block size. Returns (path entry,
    kernel specs' context)."""
    import torch
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_torch.parallel import mesh as pmesh
    from hevc_hop_torch.parallel import shard_encode
    t_start = time.perf_counter()
    cfg = EncoderConfig(width=W, height=H, **MESH_CONFIG)
    frames = [synth_class_b(W, H, seed=s) for s in MESH_SEEDS]
    mesh = shard_encode.make_mesh(MESH_SHAPE[0] * MESH_SHAPE[1],
                                  band_par=MESH_SHAPE[1])
    require(mesh.virtual and mesh.shape == MESH_SHAPE
            and mesh.device.type == "cuda", f"mesh {mesh}")
    enc = shard_encode.MeshIntraEncoder(cfg, mesh)
    amesh = pmesh.make_mesh(4, row_par=2)
    require(amesh.virtual and amesh.shape == (2, 2), f"analysis mesh")
    aframes = torch.as_tensor(np.stack([f[0] for f in frames])).to(
        amesh.device)
    counters = _counters()
    for _, m, attr in counters:
        setattr(m, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = enc.encode_frames(frames)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    coded = {k: getattr(m, attr) for k, m, attr in counters}
    cost, mode = pmesh.analysis_step_sharded(aframes, amesh, ANALYSIS_N)
    torch.cuda.synchronize()
    launches = {k: getattr(m, attr) for k, m, attr in counters}
    log(f"mesh path launches: {launches}")
    needed = ("C1", "C13 encode", "C4", "C2 analysis")
    require(all(launches[k] > 0 for k in needed),
            f"a kernel was not launched on the mesh path: {launches}")
    # K19: the two frames' wavefront is one launch of C13's banded form
    require(coded["C13 encode"] == 1 and all(
        coded[k] == 0 for k in LOOP_KERNELS),
        f"mesh encode_frames: not one C13 launch alone: {coded}")
    require(coded["C4"] == len(frames),
            f"mesh encode_frames: not one C4 launch a frame: {coded}")
    require(tuple(cost.shape) == (2, H // ANALYSIS_N, W // ANALYSIS_N)
            and int(mode.min()) >= 0 and int(mode.max()) <= 34,
            "analysis output")
    recons = [tuple(p.cpu().numpy() for p in r) for r in enc.last_recons]
    # the single-device encoder, the decoder and the JAX fixture
    single = IntraEncoder(cfg)
    fx, meta = _mesh_fixture()
    require(meta["config"]["cu_log2"] == cfg.cu_log2
            and meta["seeds"] == list(MESH_SEEDS)
            and meta["mesh"] == list(MESH_SHAPE), "fixture configuration")
    psnr = []
    for f, frame in enumerate(frames):
        require(single.encode_frame(*frame) == streams[f],
                f"mesh frame {f}: differs from the single-device stream")
        require(streams[f] == fx[f], f"mesh frame {f}: differs from "
                f"{MESH_FIXTURE} ({len(streams[f])} and {len(fx[f])} bytes)")
        dec = Decoder()
        (pic,) = dec.decode_stream(streams[f])
        require(dec.hash_ok == [True], f"mesh frame {f}: hash_ok")
        md5 = {k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
               for k, p in zip(("y", "cb", "cr"), pic)}
        require(md5 == meta["md5"][f], f"mesh frame {f}: MD5s {md5}")
        for a, b, nm in zip(pic, recons[f], ("y", "cb", "cr")):
            require(np.array_equal(a, b), f"mesh frame {f}: decoded {nm} "
                    "!= last_recons")
        psnr.append(float(10 * np.log10(255.0 ** 2 / max(np.mean(
            (recons[f][0].astype(np.float64) - frame[0]) ** 2), 1e-9))))
    log(f"mesh: both streams equal the single-device encoder's and "
        f"{MESH_FIXTURE} byte for byte; decoded with hash_ok")
    # a halo every second CTU row
    m17 = shard_encode.make_mesh(17, band_par=17)
    s17 = shard_encode.MeshIntraEncoder(cfg, m17).encode_frames(frames[:1])
    require(s17[0] == streams[0], "the (1, 17) mesh's stream differs")
    log("mesh: the (1, 17) mesh writes frame 0's stream")
    # the level loop, its launches held
    held, loop, box = _hold_mesh_launches(enc, frames, checks)
    require(all(held.get(k, 0) > 0 for k in (
        "C2 luma RMD", "C2 chroma", "C3 encode (RDOQ) luma",
        "C3 encode (RDOQ) chroma")) and "c2" in box and "c3" in box,
            f"mesh launch forms never held: {held}")
    log(f"mesh: held launches {held}")
    # C13's banded form against the level loop on the card (its C2 and C3
    # launches, the halo refresh after every level), and the plain loop
    banded = _mesh_scan(enc, frames, checks, loop)
    log(f"mesh: C13's banded form equals the level loop: "
        f"{json.dumps(banded)}")
    # the analysis at every block size, kernel against plain body; at 10
    # bit (the frames times 4 plus seeded noise below 4) at 16 and 32
    halo = pmesh.band_halos(aframes, H // 2, 8)
    noise = np.random.default_rng(7).integers(0, 4, tuple(aframes.shape))
    a10 = (aframes * 4 + torch.as_tensor(noise, dtype=torch.int32).to(
        aframes.device)).contiguous()
    a_held = {}
    for bd, f_, ns in ((8, aframes, (4, 8, 16, 32)), (10, a10, (16, 32))):
        h_ = pmesh.band_halos(f_, H // 2, bd)
        for n in ns:
            got = pmesh.analysis_blocks(f_, h_, H // 2, n, bd)
            want = pmesh.analysis_blocks_plain(f_, h_, H // 2, n, bd)
            for g, w_, part in zip(got, want, ("cost", "mode")):
                checks["C2"].add(g, w_, f"C2 analysis {n}x{n} {bd} bit "
                                 f"{part}")
            a_held[f"{n}x{n} {bd} bit"] = int(got[0].numel())
    log(f"mesh: C2's analysis entry held at n = 4-32, and at 16 and 32 "
        f"at 10 bit ({a_held} blocks)")
    # timed turns: the mesh's two frames, then the single device's
    mesh_s, single_s, probes = [], [], []
    for _ in range(MESH_TIMED_TURNS):
        probes.append(host_probes())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = enc.encode_frames(frames)
        torch.cuda.synchronize()
        mesh_s.append((time.perf_counter() - t0) / len(frames))
        require(out == streams, "a later mesh encode differs")
        for frame in frames:
            t0 = time.perf_counter()
            single.encode_frame(*frame)
            torch.cuda.synchronize()
            single_s.append(time.perf_counter() - t0)
    lay, plans, _, nsteps, _ = enc._build()
    sched = single._schedule(single._decide(None)[0])
    out = {"frame": f"{W}x{H}", "qp": QP, "config": MESH_CONFIG,
           "mesh": list(MESH_SHAPE), "frames": len(frames),
           "content": [f"synth_class_b({W}, {H}, seed={s})"
                       for s in MESH_SEEDS],
           "wavefront_levels": nsteps,
           "c13_launches_per_encode": coded["C13 encode"],
           "c13_banded": banded,
           "c13_bound_ms": scan_bound(plans, cfg.rdoq)[0],
           "bytes": [len(s) for s in streams], "y_psnr_db": psnr,
           "first_encode_s": first_s, "timed_turns": MESH_TIMED_TURNS,
           "mesh_encode_s_per_frame": float(np.median(mesh_s)),
           "mesh_encode_s_per_frame_max": max(mesh_s),
           "single_encode_s_per_frame": float(np.median(single_s)),
           "single_encode_s_per_frame_max": max(single_s),
           "python_probe_ms": float(np.median([p[0] for p in probes])),
           "launch_probe_ms": float(np.median([p[1] for p in probes])),
           "held": held, "analysis_held_blocks": a_held,
           "level_loop_bound_ms": {
               "mesh_2_frames": level_loop_bound(plans, cfg.rdoq),
               "single_frame": level_loop_bound(sched.plans, cfg.rdoq)},
           "launches": launches,
           "phase_s": time.perf_counter() - t_start}
    log(f"mesh path: {json.dumps(out)}")
    return out, dict(enc=enc, single=single, frames=frames, box=box,
                     aframes=aframes, amesh=amesh, halo=halo, banded=banded)


def _mesh_scan_args(enc, frames):
    """(args, kwargs) of scan_encode for the mesh's stacked slabs, and the
    level loop's halo refresh."""
    from hevc_hop_torch.common import rom
    lay, plans, _, nsteps, _ = enc._build()
    cfg = enc.cfg
    org_y, org_c = enc.slabs(frames, lay)
    args = (org_y, org_c, plans, nsteps, cfg.qp,
            rom.chroma_qp_from_luma(cfg.qp), cfg.bit_depth,
            cfg.strong_intra_smoothing, cfg.sbh, None)
    kws = dict(use_rdoq=cfg.rdoq, init_type=2)
    return args, kws, enc._halo_refresh(lay)


def _mesh_scan(enc, frames, checks, want):
    """C13's banded form on the mesh's two frames against its plain
    version, the level loop with the halo refresh after every level, on
    the card's kernels (C2, C3: ``want``, _hold_mesh_launches's run) and
    on the plain bodies: recon, levels, modes and cbfs bit for bit. Times:
    the banded launch (CUDA events), the loop of kernels and the plain
    loop (once each, host clock)."""
    import torch
    from hevc_hop_torch.models import wavefront_scan as ws
    args, kws, refresh = _mesh_scan_args(enc, frames)
    lay, plans = enc._build()[:2]
    work, halo = enc._banded_work(lay, plans)
    got = ws.scan_encode(*args, **kws, work=work, halo=halo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ws.scan_encode_loop(*args, **kws, after_level=refresh)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = ws.scan_encode_loop(*args, **kws, after_level=refresh,
                                plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for ref, what in ((want, "level loop"), (plain, "plain loop")):
        for g, w_, nm in zip(got[:4], ref[:4], ("recon y", "recon c",
                                                "levels y", "levels c")):
            checks["C13"].add(g, w_, f"C13 banded {nm} against the {what}")
        for log2 in ref[4]:
            for g, w_, nm in zip(got[4][log2], ref[4][log2],
                                 ("modes", "cbf y", "cbf c")):
                checks["C13"].add(g, w_, f"C13 banded {nm} {1 << log2} "
                                  f"against the {what}")
    ev = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ws.scan_encode(*args, **kws, work=work, halo=halo)
        b.record()
        torch.cuda.synchronize()
        ev.append(a.elapsed_time(b))
    return {"items": len(work.host_items),
            "levels": len(work.host_off) - 1, "widest": work.widest,
            "halo_writes": int((halo >= 0).sum()),
            "launch": list(ws.LAST_LAUNCH), "banded_ms": float(
                np.median(ev)), "loop_s": loop_s, "plain_loop_s": plain_s}


def phase_mesh_profile(ctx):
    """torch.profiler over the mesh path, with the other paths' profiles,
    each after a warm-up trace: "encode" the mesh's two frames, "single"
    the same two frames on the single-device encoder, "analysis"
    analysis_step_sharded at n = 16."""
    from hevc_hop_torch.parallel import mesh as pmesh
    enc, single, frames = ctx["enc"], ctx["single"], ctx["frames"]
    _profile(lambda: enc.encode_frames(frames))    # warms the tracer up
    out = {"encode": _profile(lambda: enc.encode_frames(frames)),
           "single": _profile_holding(
               lambda: [single.encode_frame(*f) for f in frames],
               "scan_encode_kernel", len(frames), "mesh single"),
           "analysis": _profile_holding(
               lambda: pmesh.analysis_step_sharded(
                   ctx["aframes"], ctx["amesh"], ANALYSIS_N),
               "analysis_kernel", 1, "mesh analysis")}
    log(f"profile mesh: {json.dumps(out)}")
    return out


def phase_mesh_timing(ctx, checks, launches):
    """Rows of the mesh path's kernels: C13's banded form on the two
    frames (the path's one launch; plain: the plain level loop); C2's RMD
    and C3's encode (RDOQ arm), whose device code runs in it, at the
    fullest stacked level of the (2, 2) mesh's level loop (every frame and
    band of the level in one launch), and C2's analysis entry on the two
    frames at n = 16."""
    import torch
    from hevc_hop_torch.models import wavefront_scan as ws
    from hevc_hop_torch.ops import intra, tq
    from hevc_hop_torch.parallel import mesh as pmesh
    specs = []
    enc, bd = ctx["enc"], ctx["banded"]
    margs, mkws, _ = _mesh_scan_args(enc, ctx["frames"])
    lay, mplans = enc._build()[:2]
    work, halo_t = enc._banded_work(lay, mplans)
    nbm, opsm = scan_work(mplans, enc.cfg.rdoq)
    specs.append(dict(
        name="C13 scan (encode, mesh banded form)", counter="C13 encode",
        path="mesh", kernel="scan_encode_kernel",
        shape=f"2 frames x 2 bands of {W}x{H} stacked, {bd['items']} "
              f"blocks in {bd['levels']} levels, one launch, in-loop RMD, "
              f"RDOQ, {bd['halo_writes']} halo rows written by their "
              "blocks",
        source="hevc_hop_torch/csrc/scan.cu",
        replaces="hevc_hop_tpu/parallel/shard_encode.py:106",
        fn=lambda: ws.scan_encode(*margs, **mkws, work=work, halo=halo_t),
        plain=None, held=True, plain_ms=bd["plain_loop_s"] * 1e3,
        loop_ms=bd["loop_s"] * 1e3, nbytes=nbm, ops=opsm))
    in_c13 = dict(launched_in="C13 encode", frame_kernel="scan_encode_kernel")
    plane, pos, avail, modes, n, c_idx, bdep, strong, org = ctx["box"]["c2"]
    c = pos.shape[0]
    specs.append(dict(
        name="C2 intra (RMD, mesh)", counter="C2", path="mesh",
        kernel="intra_kernel",
        shape=f"{c} luma blocks of {n}x{n} of 2 frames x 2 bands, RMD",
        source="hevc_hop_torch/csrc/intra.cu",
        replaces="hevc_hop_tpu/parallel/shard_encode.py:106",
        fn=lambda: intra.intra_blocks(plane, pos, avail, modes, n, 0, bdep,
                                      strong, org=org),
        plain=lambda: intra.intra_blocks_plain(plane, pos, avail, modes, n,
                                               0, bdep, strong, org=org),
        nbytes=c * (4 * n * n * 2 + 4 * (4 * n + 1) + 4 * n + 1 + 16),
        ops=c * rmd_ops(n), **in_c13))
    a = ctx["box"]["c3"]
    bufs = {k: (torch.zeros(a[0].shape, dtype=torch.int32,
                            device=a[0].device),
                torch.zeros(a[0].shape, dtype=torch.int16,
                            device=a[0].device)) for k in ("k", "p")}
    ri, rf = rdoq_ops(a[4])
    c3n = a[2].shape[0]
    specs.append(dict(
        name="C3 tq (encode, RDOQ, mesh)", counter="C3 encode (RDOQ)",
        path="mesh", kernel="tq_encode_rdoq_kernel",
        shape=f"{c3n} luma blocks of {a[4]}x{a[4]} of 2 frames x 2 bands, "
              "RDOQ arm",
        source="hevc_hop_torch/csrc/tq.cu",
        replaces="hevc_hop_tpu/parallel/shard_encode.py:106",
        fn=lambda: (tq.tq_encode(*a, *bufs["k"]), *bufs["k"]),
        plain=lambda: (tq.tq_encode_plain(*a, *bufs["p"]), *bufs["p"]),
        nbytes=c3n * (a[4] * a[4] * (4 + 4 + 4 + 2) + 16),
        ops=(c3n * (tq_encode_ops(a[4]) - 7 * a[4] * a[4] + ri),
             c3n * rf), **in_c13))
    fr, halo = ctx["aframes"], ctx["halo"]
    nb = fr.shape[0] * (H // ANALYSIS_N) * (W // ANALYSIS_N)
    specs.append(dict(
        name="C2 intra (analysis)", counter="C2 analysis", path="mesh",
        kernel="analysis_kernel",
        shape=f"2 frames of {W}x{H} in 2 row bands, {nb} blocks of "
              f"{ANALYSIS_N}x{ANALYSIS_N}",
        source="hevc_hop_torch/csrc/intra.cu",
        replaces="hevc_hop_tpu/parallel/mesh.py:86",
        fn=lambda: pmesh.analysis_blocks(fr, halo, H // 2, ANALYSIS_N),
        plain=lambda: pmesh.analysis_blocks_plain(fr, halo, H // 2,
                                                  ANALYSIS_N),
        # a block's work is RMD's, on a chain read straight from the frame
        nbytes=4 * fr.numel() + 4 * halo.numel() + 8 * nb,
        ops=nb * rmd_ops(ANALYSIS_N)))
    return _time_specs(specs, checks, launches)


KERNELS = ("checksum_kernel", "intra_kernel", "tq_encode_kernel",
           "tq_encode_rdoq_kernel", "tq_decode_kernel", "rdoq_quant_kernel",
           "deblock_kernel", "partition_rd_kernel",
           "partition_decide_kernel", "sao_stats_kernel", "sao_apply_kernel",
           "mc_kernel", "ss_search_kernel", "ss_rd_kernel",
           "inter_arms_kernel", "motion_write_kernel", "warp_kernel",
           "gt_pred_kernel", "gt_search_kernel", "gt_decide_kernel",
           "analysis_kernel", "scan_encode_kernel", "scan_decode_kernel",
           "ss_scan_encode_kernel", "ss_scan_decode_kernel",
           "ss_scan_pss_encode_kernel", "ss_scan_pss_decode_kernel")


def _is_kernel(key, name):
    """Whether a profiler key names the kernel ``name``: it holds the name,
    and no longer name of KERNELS that holds this one (C13's
    scan_encode_kernel is a part of C14's ss_scan_encode_kernel)."""
    return name in key and not any(
        o != name and name in o and o in key for o in KERNELS)


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
    busy, records = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is not None and \
                "CUDA" not in str(e.device_type):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        busy += dt
        records += e.count if dt else 0
        for k in per:
            if _is_kernel(e.key, k):
                per[k] += dt
                calls[k] += e.count
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1 - busy / 1e3 / (wall * 1e3)
                                  if busy else None),
            "kernel_ms": {k: v / 1e3 for k, v in per.items()},
            "kernel_calls": calls, "device_records": records}


def _profile_holding(fn, kernel, n, what, tries=3):
    """_profile(fn) from the first of ``tries`` traces, after a warm-up
    one, that holds the ``n`` records of ``kernel`` fn launches (a frame's
    scan kernel, whose record the idle share needs); the run fails if none
    does. (The first trace of a kernel pays the tracer's set-up for it,
    which can triple a frame's wall time.)"""
    _profile(fn)
    for t in range(1, tries + 1):
        prof = _profile(fn)
        if prof["kernel_calls"][kernel] == n:
            return prof
        log(f"profile {what}: trace {t} holds {prof['kernel_calls'][kernel]}"
            f" of {n} records of {kernel}; traced again")
    require(False, f"profile {what}: no complete trace in {tries} tries")


def phase_profile(name, ctx):
    """One encode and one decode of a main path's frame, each under
    torch.profiler: the card's idle share of each, and each kernel's
    device time (C2's sums every C2 launch: RMD, chroma, decode). On the
    PSS path the encode is its first PSS picture's (after the ISS one,
    untraced) and the decode the whole sequence's. A trace must hold the
    record of the frame's scan kernel (C13's or C14's launch)."""
    from hevc_hop_torch.models.decoder import Decoder
    enc, frame = ctx["enc"], ctx["frame"]
    stem = "scan" if name in PATHS else "ss_scan"
    box = {}
    if "frames" in ctx:
        # the first trace warms the tracer up; a trace must hold the record
        # of the PSS picture's C14 launch
        for t in range(4):
            enc.encode_frame(*ctx["frames"][0])
            out = {"encode": _profile(lambda: enc._encode_pss(*frame, 1))}
            calls = out["encode"]["kernel_calls"]["ss_scan_pss_encode_kernel"]
            if t and calls == 1:
                break
            log(f"profile {name} encode: trace {t} holds {calls} records of "
                "ss_scan_pss_encode_kernel")
        else:
            require(False, f"profile {name} encode: no complete trace")
        box["s"] = ctx["stream"]
    else:
        out = {"encode": _profile_holding(
            lambda: box.setdefault("s", enc.encode_frame(*frame)),
            f"{stem}_encode_kernel", 1, f"{name} encode")}
    out["decode"] = _profile_holding(
        lambda: Decoder().decode_stream(box["s"]), f"{stem}_decode_kernel",
        1, f"{name} decode")
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
                                   "C7", "C8", "C9", "C10", "C11", "C12",
                                   "C13", "C14")}
    phase_kernels(checks)
    phase_rdoq(checks)
    phase_interp(checks)
    phase_warp(checks)
    c9_split = phase_c9_split(checks)
    arms_exact = phase_arms_exact(checks)
    ps = phase_partition_sao(checks)
    phase_loopfilter(checks)
    phase_checksum_decide(checks)
    log_host("kernels held")
    paths, ctxs = {}, {}
    for name in PATHS:
        paths[name], ctxs[name] = phase_main_path(name, checks)
        log_host(f"{name} path timed")
    encode_frames = phase_encode_frames()
    log_host("encode_frames held")
    scan_program, scan_rows = phase_scan_program(ctxs, checks)
    log_host("scan program held")
    for name, (*_, content) in ISS_PATHS.items():
        run = phase_pss_path if content == "panned" else phase_iss_path
        paths[name], ctxs[name] = run(name, checks)
        log_host(f"{name} path timed")
    ss_scan_program, ss_rows = phase_ss_scan_program(ctxs, checks)
    log_host("ss scan program held")
    ss_scan_program["pss-gt"], ss_rows["pss-gt"] = phase_pss_scan_program(
        ctxs, checks)
    log_host("pss scan program held")
    stage_clock = phase_stage_clock(ss_rows, checks)
    scan_clock = phase_scan_clock(scan_rows, checks)
    log_host("stage clocks read")
    paths["mesh"], mesh_ctx = phase_mesh(checks)
    log_host("mesh path timed")
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
    # Every profiler trace comes from here on. A trace taken long after a
    # process's first one, with many launches between, can lack kernel
    # records, so the traces come last and together, the frames' profiles
    # and C14's device times first.
    for name in ctxs:
        paths[name]["profile"] = phase_profile(name, ctxs[name])
    paths["mesh"]["profile"] = phase_mesh_profile(mesh_ctx)
    phase_ss_scan_device(ss_scan_program, ss_rows)
    log_host("profiles taken")
    launches = {k: v["launches"] for k, v in paths.items()}
    rows = (phase_timing(ctxs, ps, checks, launches, scan_rows)
            + phase_iss_timing(ctxs, checks, launches)
            + phase_gt_timing(ctxs, checks, launches)
            + phase_pss_timing(ctxs, checks, launches)
            + phase_ss_scan_timing(ss_rows, checks, launches)
            + phase_mesh_timing(mesh_ctx, checks, launches))
    log_host("kernel rows timed")
    ss_plain = phase_ss_scan_plain(ctxs, ss_rows, checks)
    for r in rows:
        if r["kernel"].startswith("ss_scan_"):
            side = "encode" if "encode" in r["kernel"] else "decode"
            r["plain_ms"] = ss_plain[r["path"]][f"{side}_plain_s"] * 1e3
    for r in rows:
        # C7's frame time is that of the arm it runs in, transforms included
        k = r.get("frame_kernel", r["kernel"])
        r["frame_ms"] = {
            name: {side: prof[side]["kernel_ms"][k]
                   if prof[side]["device_busy_ms"] else None
                   for side in ("encode", "decode") if side in prof}
            for name, prof in ((n, paths[n]["profile"]) for n in paths)}
    log_host("end")
    log(card)
    total_s = time.perf_counter() - T_START
    log(f"chip_smoke: {total_s:.1f} s in all")
    log(json.dumps({"main_paths": paths, "total_s": total_s, "cli_s": cli_s,
                    "cli_holo_s": cli_holo_s, "card": card,
                    "iss_prepass_check": iss_prepass, "bdrate": bdrate,
                    "gt_share": gt_share, "scan_program": scan_program,
                    "ss_scan_program": ss_scan_program,
                    "ss_scan_plain": ss_plain, "stage_clock": stage_clock,
                    "scan_clock": scan_clock,
                    "c9_split": c9_split, "arms_exact": arms_exact,
                    "full_fixtures": full_fixtures,
                    "encode_frames": encode_frames}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
