"""The parallel forms of kernels C13 and C5 and of their shared bodies, on
the CPU, against the JAX package.

C13 (csrc/scan.cu) runs an item's luma, cb and cr on three CTAs where the
modes are given, and splits the 35-mode RMD over a cluster of CTAs
(merged by the lowest (SATD, mode)) where they are not; C5
(csrc/partition.cu) sums a block's SSE as an exact integer below 2^24 and
in the compiled reference's order above, and adds only the nonzero
levels' rate terms; RDOQ (csrc/rdoq.cuh) spreads
the blocks of its ordered float sums over threads and picks the last
position's CG by a warp argmin; intra_block (csrc/intra.cuh) substitutes
the reference chain by a max-scan over warps. None of that runs here, so
each is emulated in plain numpy or torch, in the kernel's order, and held
against the JAX reference bit for bit (C5's costs, whose log2 differs from
the reference's, within tests/test_torch_partition.py's tolerance, bit for
bit on 10-bit noise, and bit for bit against the port's plain body).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_scan_program as tsp
from chip_smoke import rdoq_coefs
from hevc_hop_tpu.models import partition as jpart
from hevc_hop_tpu.ops import intra as jintra
from hevc_hop_tpu.ops import rdoq as jrdoq
from hevc_hop_torch.models import partition as tpart
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.ops import intra as tintra
from hevc_hop_torch.ops import quant, rdoq
from hevc_hop_torch.ops.intra import intra_blocks_plain
from hevc_hop_torch.ops.tq import tq_encode_plain

# csrc/scan.cu kCluster: the RMD's parts
CLUSTER = 8
COST_RTOL = 1e-6
T = lambda a: torch.as_tensor(np.asarray(a))
f32 = np.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one thread, so the suite's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The RMD split and the chain substitution (intra.cuh, scan.cu).
# ---------------------------------------------------------------------------

def split_rmd(satds, parts):
    """The mode C13's cluster picks: each of ``parts`` CTAs walks its modes
    [r * 35 / parts, (r + 1) * 35 / parts) keeping a strictly lower SATD,
    then the lowest (SATD, mode) over the CTAs."""
    best = None
    for r in range(parts):
        m0, m1 = r * 35 // parts, (r + 1) * 35 // parts
        cost, mode = 0x7FFFFFFF, m0
        for m in range(m0, m1):
            if satds[m] < cost:
                cost, mode = satds[m], m
        best = (cost, mode) if best is None else min(best, (cost, mode))
    return best[1]


def _tie_plane(kind, h, w):
    ramp = (np.arange(max(h, w)) * 37 % 200 + 20).astype(np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    return {"flat": np.full((h, w), 128, np.int32),
            "columns": np.broadcast_to(ramp[None, :w], (h, w)).copy(),
            "rows": np.broadcast_to(ramp[:h, None], (h, w)).copy(),
            "diagonal": ((xx + yy) % 8 * 20 + 40).astype(np.int32)}[kind]


@pytest.mark.parametrize("parts", [2, 5, 8])
@pytest.mark.parametrize("kind", ["flat", "columns", "rows", "diagonal"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rmd_split_equals_the_serial_rmd(n, kind, parts):
    """On planes where many modes tie on SATD, the parts' merge picks the
    mode that JAX's argmin over the 35 SATDs picks, and the port's SATDs
    are the reference's."""
    y = _tie_plane(kind, 64, 64)
    yt = torch.as_tensor(y)
    idx = torch.arange((64 // n) ** 2)
    chains, blocks = tpart._chains(yt, idx, n, 8)
    got = tintra.satd(blocks[:, None], tintra.predict_all_modes(
        chains, n, 0, 8, False)).numpy()
    jc, jb = jnp.asarray(chains.numpy()), jnp.asarray(blocks.numpy())
    want = np.asarray(jintra.satd(jb[:, None], jintra.predict_all_modes(
        jc, n, 0, 8, False)))
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jnp.argmin(jnp.asarray(want), axis=1))
    np.testing.assert_array_equal([split_rmd(s, parts) for s in got], ref)
    ties = (np.sort(got, 1)[:, 0] == np.sort(got, 1)[:, 1])
    assert ties.any(), "the case should hold ties on the lowest SATD"


def scan_substitute(chain, avail, bit_depth, threads):
    """intra.cuh substitute_chain on one chain: per chunk of ``threads``
    samples an inclusive max-scan of (avail ? i : -1) within each warp,
    raised by the earlier warps' totals and the earlier chunks' carry;
    then each unavailable sample takes the sample at its scan value, or the
    first available one, or mid-grey."""
    L = len(chain)
    src = np.full(L, -1, np.int64)
    carry, first = -1, L
    for base in range(0, L, threads):
        v = np.array([i if i < L and avail[i] else -1
                      for i in range(base, base + threads)])
        first = min([first] + [i for i in range(base, min(base + threads, L))
                               if avail[i]])
        w = v.reshape(-1, 32)
        scan = np.maximum.accumulate(w, axis=1)
        tot = scan[:, -1]
        pre = np.maximum(carry, np.concatenate(
            [[-1], np.maximum.accumulate(tot)[:-1]]))
        out = np.maximum(scan, pre[:, None]).reshape(-1)
        src[base:min(base + threads, L)] = out[:min(threads, L - base)]
        carry = out[-1]
    res = chain.copy()
    for i in range(L):
        if not avail[i]:
            res[i] = (1 << (bit_depth - 1) if first >= L
                      else chain[src[i] if src[i] >= 0 else first])
    return res


@pytest.mark.parametrize("threads", [32, 64, 256])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_scan_substitution_equals_reference(n, threads):
    """The max-scan substitution equals JAX's substitute_refs on random
    availability, none available, only the last, only the first."""
    rng = np.random.default_rng(n * 1000 + threads)
    L = 4 * n + 1
    chains = rng.integers(0, 1024, (40, L)).astype(np.int32)
    avail = rng.random((40, L)) < rng.uniform(0.05, 0.9, (40, 1))
    avail[0] = False
    avail[1] = False
    avail[1, -1] = True
    avail[2] = False
    avail[2, 0] = True
    want = np.asarray(jintra.substitute_refs(jnp.asarray(chains),
                                             jnp.asarray(avail), 10))
    got = np.stack([scan_substitute(c, a, 10, threads)
                    for c, a in zip(chains, avail)])
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# C13's walk with the planes as separate tasks.
# ---------------------------------------------------------------------------

def _walk_encode(c, reverse):
    """C13's encode entry on the plain bodies, as its CTAs split the work:
    with the modes given, per level every item's luma task, then every
    cb task, then every cr task (reversed: the other way round); with the
    RMD, per item the split RMD's mode, then luma, cb and cr (reversed:
    the items in the other order, cr and cb before luma)."""
    cfg, plans, work = c["cfg"], c["sched"].plans, c["sched"].work
    org_y, org_c, modes = c["org_y"], c["org_c"], c["modes"]
    bd, strong = cfg.bit_depth, cfg.strong_intra_smoothing
    lam = full_lambda(cfg.qp)
    rq_y = (2, lam) if cfg.rdoq else None
    rq_c = (2, lam * 2.0 ** ((c["qp_c"] - cfg.qp) / 3.0)) if cfg.rdoq else None
    ry, rc = torch.zeros_like(org_y), torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16)
    outs = {lg: tuple(torch.full((k,), -9, dtype=torch.int32)
                      for k in (len(p.vpos), len(p.vpos), 2 * len(p.cidx)))
            for lg, p in plans.items()}

    def task(item, plane, mode):
        log2, row, crow = (int(v) for v in item[:3])
        p = plans[log2]
        if plane == 0:
            pos, av = p.pos[row:row + 1], p.avail[row:row + 1]
            pred, _ = intra_blocks_plain(ry, pos, av, mode, p.n, 0, bd, strong)
            cbf = tq_encode_plain(org_y, pred, pos, mode, p.n, 0, cfg.qp, bd,
                                  cfg.sbh, rq_y, ry, coef_y)
            outs[log2][0][row], outs[log2][1][row] = mode[0], cbf[0]
            return
        if crow < 0:
            return
        cmode = mode
        if modes is not None and modes[log2][1] is not None:
            cmode = modes[log2][1][crow:crow + 1]
        nc = 4 if log2 == 2 else p.n // 2
        r = int(item[2 + plane])
        cpos = p.cpos[r:r + 1]
        predc, _ = intra_blocks_plain(rc, cpos, p.cavail[crow:crow + 1],
                                      cmode, nc, 1, bd, strong)
        outs[log2][2][r] = tq_encode_plain(
            org_c, predc, cpos, cmode, nc, 1, c["qp_c"], bd, cfg.sbh, rq_c,
            rc, coef_c)[0]

    off = work.host_off
    for s in range(len(off) - 1):
        items = work.host_items[off[s]:off[s + 1]]
        if modes is None:
            for it in (items[::-1] if reverse else items):
                log2, row = int(it[0]), int(it[1])
                p = plans[log2]
                pos = p.pos[row:row + 1]
                chain = tintra.substitute_refs(tintra.gather_chains(
                    ry, pos, p.n), p.avail[row:row + 1], bd)
                preds = tintra.predict_all_modes(chain, p.n, 0, bd, strong)
                rows, cols = tintra.block_index(pos, p.n)
                satds = tintra.satd(org_y[rows, cols][:, None], preds)[0]
                best = torch.tensor([split_rmd(satds.tolist(), CLUSTER)],
                                    dtype=torch.int32)
                for plane in ((2, 1, 0) if reverse else (0, 1, 2)):
                    task(it, plane, best)
            continue
        tasks = [(it, plane) for plane in range(3) for it in items]
        for it, plane in (tasks[::-1] if reverse else tasks):
            log2, row = int(it[0]), int(it[1])
            task(it, plane, modes[log2][0][row:row + 1])
    return ry, rc, coef_y, coef_c, outs


def _walk_decode(c, resi_y, resi_c, modes, cmodes, reverse):
    """C13's decode entry on C2's plain body: per level every item's luma
    task, then cb, then cr (reversed: the other way round)."""
    cfg, plans, work = c["cfg"], c["sched"].plans, c["sched"].work
    bd, strong = cfg.bit_depth, cfg.strong_intra_smoothing
    ry, rc = torch.zeros_like(resi_y), torch.zeros_like(resi_c)
    off = work.host_off
    for s in range(len(off) - 1):
        items = work.host_items[off[s]:off[s + 1]]
        tasks = [(it, plane) for plane in range(3) for it in items]
        for it, plane in (tasks[::-1] if reverse else tasks):
            log2, row, crow = (int(v) for v in it[:3])
            p = plans[log2]
            if plane == 0:
                intra_blocks_plain(ry, p.pos[row:row + 1],
                                   p.avail[row:row + 1],
                                   modes[log2][row:row + 1], p.n, 0, bd,
                                   strong, resi=resi_y)
            elif crow >= 0:
                r = int(it[2 + plane])
                intra_blocks_plain(rc, p.cpos[r:r + 1],
                                   p.cavail[crow:crow + 1],
                                   cmodes[log2][crow:crow + 1],
                                   4 if log2 == 2 else p.n // 2, 1, bd,
                                   strong, resi=resi_c)
    return ry, rc


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["kernel-order", "reversed"])
@pytest.mark.parametrize("name", tsp.CASES)
def test_plane_walk_matches_reference(name, reverse):
    """C13's walk with each item's planes as tasks of their own (and the
    split RMD where no mode is given), in the kernel's order and reversed
    within each level: encode (recon, levels, modes, cbfs) and decode
    equal the JAX scan_encode's and scan_decode's bit for bit."""
    c = tsp._case(name)
    ref_enc, ref_dec = tsp._reference(name)
    got = _walk_encode(c, reverse)
    tsp._assert_encode_equal(c, got, ref_enc, "against the JAX scan_encode")
    loop_enc, _ = tsp._loop(name)
    resi_y, resi_c, modes, cmodes = tsp._decode_inputs(name, loop_enc)
    dy, dc = _walk_decode(c, resi_y, resi_c, modes, cmodes, reverse)
    h = c["h"]
    for a, b, nm in zip(tsp._planes(c, dy, dc),
                        (ref_dec[0][:h], ref_dec[1][:h // 2],
                         ref_dec[2][:h // 2]), ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"decode {nm}, JAX")


# ---------------------------------------------------------------------------
# RDOQ's scalar stage and tournament (rdoq.cuh stage 6 and 7).
# ---------------------------------------------------------------------------

def kernel_cumsum(x):
    """jnp.cumsum over the last axis as rdoq.cuh forms it: up to 16 values
    one running sum; above, the running sum within each 16-block (a CG:
    the CG walks of stages 5 and 7, or at 64 CGs stage 6's blocks, each on
    a thread of its own) plus the exclusive scan of the block totals,
    formed the same way (stage 6: one thread per cumsum adds the totals in
    order)."""
    x = np.asarray(x, f32)
    k = x.shape[-1]
    blk = x.reshape(*x.shape[:-1], -1, min(k, 16))
    run = np.empty_like(blk)
    acc = blk[..., 0]
    run[..., 0] = acc
    for j in range(1, blk.shape[-1]):
        acc = (acc + blk[..., j]).astype(f32)
        run[..., j] = acc
    if k <= 16:
        return run.reshape(x.shape)
    tot = kernel_cumsum(run[..., -1])
    excl = np.concatenate([np.zeros_like(tot[..., :1]), tot[..., :-1]], -1)
    return (run + excl[..., None]).astype(f32).reshape(x.shape)


def kernel_sum(x):
    """jnp.sum over m values as rdoq.cuh forms total0: m <= 32 on one
    thread in order; else each 32-block on a thread of its own, then the
    block sums in order q = 0, 1, ... on one thread."""
    x = np.asarray(x, f32)
    k = x.shape[-1]

    def seq(a):
        acc = a[..., 0]
        for j in range(1, a.shape[-1]):
            acc = (acc + a[..., j]).astype(f32)
        return acc
    if k <= 32:
        return seq(x)
    return seq(np.stack([seq(x[..., 32 * q:32 * q + 32])
                         for q in range(k // 32)], -1))


def kernel_tournament(tot):
    """rdoq.cuh's last-position tournament over tot [B, m]: each CG's walk
    of its 16 positions keeps a strictly lower cost (its first position
    first), then a warp argmin over (cost, CG). Returns (cost, position)."""
    tot = np.asarray(tot, f32)
    b, m = tot.shape
    ncg = max(m // 16, 1)
    g = tot.reshape(b, ncg, -1)
    bi = np.argmin(g, axis=2)          # the first of the lowest in each CG
    bc = np.take_along_axis(g, bi[..., None], 2)[..., 0]
    k = np.lexsort((np.arange(ncg)[None].repeat(b, 0), bc), axis=1)[:, 0]
    pos = k * g.shape[2] + bi[np.arange(b), k]
    return bc[np.arange(b), k], pos


def _tied(rng, shape):
    """float32 values of many magnitudes with many exact repeats."""
    x = (10.0 ** rng.uniform(0, 8, shape)).astype(f32)
    pool = x.reshape(-1)[:7].copy()
    mask = rng.random(shape) < 0.5
    x[mask] = rng.choice(pool, int(mask.sum()))
    return x


@pytest.mark.parametrize("k", [1, 4, 16, 64, 256, 1024])
def test_rdoq_forms_equal_compiled_reference(k):
    """The kernel's blocked cumsum and total0 equal XLA's compiled
    jnp.cumsum and jnp.sum, and its tournament equals the first position of
    the lowest cost, bit for bit, on values with many exact ties."""
    rng = np.random.default_rng(k)
    x = _tied(rng, (64, k))
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    np.testing.assert_array_equal(kernel_cumsum(x), want)
    np.testing.assert_array_equal(kernel_cumsum(x),
                                  rdoq.xla_cumsum(T(x)).numpy())
    if k >= 16:
        want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x))
        np.testing.assert_array_equal(kernel_sum(x), want)
        tie = x.copy()
        tie[:, ::3] = tie[:, :1]      # the lowest cost in many CGs
        tie[:8] = 1e30                # no candidate at all
        c, p = kernel_tournament(tie)
        wc, wp = rdoq.last_tournament(T(tie))
        np.testing.assert_array_equal(c, wc.numpy())
        np.testing.assert_array_equal(p, wp.numpy())


def _tie_coefs(rng, b, n):
    """Coefficient blocks with many equal magnitudes: constant blocks, one
    4x4 pattern repeated over every CG, and alternating signs."""
    c = np.zeros((b, n, n), np.int32)
    third = b // 3
    c[:third] = rng.integers(1, 400, (third, 1, 1))
    pat = rng.integers(-300, 300, (b - third, 4, 4))
    c[third:] = np.tile(pat, (1, n // 4, n // 4))
    c[::5] *= np.where((np.arange(n)[:, None] + np.arange(n)) % 2, -1, 1)
    return c


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq_kernel_forms_match_jitted_reference(monkeypatch, log2, c_idx):
    """rdoq_quant's plain body with its sums and its tournament in the
    kernel's forms equals the jitted JAX rdoq_quant level for level, on
    seeded blocks and on blocks built with ties."""
    monkeypatch.setattr(rdoq, "xla_cumsum",
                        lambda t: T(kernel_cumsum(t.numpy())))
    monkeypatch.setattr(rdoq, "xla_sum", lambda t: T(kernel_sum(t.numpy())))
    monkeypatch.setattr(rdoq, "last_tournament",
                        lambda t: tuple(map(T, kernel_tournament(t.numpy()))))
    n = 1 << log2
    b = {2: 256, 3: 128, 4: 48, 5: 24}[log2]
    rng = np.random.default_rng(log2 * 10 + c_idx)
    jit = jax.jit(jrdoq.rdoq_quant, static_argnames=(
        "qp", "log2_size", "bit_depth", "c_idx", "init_type", "lam"))
    for qp, coef in ((27, rdoq_coefs(rng, b, n)), (32, _tie_coefs(rng, b, n))):
        scan = rng.integers(0, 3, b).astype(np.int32)
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        kw = dict(qp=qp, log2_size=log2, bit_depth=8, c_idx=c_idx,
                  init_type=2, lam=lam)
        want = np.asarray(jit(coef, scan, **kw))
        got = rdoq.rdoq_quant(T(coef), T(scan), **kw).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# C5's sums (partition.cu).
# ---------------------------------------------------------------------------

def kernel_dist(err, n, arm):
    """partition.cu's SSE of each block's integer errors [B, n*n]: the
    integer sum where it is below 2^24 (there every partial sum of any
    order is exact); above, the compiled reference's order as the kernel
    splits it: at n = 8 and 16 a thread a lane (block_lane), then
    fold_lanes; at n = 32 a thread a row for the lanes that do not wait on
    the running sum (lane 4, lanes 2 + 6, (1 + 5) + (3 + 7)), then one
    thread the rows' chain through lane 0; at n = 4 the raster walk."""
    e = err.to(torch.int64)
    tot = (e * e).sum(1)
    sq = err.to(torch.float32) ** 2
    if n == 4:
        big = quant.seq_sum(sq)
    elif n < 32:
        lanes = torch.stack([quant.seq_sum(torch.cat(
            [sq[:, r * n:(r + 1) * n] for r in range(l, n, 8)], 1))
            for l in range(8)], 1)
        big = quant.fold_lanes(lanes)
    else:
        o = tpart.ROW32_ORDER[arm]
        rows = sq.reshape(-1, 32, 4, 8)
        v = rows[..., o[0], :]
        for k in o[1:]:
            v = v + rows[..., k, :]
        p4, p26 = v[..., 4], v[..., 2] + v[..., 6]
        q = (v[..., 1] + v[..., 5]) + (v[..., 3] + v[..., 7])
        acc = torch.zeros(sq.shape[0], dtype=torch.float32)
        for r in range(32):
            v0 = acc
            for k in o:
                v0 = v0 + rows[:, r, k, 0]
            acc = ((v0 + p4[:, r]) + p26[:, r]) + q[:, r]
        big = acc
    return torch.where(tot < 2 ** 24, tot.to(torch.float32), big)


def kernel_bits(terms):
    """partition.cu's rate sum: only the nonzero terms (a ballot marks
    them), added in raster order from 0."""
    acc = torch.zeros(terms.shape[0], dtype=torch.float32)
    for j in range(terms.shape[1]):
        t = terms[:, j]
        acc = torch.where(t != 0, acc + t, acc)
    return acc


def _c5_plane(kind, bit_depth, h=64, w=96):
    rng = np.random.default_rng(bit_depth + len(kind))
    if kind == "noise":
        return rng.integers(0, 1 << bit_depth, (h, w)).astype(np.int32)
    if kind == "flat":
        return np.full((h, w), 77 << (bit_depth - 8), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
         + 25 * np.sin((xx + yy) / 7.0) + rng.normal(0, 9, (h, w)))
    y = y.clip(0, 255).astype(np.int32)
    return y * 4 + 1 if bit_depth == 10 else y


@pytest.mark.parametrize("kind,bit_depth", [("texture", 8), ("texture", 10),
                                            ("noise", 10), ("flat", 8)])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_c5_sums_equal_reference(monkeypatch, n, kind, bit_depth):
    """rd_costs and rd_costs_forced with C5's integer SSE (the compiled
    reference's order above 2^24, as the kernel splits it) and compacted
    rate sum equal the port's plain sums bit for bit, and the JAX
    reference's costs within tests/test_torch_partition.py's tolerance
    with the same modes; on 10-bit noise at QP 51, whose 16x16 and 32x32
    SSEs pass 2^24 (and whose levels stay where the reference's log2 is
    exact), bit for bit in both arms; the flat plane gives equal-cost
    candidates."""
    y = _c5_plane(kind, bit_depth)
    qp = 51 if kind == "noise" else 27   # noise: SSEs past 2^24
    plain = tpart.rd_costs(T(y), n, qp, bit_depth)
    modes = np.random.default_rng(n).integers(0, 35, (64 // n, 96 // n))
    modes = modes.astype(np.int32)
    plain_f = tpart.rd_costs_forced(T(y), T(modes), n, qp, bit_depth)
    seen = []

    def dist(e, n_, arm):
        seen.append(int(((e.to(torch.int64) ** 2).sum(1)).max()))
        return kernel_dist(e, n_, arm)

    monkeypatch.setattr(tpart, "block_dist", dist)
    monkeypatch.setattr(tpart, "block_bits", kernel_bits)
    got = tpart.rd_costs(T(y), n, qp, bit_depth)
    got_f = tpart.rd_costs_forced(T(y), T(modes), n, qp, bit_depth)
    monkeypatch.undo()
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(got_f.numpy(), plain_f.numpy())
    ref = jnp.asarray(y.astype(np.uint8 if bit_depth == 8 else np.uint16))
    want_c, want_m = jpart.rd_costs(ref, n, qp, bit_depth)
    want_f = jpart.rd_costs_forced(ref, jnp.asarray(modes), n, qp, bit_depth)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_m))
    if kind == "noise":
        # F12 (ROADMAP.md queue 3): the SSE above 2^24 in the compiled
        # reference's order, both arms, bit for bit
        if n >= 16:
            assert max(seen) > 2 ** 24, "no SSE passed 2^24"
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_c),
                               rtol=COST_RTOL, atol=0)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=COST_RTOL, atol=0)
    if kind == "flat":
        # inside the picture the three candidates predict the block
        # exactly and cost the same: the first (planar) wins
        assert (got[1].numpy()[1:, 1:] == 0).all()
