// Device code of kernel C7, RDOQ of one transform block by one CTA, shared
// by its standalone entry (rdoq.cu) and by the RDOQ arm of tq_encode_block
// (tq.cuh), which kernel C3's encode entry (tq.cu), kernel C13 (scan.cu),
// kernel C14 (ss_scan.cu) and the mesh's level loop run. No sum's order
// depends on blockDim: the CG stages walk their 16 positions in one thread
// each, and each scalar sum keeps XLA's order with its independent blocks
// on threads of their own.
//
// Replaces hevc_hop_tpu/ops/rdoq.py rdoq_quant (with _level_rate). The
// stages follow the reference: the scan-order gather and round-half
// max_abs; last_pos; the coefficient groups' (CGs') flags and neighbour
// pattern; the sig contexts; c1/c2 counts and the Rice trajectory (four
// suffix passes per CG); the per-coefficient choice among max_abs,
// max_abs - 1 and 0; CG zeroing; the last-position / cbf tournament; the
// inverse permutation. Elementwise stages run one thread per coefficient,
// the CG stages one thread per CG walking its 16 positions in scan order.
// The scalar stage keeps every float's order and spreads what is
// independent: each 16-block of the three cumsums and each 32-block of
// total0 on a thread of its own, then the block totals' scans (one thread
// per cumsum, one for total0's block sums in order); the CG tournament is
// a warp argmin that keeps the first CG among equals. Serial by nature,
// and left so: the 4x4 total0 fma chain (each fma reads the last) and each
// CG's walk of its 16 positions (the c1/c2 counts and the Rice passes
// carry from position to position, and the sums run in scan order).
//
// Floats: every product and sum is rounded where the reference's compiled
// program (XLA on the CPU) rounds it, and fused where it fuses it, so that
// each level decision is the reference's bit for bit. __fmul_rn, __fadd_rn
// and __fsub_rn keep nvcc from contracting; fmaf marks each fused
// multiply-add. jnp.cumsum of k <= 64 values is XLA's blocked scan
// (sequential within blocks of 16 = one CG; over more than 16 CGs each
// block's running sum plus the exclusive scan of the block totals);
// jnp.sum over more than 32 positions adds blocks of 32 and then the block
// sums in order. The class-dependent forms (total0 as an
// fma chain at 4x4; cost_coeff - cost_sig fused at 8x8 and 16x16; the
// last-position rate fused where it is gathered per scan) come in as flags
// from ops/rdoq.py float_forms.
//
// Bound: by the floor count (chip_smoke.py rdoq_ops), per coefficient some
// 52 int32 and 54 float32 operations against 4 bytes in and 4 out, under
// the card's 10 int32 operations per byte: bytes. In practice a TU's CTA is
// bound by its sequential stages (per-CG walks of 16 positions, one
// thread's ordered sums), which the reference's float order imposes. The
// design keeps the block and every intermediate in shared memory.
#pragma once

#include "common.cuh"

namespace {

constexpr float kScale = 32768.0f;
constexpr float kInf = 1e30f;

// Tables and scalars of one TU class (ops/rdoq.py _tables_for and params).
// The layout is mirrored by ctypes in ops/rdoq.py.
struct RdoqArgs {
  const int32_t *perm;     // [3, m] raster index of each scan position
  const int32_t *sig_tab;  // [3, 4, m] sig ctx per (scan, pattern, pos)
  const int32_t *cgpos;    // [3, ncg, 2] CG grid (x, y) per CG
  const float *last_tab;   // [3, m] last-position rate
  const float *sig_bits;   // [nsig, 2]
  const float *one_bits;   // [n_one, 2]
  const float *abs_bits;   // [n_abs, 2]
  const float *cg_bits;    // [2, 2]
  const float *cbf_bits;   // [2]
  int n_one, n_abs;
  int qscale, qbits;
  float err_scale, lam;
  int chain_total0, fused_sig, fused_head;
};

// Shared scratch of rdoq_block for an n x n block, in bytes.
__host__ __device__ inline size_t rdoq_scratch_bytes(int n) {
  const int m = n * n, ncg = m / 16 > 1 ? m / 16 : 1;
  return (size_t)m * (3 * 4 + 3 * 4 + 5) + (size_t)ncg * (8 * 4) + 64;
}

// xGetICRate: rate (2^15 units) of coding abs level lev incl. the sign
// bit; 0 for lev 0. Every term is an integer below 2^24: exact.
__device__ __forceinline__ float level_rate(int lev, float ob0, float ob1,
                                            float ab0, float ab1, int rice,
                                            int c1i, int c2i) {
  if (lev <= 0) return 0.0f;
  const int base = c1i < 8 ? 2 + (c2i < 1 ? 1 : 0) : 1;
  const int sym = lev - base > 0 ? lev - base : 0;
  const int thr = 3 << rice;
  float r_rem;
  if (sym < thr) {
    r_rem = (float)((sym >> rice) + 1 + rice) * kScale;
  } else {
    const int cn = sym - thr + (1 << rice);
    const int ln = 31 - __clz(cn);  // floor(log2(cn) + 1e-6), exact here
    r_rem = (float)(3 + ln + 1 - rice + ln) * kScale;
  }
  float rate = kScale;
  const bool ge = lev >= base;
  if (ge) rate += r_rem;
  if (ge && c1i < 8) rate += ob1;
  if (ge && c1i < 8 && c2i < 1) rate += ab1;
  if (!ge && lev == 1) rate += ob0;
  if (!ge && lev == 2) rate += ob1 + ab0;
  return rate;
}

// RDOQ of the n x n block C (raster, int32 coefficients) into Q (raster,
// signed levels), scan sid (0 for single-scan classes). Every thread of the
// CTA calls it; scratch holds rdoq_scratch_bytes(n).
__device__ void rdoq_block(const int32_t *C, int32_t *Q, int n, int c_idx,
                           int sid, const RdoqArgs &a, char *scratch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = n * n, ncg = m / 16 > 1 ? m / 16 : 1;
  const int side = n / 4 > 1 ? n / 4 : 1;
  int32_t *ld = reinterpret_cast<int32_t *>(scratch);
  int32_t *ma = ld + m;
  int32_t *lev = ma + m;
  float *cost0 = reinterpret_cast<float *>(lev + m);
  float *cc = cost0 + m;
  float *sigsel = cc + m;
  int8_t *c1i = reinterpret_cast<int8_t *>(sigsel + m);
  int8_t *c2i = c1i + m;
  int8_t *rice = c2i + m;
  int8_t *onec = rice + m;
  uint8_t *flag = reinterpret_cast<uint8_t *>(onec + m);  // 1 sign, 2 paid
  int32_t *cgi = reinterpret_cast<int32_t *>(
      (reinterpret_cast<uintptr_t>(flag + m) + 15) & ~uintptr_t(15));
  int32_t *grid = cgi;               // [side * side] CG flags by position
  int32_t *cg_has_g1 = grid + ncg;   // [ncg]
  int32_t *pattern = cg_has_g1 + ncg;
  int32_t *cg_ctx = pattern + ncg;
  float *t_cc = reinterpret_cast<float *>(cg_ctx + ncg);  // block totals
  float *t_c0 = t_cc + ncg;
  float *e_cc = t_c0 + ncg;  // exclusive scans of the block totals
  float *e_c0 = e_cc + ncg;
  __shared__ int s_last, s_p2, s_best;
  __shared__ float s_total0;
  __shared__ float s_cgr[64], s_cgb[64], s_bc[64];
  __shared__ int s_bi[64];
  // stage 6's partial results: the three cumsums' in-block scans and block
  // totals (then their exclusive scan), total0's 32-blocks
  __shared__ float s_inc[3][64], s_btot[3][4], s_qsum[32];

  const int32_t *perm = a.perm + sid * m;
  const int qbits = a.qbits;
  if (tid == 0) {
    s_last = -1;
    s_p2 = 0;   // the last level above 1 (0 when there is none)
  }
  for (int k = tid; k < ncg; k += nt) grid[k] = 0;
  __syncthreads();
  // ---- 1. scan-order gather, round-half max_abs, last_pos
  for (int j = tid; j < m; j += nt) {
    const int c = C[perm[j]];
    const int l = (c < 0 ? -c : c) * a.qscale;
    const int mx = (l + (1 << (qbits - 1))) >> qbits;
    ld[j] = l;
    ma[j] = mx;
    flag[j] = c < 0 ? 1 : 0;
    if (mx > 0) atomicMax(&s_last, j);
  }
  __syncthreads();
  const int last_pos = s_last, last_cg = last_pos >> 4;
  const int32_t *cgp = a.cgpos + sid * ncg * 2;
  // ---- 2. CG flags (pre-decision)
  for (int k = tid; k < ncg; k += nt) {
    bool nz = false, g1 = false;
    for (int i = 0; i < 16; ++i) {
      const int j = 16 * k + i;
      if (j <= last_pos) {
        nz |= ma[j] > 0;
        g1 |= ma[j] > 1;
      }
    }
    grid[cgp[2 * k + 1] * side + cgp[2 * k]] = nz;
    cg_has_g1[k] = g1;
  }
  __syncthreads();
  // ---- 3. neighbour pattern, ctx set, c1/c2 counts and Rice per CG
  for (int k = tid; k < ncg; k += nt) {
    const int cx = cgp[2 * k], cy = cgp[2 * k + 1];
    const int right = cx + 1 < side ? grid[cy * side + cx + 1] : 0;
    const int below = cy + 1 < side ? grid[(cy + 1) * side + cx] : 0;
    pattern[k] = right + 2 * below;
    cg_ctx[k] = right | below;
    const bool prev_g1 = k + 1 < ncg ? cg_has_g1[k + 1] != 0 : false;
    const int ctx_set = ((k == 0 || c_idx > 0) ? 0 : 2) +
                        ((prev_g1 && k + 1 <= last_cg) ? 1 : 0);
    int lv[16], base[16];
    bool ge[16], rge[16];
    int n1 = 0, n2 = 0;
    for (int i = 15; i >= 0; --i) {
      const int j = 16 * k + i;
      const bool act = j <= last_pos;
      lv[i] = act ? ma[j] : 0;
      c1i[j] = (int8_t)n1;
      c2i[j] = (int8_t)n2;
      base[i] = n1 < 8 ? 2 + (n2 < 1 ? 1 : 0) : 1;
      const int c1 = n2 > 0 ? 0 : (1 + n1 - n2 < 3 ? 1 + n1 - n2 : 3);
      const int oc = ctx_set * 4 + c1;
      onec[j] = (int8_t)(oc < a.n_one - 1 ? oc : a.n_one - 1);
      n1 += (act && ma[j] > 0) ? 1 : 0;
      n2 += (act && ma[j] > 1) ? 1 : 0;
      ge[i] = lv[i] >= base[i];
      rge[i] = true;
    }
    int rc[16] = {0};
    for (int p = 0; p < 4; ++p) {
      int after = 0;  // triggers strictly after position i
      bool trig[16];
      for (int i = 0; i < 16; ++i)
        trig[i] = ge[i] && lv[i] > (3 << p) && rge[i];
      for (int i = 15; i >= 0; --i) {
        rge[i] = after > 0;
        rc[i] += rge[i] ? 1 : 0;
        after += trig[i] ? 1 : 0;
      }
    }
    for (int i = 0; i < 16; ++i) rice[16 * k + i] = (int8_t)rc[i];
    // abs ctx of the CG, kept in the sign byte's upper bits
    const int ac = ctx_set < a.n_abs - 1 ? ctx_set : a.n_abs - 1;
    for (int i = 0; i < 16; ++i) flag[16 * k + i] |= (uint8_t)(ac << 4);
  }
  __syncthreads();
  // ---- 4. level decision per coefficient (xGetCodedLevel)
  const float es = a.err_scale, lam = a.lam;
  for (int j = tid; j < m; j += nt) {
    const int k = j >> 4;
    const int mx = ma[j];
    const bool is_last = j == last_pos, act = j <= last_pos;
    const int sctx = a.sig_tab[(sid * 4 + pattern[k]) * m + j];
    const float sig0 = a.sig_bits[2 * sctx], sig1 = a.sig_bits[2 * sctx + 1];
    const int oc = onec[j], ac = flag[j] >> 4;
    const float ob0 = a.one_bits[2 * oc], ob1 = a.one_bits[2 * oc + 1];
    const float ab0 = a.abs_bits[2 * ac], ab1 = a.abs_bits[2 * ac + 1];
    const float ldf = __int2float_rn(ld[j]);
    const float ldf2 = __fmul_rn(ldf, ldf);
    const float c0 = __fmul_rn(ldf2, es);
    const int cand1 = mx, cand2 = mx - 1 > 1 ? mx - 1 : 1;
    const float lsig0 = __fmul_rn(lam, sig0), lsig1 = __fmul_rn(lam, sig1);
    const float sig_cost1 = is_last ? 0.0f : lsig1;
    float cost_c1, cost_c2 = kInf;
    {
      const float err = __fsub_rn(ldf, __int2float_rn(cand1 << qbits));
      const float r = level_rate(cand1, ob0, ob1, ab0, ab1, rice[j], c1i[j],
                                 c2i[j]);
      cost_c1 = __fadd_rn(fmaf(__fmul_rn(err, err), es, __fmul_rn(lam, r)),
                          sig_cost1);
    }
    if (mx > 1) {
      const float err = __fsub_rn(ldf, __int2float_rn(cand2 << qbits));
      const float r = level_rate(cand2, ob0, ob1, ab0, ab1, rice[j], c1i[j],
                                 c2i[j]);
      cost_c2 = __fadd_rn(fmaf(__fmul_rn(err, err), es, __fmul_rn(lam, r)),
                          sig_cost1);
    }
    const float cost_z = (!is_last && mx < 3) ? fmaf(ldf2, es, lsig0) : kInf;
    int l = cost_c2 < cost_c1 ? cand2 : cand1;
    const float best = cost_c1 < cost_c2 ? cost_c1 : cost_c2;
    if (cost_z < best || mx == 0 || !act) l = 0;
    const bool paid = act && !is_last;
    const float ssel = l > 0 ? sig1 : sig0;
    const float csig = paid ? __fmul_rn(lam, ssel) : 0.0f;
    float cco = l > 0 ? best : __fadd_rn(c0, csig);
    if (!act) cco = c0;
    lev[j] = l;
    cost0[j] = c0;
    cc[j] = cco;
    sigsel[j] = ssel;
    if (paid) flag[j] |= 2;
  }
  __syncthreads();
  // ---- 5. CG zeroing, CG sig rates, block totals
  for (int k = tid; k < ncg; k += nt) {
    bool fin = false;
    float scc = cc[16 * k], chain = cost0[16 * k];
    for (int i = 0; i < 16; ++i) {
      const int j = 16 * k + i;
      fin |= lev[j] > 0;
      if (i > 0) {
        scc = __fadd_rn(scc, cc[j]);
        const float ldf = __int2float_rn(ld[j]);
        chain = fmaf(__fmul_rn(ldf, ldf), es, chain);
      }
    }
    const float cgb0 = a.cg_bits[2 * cg_ctx[k]];
    const float cgb1 = a.cg_bits[2 * cg_ctx[k] + 1];
    const bool coded = k > 0 && k < last_cg;
    if (fin && coded &&
        __fsub_rn(fmaf(cgb1, lam, scc), fmaf(cgb0, lam, chain)) > 0.0f) {
      fin = false;
      for (int i = 0; i < 16; ++i) {
        const int j = 16 * k + i;
        lev[j] = 0;
        cc[j] = cost0[j];
        flag[j] &= ~2;
      }
    }
    s_cgr[k] = coded ? (fin ? __fmul_rn(lam, cgb1) : __fmul_rn(lam, cgb0))
                     : 0.0f;
    float tc = cc[16 * k], t0 = cost0[16 * k];
    for (int i = 1; i < 16; ++i) {
      tc = __fadd_rn(tc, cc[16 * k + i]);
      t0 = __fadd_rn(t0, cost0[16 * k + i]);
    }
    t_cc[k] = tc;
    t_c0[k] = t0;
  }
  __syncthreads();
  // p2, the last level above 1, after the zeroing
  for (int j = tid; j < m; j += nt)
    if (lev[j] > 1) atomicMax(&s_p2, j);
  // ---- 6. the exclusive scans of the block totals, the CG rates below
  // each CG, total0, in XLA's orders (xla_cumsum_small, blocked sums) with
  // their serial parts spread over threads: (a) each 16-block of the three
  // cumsums scanned by its own thread, each 32-block of total0 summed by
  // its own thread (total0's serial forms, the 4x4 fma chain and m <= 32,
  // whole on one thread); (b) the exclusive scan of each cumsum's block
  // totals on one thread each, total0's block sums added in order q = 0,
  // 1, ... on another; (c) the block offsets added, every CG on its own
  // thread.
  {
    const int nb = ncg > 16 ? ncg / 16 : 1, bl = ncg > 16 ? 16 : ncg;
    const bool blocked0 = !a.chain_total0 && m > 32;
    const int nq = blocked0 ? m / 32 : 1;
    const float *src3[3] = {t_cc, t_c0, s_cgr};
    for (int job = tid; job < 3 * nb + nq; job += nt) {
      if (job < 3 * nb) {
        const int ar = job / nb, q = job % nb;
        const float *v = src3[ar] + 16 * q;
        float *out = s_inc[ar] + 16 * q;
        float acc = v[0];
        out[0] = acc;
        for (int j = 1; j < bl; ++j) out[j] = acc = __fadd_rn(acc, v[j]);
        s_btot[ar][q] = acc;
      } else if (!blocked0) {
        float tot0 = cost0[0];
        if (a.chain_total0) {
          for (int j = 1; j < m; ++j) {
            const float ldf = __int2float_rn(ld[j]);
            tot0 = fmaf(__fmul_rn(ldf, ldf), es, tot0);
          }
        } else {
          for (int j = 1; j < m; ++j) tot0 = __fadd_rn(tot0, cost0[j]);
        }
        s_total0 = tot0;
      } else {
        const int q = job - 3 * nb;
        float sq = cost0[32 * q];
        for (int j = 1; j < 32; ++j) sq = __fadd_rn(sq, cost0[32 * q + j]);
        s_qsum[q] = sq;
      }
    }
    __syncthreads();
    if (nb > 1 && tid < 3) {
      // the exclusive scan of the block totals, in place
      float e = 0.0f;
      for (int q = 0; q < nb; ++q) {
        const float tq = s_btot[tid][q];
        s_btot[tid][q] = e;
        e = q == 0 ? tq : __fadd_rn(e, tq);
      }
    }
    if (blocked0 && tid == (nt > 3 ? 3 : 0)) {
      float tot0 = s_qsum[0];
      for (int q = 1; q < nq; ++q) tot0 = __fadd_rn(tot0, s_qsum[q]);
      s_total0 = tot0;
    }
    __syncthreads();
    // inclusive cumsum of array ar at CG k
    auto inc = [&](int ar, int k) {
      return nb > 1 ? __fadd_rn(s_inc[ar][k], s_btot[ar][k >> 4])
                    : s_inc[ar][k];
    };
    for (int k = tid; k < ncg; k += nt) {
      e_cc[k] = k ? inc(0, k - 1) : 0.0f;
      e_c0[k] = k ? inc(1, k - 1) : 0.0f;
      s_cgb[k] = __fsub_rn(inc(2, k), s_cgr[k]);
    }
  }
  __syncthreads();
  // ---- 7. last-position tournament, one thread per CG
  const float lam_cbf1 = __fmul_rn(lam, a.cbf_bits[1]);
  const float *last_tab = a.last_tab + sid * m;
  const int p2 = s_p2;
  const float total0 = s_total0;
  for (int k = tid; k < ncg; k += nt) {
    float acc_cc = 0.0f, acc_c0 = 0.0f, bc = kInf;
    int bi = 16 * k;
    for (int i = 0; i < 16; ++i) {
      const int j = 16 * k + i;
      acc_cc = i ? __fadd_rn(acc_cc, cc[j]) : cc[j];
      acc_c0 = i ? __fadd_rn(acc_c0, cost0[j]) : cost0[j];
      const float pref = __fsub_rn(__fadd_rn(acc_cc, e_cc[k]), cc[j]);
      const float suff = __fsub_rn(total0, __fadd_rn(acc_c0, e_c0[k]));
      const float head =
          a.fused_head ? fmaf(last_tab[j], lam, lam_cbf1)
                       : __fadd_rn(lam_cbf1, __fmul_rn(lam, last_tab[j]));
      const bool paid = (flag[j] & 2) != 0;
      float net;
      if (a.fused_sig)
        net = paid ? fmaf(-sigsel[j], lam, cc[j]) : cc[j];
      else
        net = __fsub_rn(cc[j], paid ? __fmul_rn(lam, sigsel[j]) : 0.0f);
      float tot = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(head, s_cgb[k]),
                                                pref), net), suff);
      if (!(lev[j] > 0 && j >= p2)) tot = kInf;
      if (i == 0 || tot < bc) {
        bc = tot;
        bi = j;
      }
    }
    s_bc[k] = bc;
    s_bi[k] = bi;
  }
  __syncthreads();
  // the best CG by a warp argmin: (cost, CG) in lexicographic order, so
  // the first CG among equal costs wins, as the walk over the CGs in order
  // with a strict < does
  if (tid < 32) {
    float bc = kInf;
    int bk = ncg;
    for (int k = tid; k < ncg; k += 32)
      if (s_bc[k] < bc || bk == ncg) {
        bc = s_bc[k];
        bk = k;
      }
    for (int o = 16; o > 0; o >>= 1) {
      const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
      if (oc < bc || (oc == bc && ok < bk)) {
        bc = oc;
        bk = ok;
      }
    }
    if (tid == 0) {
      const float cbf0 = __fadd_rn(__fmul_rn(lam, a.cbf_bits[0]), total0);
      s_best = (bc < cbf0 && last_pos >= 0) ? s_bi[bk] : -1;
    }
  }
  __syncthreads();
  // ---- 8. inverse permutation
  const int best_last = s_best;
  for (int j = tid; j < m; j += nt) {
    const int l = j <= best_last ? lev[j] : 0;
    Q[perm[j]] = (flag[j] & 1) ? -l : l;
  }
  __syncthreads();
}

}  // namespace
