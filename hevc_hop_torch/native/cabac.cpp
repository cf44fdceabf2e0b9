// Native CABAC runtime: arithmetic engine + full HEVC slice-data syntax
// (CU quadtree, intra modes, transform tree, residual coding) in both
// directions, operating over dense frame-granular maps so the TPU side
// (JAX) works on whole-frame tensors and this layer handles the serial bits.
//
// Capability reference: TEncBinCoderCABAC.cpp / TDecBinCoderCABAC.cpp
// (engine), TEncSbac.cpp:1829 codeCoeffNxN / TDecSbac.cpp (residual syntax),
// TEncCu.cpp:1019 xEncodeCU / TDecCu.cpp (CU syntax). This is a fresh
// implementation from the H.265 spec (7.3.8.x, 9.3.x) with an array-based
// interface designed for batched TPU reconstruction; it is not a port.
//
// Build: make -C hevc_hop_torch/native   -> libhevc_hop.so (ctypes)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "gen/cabac_tables.h"
#include "gen/ctx_layout.h"

// staged sign_data_hiding flag (see encode_residual): set by
// hevc_set_sbh, consumed by fill_maps on the same thread
static thread_local int t_sbh = 0;

namespace {

// Optional per-context bin statistics: when set (hevc_set_bin_counts), every
// context-coded bin increments counts[(ctx << 1) | bin]. Used for encoder
// telemetry and to calibrate the RDOQ static rate model (ops/rdoq.py)
// against realized CABAC statistics.
static uint64_t* g_bin_counts = nullptr;

// ---------------------------------------------------------------------------
// Arithmetic engine (H.265 9.3.4.3), byte-exact with the reference engine.
// ---------------------------------------------------------------------------

struct CabacEnc {
  uint32_t low = 0, range = 510;
  int bits_left = 23, num_buffered = 0;
  uint32_t buffered_byte = 0xFF;
  std::vector<uint8_t>* out;
  // bit-level tail (the payload before CABAC data is byte aligned, so only
  // finish() produces sub-byte bits; we spill them into held bits)
  uint32_t held = 0;
  int held_bits = 0;

  void put_bits(uint32_t value, int n) {
    value &= (n < 32) ? ((1u << n) - 1) : 0xFFFFFFFFu;
    int bits = held_bits + n;
    uint64_t acc = ((uint64_t)held << n) | value;
    while (bits >= 8) {
      bits -= 8;
      out->push_back((uint8_t)(acc >> bits));
    }
    held = (uint32_t)(acc & ((1u << bits) - 1));
    held_bits = bits;
  }

  void write_out() {
    uint32_t lead = low >> (24 - bits_left);
    bits_left += 8;
    low &= 0xFFFFFFFFu >> bits_left;
    if (lead == 0xFF) {
      num_buffered++;
    } else if (num_buffered > 0) {
      uint32_t carry = lead >> 8;
      put_bits((buffered_byte + carry) & 0xFF, 8);
      buffered_byte = lead & 0xFF;
      uint32_t fill = (0xFF + carry) & 0xFF;
      while (num_buffered > 1) {
        put_bits(fill, 8);
        num_buffered--;
      }
    } else {
      num_buffered = 1;
      buffered_byte = lead & 0xFF;
    }
  }

  inline void bin(uint8_t* ctx, int idx, int b) {
    if (g_bin_counts) g_bin_counts[(idx << 1) | (b ? 1 : 0)]++;
    uint8_t s = ctx[idx];
    uint32_t lps = kLpsTable[s >> 1][(range >> 6) & 3];
    range -= lps;
    if (b != (s & 1)) {
      int nb = kRenormTable[lps >> 3];
      low = (low + range) << nb;
      range = lps << nb;
      ctx[idx] = kNextStateLps[s];
      bits_left -= nb;
    } else {
      ctx[idx] = kNextStateMps[s];
      if (range >= 256) return;
      low <<= 1;
      range <<= 1;
      bits_left--;
    }
    if (bits_left < 12) write_out();
  }

  inline void bypass(int b) {
    low <<= 1;
    if (b) low += range;
    bits_left--;
    if (bits_left < 12) write_out();
  }

  inline void bypass_bins(uint32_t value, int n) {
    while (n > 8) {
      n -= 8;
      uint32_t pattern = value >> n;
      low = (low << 8) + range * pattern;
      value -= pattern << n;
      bits_left -= 8;
      if (bits_left < 12) write_out();
    }
    low = (low << n) + range * value;
    bits_left -= n;
    if (bits_left < 12) write_out();
  }

  inline void terminate(int b) {
    range -= 2;
    if (b) {
      low = (low + range) << 7;
      range = 2 << 7;
      bits_left -= 7;
    } else if (range >= 256) {
      return;
    } else {
      low <<= 1;
      range <<= 1;
      bits_left--;
    }
    if (bits_left < 12) write_out();
  }

  void finish() {
    if (low >> (32 - bits_left)) {
      put_bits((buffered_byte + 1) & 0xFF, 8);
      while (num_buffered > 1) {
        put_bits(0x00, 8);
        num_buffered--;
      }
      low -= 1u << (32 - bits_left);
    } else {
      if (num_buffered > 0) put_bits(buffered_byte, 8);
      while (num_buffered > 1) {
        put_bits(0xFF, 8);
        num_buffered--;
      }
    }
    put_bits(low >> 8, 24 - bits_left);
  }

  void byte_align_with_stop_bit() {
    put_bits(1, 1);
    if (held_bits) put_bits(0, 8 - held_bits);
  }
};

struct CabacDec {
  const uint8_t* data;
  int64_t size, pos = 0;
  uint32_t range = 510, value = 0;
  int bits_needed = -8;

  void start() {
    value = ((uint32_t)byte() << 8) | byte();
    bits_needed = -8;
  }

  inline uint32_t byte() { return pos < size ? data[pos++] : 0; }

  inline int bin(uint8_t* ctx, int idx) {
    uint8_t s = ctx[idx];
    uint32_t lps = kLpsTable[s >> 1][(range >> 6) & 3];
    range -= lps;
    uint32_t scaled = range << 7;
    int b;
    if (value < scaled) {
      b = s & 1;
      ctx[idx] = kNextStateMps[s];
      if (scaled < (256u << 7)) {
        range = scaled >> 6;
        value += value;
        if (++bits_needed == 0) {
          bits_needed = -8;
          value += byte();
        }
      }
    } else {
      int nb = kRenormTable[lps >> 3];
      value = (value - scaled) << nb;
      range = lps << nb;
      b = 1 - (s & 1);
      ctx[idx] = kNextStateLps[s];
      bits_needed += nb;
      if (bits_needed >= 0) {
        value += byte() << bits_needed;
        bits_needed -= 8;
      }
    }
    return b;
  }

  inline int bypass() {
    value += value;
    if (++bits_needed >= 0) {
      bits_needed = -8;
      value += byte();
    }
    uint32_t scaled = range << 7;
    if (value >= scaled) {
      value -= scaled;
      return 1;
    }
    return 0;
  }

  inline uint32_t bypass_bins(int n) {
    uint32_t bins = 0;
    while (n > 8) {
      value = (value << 8) + (byte() << (8 + bits_needed));
      uint32_t scaled = range << 15;
      for (int i = 0; i < 8; i++) {
        bins += bins;
        scaled >>= 1;
        if (value >= scaled) {
          bins++;
          value -= scaled;
        }
      }
      n -= 8;
    }
    bits_needed += n;
    value <<= n;
    if (bits_needed >= 0) {
      value += byte() << bits_needed;
      bits_needed -= 8;
    }
    uint32_t scaled = range << (n + 7);
    for (int i = 0; i < n; i++) {
      bins += bins;
      scaled >>= 1;
      if (value >= scaled) {
        bins++;
        value -= scaled;
      }
    }
    return bins;
  }

  inline int terminate() {
    range -= 2;
    uint32_t scaled = range << 7;
    if (value >= scaled) return 1;
    if (scaled < (256u << 7)) {
      range = scaled >> 6;
      value += value;
      if (++bits_needed == 0) {
        bits_needed = -8;
        value += byte();
      }
    }
    return 0;
  }
};

// ---------------------------------------------------------------------------
// Scan tables (H.265 6.5.3): scan position -> raster index within TU.
// ---------------------------------------------------------------------------

struct Scans {
  // [scanIdx][log2-2][pos] and CG scans [scanIdx][log2-2][cg]
  std::vector<uint16_t> coef[3][4];
  std::vector<uint16_t> cg[3][4];
  Scans() {
    for (int lw = 2; lw <= 5; lw++) {
      int n = 1 << lw;
      for (int s = 0; s < 3; s++) {
        coef[s][lw - 2] = build(n, s);
        // CG scan over the group grid is flat (not 4x4-subgrouped)
        int gn = n / 4 > 0 ? n / 4 : 1;
        cg[s][lw - 2] = (s == 0) ? diag(gn) : raster(gn, s == 2);
      }
    }
  }
  static std::vector<uint16_t> diag(int sz) {
    std::vector<uint16_t> v;
    for (int d = 0; d < 2 * sz - 1; d++) {
      int y = d < sz ? d : sz - 1;
      int x = d - y;
      while (y >= 0 && x < sz) v.push_back((uint16_t)(y-- * sz + x++));
    }
    return v;
  }
  static std::vector<uint16_t> raster(int sz, bool vert) {
    std::vector<uint16_t> v;
    for (int a = 0; a < sz; a++)
      for (int b = 0; b < sz; b++)
        v.push_back((uint16_t)(vert ? b * sz + a : a * sz + b));
    return v;
  }
  static std::vector<uint16_t> build(int n, int s) {
    if (n <= 4) {
      if (s == 0) return diag(n);
      return raster(n, s == 2);
    }
    // 4x4-group based
    std::vector<uint16_t> groups = (s == 0) ? diag(n / 4) : raster(n / 4, s == 2);
    std::vector<uint16_t> inner = (s == 0) ? diag(4) : raster(4, s == 2);
    std::vector<uint16_t> v;
    for (uint16_t g : groups) {
      int gy = g / (n / 4), gx = g % (n / 4);
      for (uint16_t in : inner) {
        int iy = in / 4, ix = in % 4;
        v.push_back((uint16_t)((gy * 4 + iy) * n + gx * 4 + ix));
      }
    }
    return v;
  }
};
static const Scans g_scans;

static const uint8_t kCtxMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                       6, 6, 8, 8, 7, 7, 8, 8};
static const uint8_t kMinInGroup[10] = {0, 1, 2, 3, 4, 6, 8, 12, 16, 24};

static inline int group_idx(int pos) {
  if (pos < 4) return pos;
  int k = 31 - __builtin_clz((unsigned)pos);
  return 2 * k + ((pos >= (1 << k) + (1 << (k - 1))) ? 1 : 0);
}

static inline int sig_ctx(int log2, int c_idx, int xc, int yc, int scan,
                          int csbf_right, int csbf_below) {
  if (log2 == 2) return kCtxMap4x4[(yc << 2) + xc];
  if (xc == 0 && yc == 0) return 0;
  int prev = csbf_right + 2 * csbf_below;
  int xp = xc & 3, yp = yc & 3, s;
  switch (prev) {
    case 0: s = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0; break;
    case 1: s = (yp == 0) ? 2 : (yp == 1) ? 1 : 0; break;
    case 2: s = (xp == 0) ? 2 : (xp == 1) ? 1 : 0; break;
    default: s = 2;
  }
  if (c_idx == 0) {
    if (xc > 3 || yc > 3) s += 3;
    s += (log2 == 3) ? (scan == 0 ? 9 : 15) : 21;
  } else {
    s += (log2 == 3) ? 9 : 12;
  }
  return s;
}

// MDCS (H.265 8.4.4.2.7 scan selection / ref TComDataCU getCoefScanIdx)
static inline int scan_for_tu(int log2, int c_idx, int intra_mode) {
  if (log2 == 2 || (log2 == 3 && c_idx == 0)) {
    int d = intra_mode;
    if (d >= 22 && d <= 30) return 1;  // near-vertical pred -> horizontal scan
    if (d >= 6 && d <= 14) return 2;   // near-horizontal pred -> vertical scan
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Residual coding (H.265 7.3.8.11 + 9.3.4.2.5-7), encode & decode.
// coef: pointer into a full-frame plane, `stride` elements per row.
// ---------------------------------------------------------------------------

struct ResidualCommon {
  int log2, c_idx, scan;
  const uint16_t* cscan;  // coef scan: pos -> raster idx in TU
  const uint16_t* gscan;  // CG scan
  int n, num_cg_side;
  void setup(int log2_, int c_idx_, int intra_mode) {
    log2 = log2_;
    c_idx = c_idx_;
    scan = scan_for_tu(log2, c_idx, intra_mode);
    cscan = g_scans.coef[scan][log2 - 2].data();
    gscan = g_scans.cg[scan][log2 - 2].data();
    n = 1 << log2;
    num_cg_side = n >> 2;
  }
  inline int last_ctx_base(bool is_x) const {
    (void)is_x;
    return 0;
  }
};

// sign_data_hiding_enabled_flag (PPS): when on, each 4x4 coefficient
// group with lastNZ-firstNZ >= 4 in scan order omits the sign of its
// first nonzero; the decoder infers it from the abs-level parity
// (HEVC 7.3.8.11; TComTrQuant.cpp:868 signBitHidingHDQ). Carried in
// FrameMaps.sbh / passed per call — a process-wide mutable global would
// leak state between independent instances (advisor round-4). The
// thread-local below only stages the value between hevc_set_sbh and
// fill_maps on the same thread.

static void encode_residual(CabacEnc& e, uint8_t* ctx, const int16_t* coef,
                            int stride, int log2, int c_idx, int intra_mode,
                            int sbh) {
  ResidualCommon rc;
  rc.setup(log2, c_idx, intra_mode);
  const int num_coef = rc.n * rc.n;

  // gather coefficients in scan order + find last significant
  int last_scan_pos = -1;
  for (int p = num_coef - 1; p >= 0; p--) {
    int r = rc.cscan[p];
    if (coef[(r >> log2) * stride + (r & (rc.n - 1))]) {
      last_scan_pos = p;
      break;
    }
  }
  if (last_scan_pos < 0) return;  // caller must not emit cbf=1 then

  int last_r = rc.cscan[last_scan_pos];
  int pos_x = last_r & (rc.n - 1), pos_y = last_r >> log2;
  if (rc.scan == 2) { int t = pos_x; pos_x = pos_y; pos_y = t; }

  // last_sig_coeff x/y prefix+suffix
  int gx = group_idx(pos_x), gy = group_idx(pos_y);
  int max_group = (log2 << 1) - 1;
  int blk_off, shift;
  if (c_idx == 0) {
    blk_off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
    shift = (log2 + 1) >> 2;
  } else {
    blk_off = 0;
    shift = log2 - 2;
  }
  int bx = (c_idx == 0) ? CTX_LAST_X_LUMA : CTX_LAST_X_CHROMA;
  int by = (c_idx == 0) ? CTX_LAST_Y_LUMA : CTX_LAST_Y_CHROMA;
  for (int i = 0; i < gx; i++) e.bin(ctx, bx + blk_off + (i >> shift), 1);
  if (gx < max_group) e.bin(ctx, bx + blk_off + (gx >> shift), 0);
  for (int i = 0; i < gy; i++) e.bin(ctx, by + blk_off + (i >> shift), 1);
  if (gy < max_group) e.bin(ctx, by + blk_off + (gy >> shift), 0);
  if (gx > 3) e.bypass_bins(pos_x - kMinInGroup[gx], (gx >> 1) - 1);
  if (gy > 3) e.bypass_bins(pos_y - kMinInGroup[gy], (gy >> 1) - 1);

  int last_cg = last_scan_pos >> 4;
  std::vector<uint8_t> csbf(rc.num_cg_side * rc.num_cg_side, 0);
  // precompute csbf
  for (int cgi = 0; cgi <= last_cg; cgi++) {
    int cg_r = rc.gscan[cgi];
    int cx = (cg_r % rc.num_cg_side) * 4, cy = (cg_r / rc.num_cg_side) * 4;
    uint8_t any = 0;
    for (int yy = 0; yy < 4; yy++)
      for (int xx = 0; xx < 4; xx++)
        any |= coef[(cy + yy) * stride + cx + xx] != 0;
    csbf[cg_r] = any;
  }
  // DC CG and last CG have csbf inferred to 1: even if the DC CG is all
  // zero, its significance map is still coded (all-zero sig flags).
  csbf[rc.gscan[0]] = 1;

  int c1 = 1;
  const int sig_base = (c_idx == 0) ? CTX_SIG_LUMA : CTX_SIG_CHROMA;
  const int one_base = (c_idx == 0) ? CTX_ONE_LUMA : CTX_ONE_CHROMA;
  const int abs_base = (c_idx == 0) ? CTX_ABS_LUMA : CTX_ABS_CHROMA;
  const int cg_base = (c_idx == 0) ? CTX_SIG_CG_LUMA : CTX_SIG_CG_CHROMA;

  for (int cgi = last_cg; cgi >= 0; cgi--) {
    int cg_r = rc.gscan[cgi];
    int cgx = cg_r % rc.num_cg_side, cgy = cg_r / rc.num_cg_side;
    int right = (cgx + 1 < rc.num_cg_side) ? csbf[cg_r + 1] : 0;
    int below = (cgy + 1 < rc.num_cg_side) ? csbf[cg_r + rc.num_cg_side] : 0;
    bool infer_dc = false;
    if (cgi < last_cg && cgi > 0) {
      e.bin(ctx, cg_base + ((right | below) ? 1 : 0), csbf[cg_r]);
      infer_dc = true;
    }
    if (!csbf[cg_r]) continue;

    // significance map
    int n_sig = 0;
    int16_t sig_lev[16];
    int sig_p[16];
    int start = (cgi == last_cg) ? (last_scan_pos & 15) : 15;
    if (cgi == last_cg) {
      int r = rc.cscan[last_scan_pos];
      sig_lev[n_sig] = coef[(r >> log2) * stride + (r & (rc.n - 1))];
      sig_p[n_sig++] = last_scan_pos & 15;
      start--;
    }
    for (int p = start; p >= 0; p--) {
      int sp = (cgi << 4) | p;
      int r = rc.cscan[sp];
      int xc = r & (rc.n - 1), yc = r >> log2;
      int16_t lev = coef[yc * stride + xc];
      int sig = lev != 0;
      if (p > 0 || !infer_dc) {
        e.bin(ctx, sig_base + sig_ctx(log2, c_idx, xc, yc, rc.scan,
                                      right, below), sig);
        if (sig) infer_dc = false;
      }
      if (sig) { sig_lev[n_sig] = lev; sig_p[n_sig++] = p; }
    }

    // greater1 / greater2
    int ctx_set = ((cgi == 0 || c_idx > 0) ? 0 : 2) + (c1 == 0 ? 1 : 0);
    c1 = 1;
    int first_c2_idx = -1;
    int num_c1 = n_sig < 8 ? n_sig : 8;
    for (int i = 0; i < num_c1; i++) {
      int abs_lev = sig_lev[i] < 0 ? -sig_lev[i] : sig_lev[i];
      int g1 = abs_lev > 1;
      e.bin(ctx, one_base + ctx_set * 4 + c1, g1);
      if (g1) {
        c1 = 0;
        if (first_c2_idx < 0) first_c2_idx = i;
      } else if (c1 < 3 && c1 > 0) {
        c1++;
      }
    }
    if (first_c2_idx >= 0) {
      int abs_lev = sig_lev[first_c2_idx] < 0 ? -sig_lev[first_c2_idx]
                                              : sig_lev[first_c2_idx];
      e.bin(ctx, abs_base + ctx_set, abs_lev > 2);
    }

    // signs; with SBH the first nonzero's sign (= last collected) is
    // hidden and carried by the abs-level parity the quantizer enforced
    bool sign_hidden = sbh && n_sig > 0 &&
                       (sig_p[0] - sig_p[n_sig - 1] >= 4);
    for (int i = 0; i < n_sig - (sign_hidden ? 1 : 0); i++)
      e.bypass(sig_lev[i] < 0);

    // remaining levels, Golomb-Rice
    int rice = 0;
    for (int i = 0; i < n_sig; i++) {
      int abs_lev = sig_lev[i] < 0 ? -sig_lev[i] : sig_lev[i];
      int base_level = (i < 8) ? ((i == first_c2_idx) ? 3 : 2) : 1;
      if (abs_lev >= base_level) {
        uint32_t rem = abs_lev - base_level;
        // coeff_abs_level_remaining binarization (9.3.3.9)
        if (rem < (3u << rice)) {
          int len = rem >> rice;
          e.bypass_bins((1u << (len + 1)) - 2, len + 1);
          if (rice) e.bypass_bins(rem & ((1u << rice) - 1), rice);
        } else {
          int len = rice;
          uint32_t cn = rem - (3u << rice);
          while (cn >= (1u << len)) {
            cn -= 1u << len;
            len++;
          }
          e.bypass_bins((1u << (3 + len + 1 - rice)) - 2, 3 + len + 1 - rice);
          if (len) e.bypass_bins(cn, len);
        }
      }
      if (abs_lev > (3 << rice) && rice < 4) rice++;
    }
  }
}

static void decode_residual(CabacDec& d, uint8_t* ctx, int16_t* coef,
                            int stride, int log2, int c_idx, int intra_mode,
                            int sbh) {
  ResidualCommon rc;
  rc.setup(log2, c_idx, intra_mode);

  int max_group = (log2 << 1) - 1;
  int blk_off, shift;
  if (c_idx == 0) {
    blk_off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
    shift = (log2 + 1) >> 2;
  } else {
    blk_off = 0;
    shift = log2 - 2;
  }
  int bx = (c_idx == 0) ? CTX_LAST_X_LUMA : CTX_LAST_X_CHROMA;
  int by = (c_idx == 0) ? CTX_LAST_Y_LUMA : CTX_LAST_Y_CHROMA;
  int gx = 0, gy = 0;
  while (gx < max_group && d.bin(ctx, bx + blk_off + (gx >> shift))) gx++;
  while (gy < max_group && d.bin(ctx, by + blk_off + (gy >> shift))) gy++;
  int pos_x = kMinInGroup[gx], pos_y = kMinInGroup[gy];
  if (gx > 3) pos_x += d.bypass_bins((gx >> 1) - 1);
  if (gy > 3) pos_y += d.bypass_bins((gy >> 1) - 1);
  if (rc.scan == 2) { int t = pos_x; pos_x = pos_y; pos_y = t; }

  // find last scan pos from coordinates
  int last_raster = pos_y * rc.n + pos_x;
  int num_coef = rc.n * rc.n;
  int last_scan_pos = 0;
  for (int p = 0; p < num_coef; p++)
    if (rc.cscan[p] == last_raster) {
      last_scan_pos = p;
      break;
    }

  int last_cg = last_scan_pos >> 4;
  std::vector<uint8_t> csbf(rc.num_cg_side * rc.num_cg_side, 0);
  int c1 = 1;
  const int sig_base = (c_idx == 0) ? CTX_SIG_LUMA : CTX_SIG_CHROMA;
  const int one_base = (c_idx == 0) ? CTX_ONE_LUMA : CTX_ONE_CHROMA;
  const int abs_base = (c_idx == 0) ? CTX_ABS_LUMA : CTX_ABS_CHROMA;
  const int cg_base = (c_idx == 0) ? CTX_SIG_CG_LUMA : CTX_SIG_CG_CHROMA;

  for (int cgi = last_cg; cgi >= 0; cgi--) {
    int cg_r = rc.gscan[cgi];
    int cgx = cg_r % rc.num_cg_side, cgy = cg_r / rc.num_cg_side;
    int right = (cgx + 1 < rc.num_cg_side) ? csbf[cg_r + 1] : 0;
    int below = (cgy + 1 < rc.num_cg_side) ? csbf[cg_r + rc.num_cg_side] : 0;
    bool infer_dc = false;
    uint8_t flag = 1;
    if (cgi < last_cg && cgi > 0) {
      flag = (uint8_t)d.bin(ctx, cg_base + ((right | below) ? 1 : 0));
      infer_dc = true;
    }
    csbf[cg_r] = flag;
    if (!flag) continue;

    int sig_pos[16], n_sig = 0;
    int start = (cgi == last_cg) ? (last_scan_pos & 15) : 15;
    if (cgi == last_cg) {
      sig_pos[n_sig++] = last_scan_pos & 15;
      start--;
    }
    for (int p = start; p >= 0; p--) {
      int sp = (cgi << 4) | p;
      int r = rc.cscan[sp];
      int xc = r & (rc.n - 1), yc = r >> log2;
      int sig;
      if (p > 0 || !infer_dc) {
        sig = d.bin(ctx, sig_base + sig_ctx(log2, c_idx, xc, yc, rc.scan,
                                            right, below));
        if (sig) infer_dc = false;
      } else {
        sig = 1;  // inferred DC significance
      }
      if (sig) sig_pos[n_sig++] = p;
    }

    int ctx_set = ((cgi == 0 || c_idx > 0) ? 0 : 2) + (c1 == 0 ? 1 : 0);
    c1 = 1;
    int first_c2_idx = -1;
    int levels[16];
    int num_c1 = n_sig < 8 ? n_sig : 8;
    for (int i = 0; i < n_sig; i++) levels[i] = 1;
    for (int i = 0; i < num_c1; i++) {
      int g1 = d.bin(ctx, one_base + ctx_set * 4 + c1);
      if (g1) {
        levels[i] = 2;
        c1 = 0;
        if (first_c2_idx < 0) first_c2_idx = i;
      } else if (c1 < 3 && c1 > 0) {
        c1++;
      }
    }
    if (first_c2_idx >= 0)
      levels[first_c2_idx] += d.bin(ctx, abs_base + ctx_set);

    bool sign_hidden = sbh && n_sig > 0 &&
                       (sig_pos[0] - sig_pos[n_sig - 1] >= 4);
    int signs[16];
    for (int i = 0; i < n_sig - (sign_hidden ? 1 : 0); i++)
      signs[i] = d.bypass();

    int rice = 0;
    int abs_out[16];
    int64_t abs_sum = 0;
    for (int i = 0; i < n_sig; i++) {
      int base_level = (i < 8) ? ((i == first_c2_idx) ? 3 : 2) : 1;
      int abs_lev = levels[i];
      if (abs_lev >= base_level) {
        // decode coeff_abs_level_remaining
        int prefix = 0;
        while (prefix < 32 && d.bypass()) prefix++;
        uint32_t rem;
        if (prefix < 3) {
          rem = (prefix << rice) + (rice ? d.bypass_bins(rice) : 0);
        } else {
          // escape: rem = cn + 2^len + 2^(rice+1), len = rice + prefix - 3
          int len = prefix - 3 + rice;
          rem = (len ? d.bypass_bins(len) : 0) + (1u << len) +
                (1u << (rice + 1));
        }
        abs_lev = base_level + rem;
      }
      if (abs_lev > (3 << rice) && rice < 4) rice++;
      abs_out[i] = abs_lev;
      abs_sum += abs_lev;
    }
    if (sign_hidden) signs[n_sig - 1] = (int)(abs_sum & 1);
    for (int i = 0; i < n_sig; i++) {
      int sp = (cgi << 4) | sig_pos[i];
      int r = rc.cscan[sp];
      coef[(r >> log2) * stride + (r & (rc.n - 1))] =
          (int16_t)(signs[i] ? -abs_out[i] : abs_out[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Frame-level syntax state shared by encoder/decoder walks.
// ---------------------------------------------------------------------------

struct FrameMaps {
  int sbh = 0;
  int pic_w, pic_h, ctb_log2;
  int max_hier_depth;  // SPS max_transform_hierarchy_depth_intra
  int u8_w, u8_h, u4_w, u4_h;
  uint8_t *depth8, *part8, *mode4, *cmode8, *tu4, *cbf4_y, *cbf8_cb,
      *cbf8_cr;
  int16_t *coef_y, *coef_cb, *coef_cr;
  int stride_y, stride_c;
  // inter / self-similarity extension (ISS/PSS slices)
  int slice_type = 2;    // 2=I, 3=ISS, 4=PSS
  int mi_size = 0;       // vps_holo_microimage_size
  int max_merge = 5;
  int num_ref = 1;       // L0 active refs; for PSS the SS ref is LAST
                         // (TComSlice.cpp:497-506 m_aiRefIdxOfSS)
  uint8_t *ref4 = nullptr;    // ref_idx_l0 per 4x4 unit (inter PUs)
  uint8_t *pred4 = nullptr;   // 1=intra (default), 0=inter, per 4x4 unit
  // SAO per-CTU params (resolved, i.e. post-merge). type: 0=off, 1=BO,
  // 2+class=EO. cr (c=2) shares type/class with cb (c=1) per 7.3.8.3.
  int sao_on = 0;
  uint8_t *sao_merge = nullptr;  // [nctu]: 0=new, 1=merge_left, 2=merge_up
  uint8_t *sao_type = nullptr;   // [nctu*3]
  int16_t *sao_off = nullptr;    // [nctu*3*4]
  uint8_t *sao_band = nullptr;   // [nctu*3]
  uint8_t *skip8 = nullptr;   // cu_skip_flag per 8x8 unit
  uint8_t *merge8 = nullptr;  // 255 = not merge, else merge idx
  uint8_t *mvp8 = nullptr;    // mvp_l0_flag
  uint8_t *gt8 = nullptr;     // gt_flag
  int16_t *mv4x = nullptr, *mv4y = nullptr;  // MV per 4x4, quarter-pel
  int16_t *gtv8 = nullptr;    // [u8][6]: corners 0..2 (hor, ver)
  std::vector<int64_t> zplane; // z-scan address per 4x4 unit

  void build_zplane() {
    zplane.resize((size_t)u4_w * u4_h);
    int cshift = ctb_log2 - 2;
    int nctux = (pic_w + (1 << ctb_log2) - 1) >> ctb_log2;
    for (int uy = 0; uy < u4_h; uy++)
      for (int ux = 0; ux < u4_w; ux++) {
        int64_t ctu = (int64_t)(uy >> cshift) * nctux + (ux >> cshift);
        int lx = ux & ((1 << cshift) - 1), ly = uy & ((1 << cshift) - 1);
        int64_t z = 0;
        for (int b = 0; b < cshift; b++) {
          z |= (int64_t)((lx >> b) & 1) << (2 * b);
          z |= (int64_t)((ly >> b) & 1) << (2 * b + 1);
        }
        zplane[(size_t)uy * u4_w + ux] = (ctu << (2 * cshift)) | z;
      }
  }
  inline int64_t zat(int x, int y) const {
    return zplane[(size_t)(y >> 2) * u4_w + (x >> 2)];
  }
  // neighbor sample availability (z-scan rule, 6.4.1)
  inline bool navail(int x, int y, int64_t zcur) const {
    if (x < 0 || y < 0 || x >= pic_w || y >= pic_h) return false;
    return zat(x, y) < zcur;
  }
  inline bool inter_at(int x, int y) const {
    return pred4 && pred4[(y >> 2) * u4_w + (x >> 2)] == 0;
  }
  inline void mv_at(int x, int y, int& mx, int& my) const {
    mx = mv4x[(y >> 2) * u4_w + (x >> 2)];
    my = mv4y[(y >> 2) * u4_w + (x >> 2)];
  }
  inline int ref_at(int x, int y) const {
    return ref4 ? ref4[(y >> 2) * u4_w + (x >> 2)] : 0;
  }
  inline int ss_ref_idx() const { return num_ref - 1; }

  int cu_depth_at(int x, int y) const { return depth8[(y >> 3) * u8_w + (x >> 3)]; }
  int luma_mode_at(int x, int y) const { return mode4[(y >> 2) * u4_w + (x >> 2)]; }
};

// MPM construction (H.265 8.4.2). Above outside current CTB row -> DC.
static void build_mpm(const FrameMaps& m, int x, int y, int mpm[3]) {
  int cand_a = 1, cand_b = 1;  // DC default
  if (x > 0) cand_a = m.luma_mode_at(x - 1, y);
  if (y > 0 && ((y - 1) >> m.ctb_log2) == (y >> m.ctb_log2))
    cand_b = m.luma_mode_at(x, y - 1);
  if (cand_a == cand_b) {
    if (cand_a < 2) {
      mpm[0] = 0; mpm[1] = 1; mpm[2] = 26;
    } else {
      mpm[0] = cand_a;
      mpm[1] = 2 + ((cand_a + 29) % 32);
      mpm[2] = 2 + ((cand_a - 2 + 1) % 32);
    }
  } else {
    mpm[0] = cand_a;
    mpm[1] = cand_b;
    if (cand_a != 0 && cand_b != 0) mpm[2] = 0;
    else mpm[2] = (cand_a + cand_b < 2) ? 26 : 1;
  }
}

// chroma candidate list (H.265 8.4.3): [planar, ver, hor, dc], luma-dup -> 34
static void chroma_cand_list(int luma_mode, int list[4]) {
  list[0] = 0; list[1] = 26; list[2] = 10; list[3] = 1;
  for (int i = 0; i < 4; i++)
    if (list[i] == luma_mode) { list[i] = 34; break; }
}


// ---------------------------------------------------------------------------
// Inter helpers: merge candidate list (ref TComDataCU::getInterMergeCandidates
// incl. the IT micro-image candidates at 2642-2760) and AMVP (fillMvpCand),
// single-reference (SS) lists, no TMVP.
// ---------------------------------------------------------------------------

struct MvCand { int x = 0, y = 0, ref = 0; };

static inline bool mv_inside_pic(const FrameMaps& m, int cu_x, int cu_y,
                                 int mvx, int mvy) {
  // ref TComDataCU::isMvInsidePic (TComDataCU.cpp:2627): m_uiCUPelX/Y is the
  // CU origin at every merge/AMVP call site (set by initSubCU /
  // copyInterPredInfoFrom before getMI*Cand / fillMvpCand run)
  int maxcu = 1 << m.ctb_log2;
  int hor_max = (m.pic_w + 8 - cu_x - 1) << 2;
  int hor_min = (-maxcu - 8 - cu_x + 1) << 2;
  int ver_max = (m.pic_h + 8 - cu_y - 1) << 2;
  int ver_min = (-maxcu - 8 - cu_y + 1) << 2;
  return mvx >= hor_min && mvx <= hor_max && mvy >= ver_min && mvy <= ver_max;
}

static int build_merge_list(const FrameMaps& m, int x, int y, int n,
                            MvCand out[5]) {
  int64_t zc = m.zat(x, y);
  int count = 0;
  auto add_nb = [&](int nx, int ny) -> bool {
    if (!m.navail(nx, ny, zc) || !m.inter_at(nx, ny)) return false;
    int mx, my;
    m.mv_at(nx, ny, mx, my);
    out[count].x = mx;
    out[count].y = my;
    out[count].ref = m.ref_at(nx, ny);
    return true;
  };
  auto same_as = [&](int nx, int ny, int px, int py) -> bool {
    // hasEqualMotion between two neighbor positions (MV + refIdx)
    int ax, ay, bx_, by_;
    m.mv_at(nx, ny, ax, ay);
    m.mv_at(px, py, bx_, by_);
    return ax == bx_ && ay == by_ && m.ref_at(nx, ny) == m.ref_at(px, py);
  };
  // A1 (left): (x-1, y+n-1)
  bool a1 = m.navail(x - 1, y + n - 1, zc) && m.inter_at(x - 1, y + n - 1);
  if (a1 && add_nb(x - 1, y + n - 1)) count++;
  if (count == m.max_merge) return count;
  // B1 (above): (x+n-1, y-1)
  bool b1 = m.navail(x + n - 1, y - 1, zc) && m.inter_at(x + n - 1, y - 1);
  if (b1 && (!a1 || !same_as(x + n - 1, y - 1, x - 1, y + n - 1)))
    if (add_nb(x + n - 1, y - 1)) count++;
  if (count == m.max_merge) return count;
  // B0 (above-right): (x+n, y-1)
  bool b0 = m.navail(x + n, y - 1, zc) && m.inter_at(x + n, y - 1);
  if (b0 && (!b1 || !same_as(x + n, y - 1, x + n - 1, y - 1)))
    if (add_nb(x + n, y - 1)) count++;
  if (count == m.max_merge) return count;
  // A0 (below-left): (x-1, y+n)
  bool a0 = m.navail(x - 1, y + n, zc) && m.inter_at(x - 1, y + n);
  if (a0 && (!a1 || !same_as(x - 1, y + n, x - 1, y + n - 1)))
    if (add_nb(x - 1, y + n)) count++;
  if (count == m.max_merge) return count;
  // B2 (above-left) only if count < 4
  if (count < 4) {
    bool b2 = m.navail(x - 1, y - 1, zc) && m.inter_at(x - 1, y - 1);
    if (b2 && (!a1 || !same_as(x - 1, y - 1, x - 1, y + n - 1))
        && (!b1 || !same_as(x - 1, y - 1, x + n - 1, y - 1)))
      if (add_nb(x - 1, y - 1)) count++;
  }
  if (count == m.max_merge) return count;
  // IT micro-image candidates (MIMergeCand) — always on the SS reference
  if (m.mi_size > 0) {
    int ctb = 1 << m.ctb_log2;
    int ssr = m.ss_ref_idx();
    int shift = (n + m.mi_size - 1) / m.mi_size;  // ceil
    // left MI: available when PU not on the CTU's left column
    if (count < 4 && (x % ctb) != 0) {
      int mvx = -(shift * m.mi_size) << 2, mvy = 0;
      if (mv_inside_pic(m, x, y, mvx, mvy)) {
        out[count].x = mvx;
        out[count].y = mvy;
        out[count].ref = ssr;
        count++;
      }
    }
    if (count < m.max_merge && count < 4 && (y % ctb) != 0) {
      int mvx = 0, mvy = -(shift * m.mi_size) << 2;
      if (mv_inside_pic(m, x, y, mvx, mvy)) {
        out[count].x = mvx;
        out[count].y = mvy;
        out[count].ref = ssr;
        count++;
      }
    }
    if (count < m.max_merge && count < 4 && (x % ctb) != 0) {
      int mvx = -(shift * m.mi_size) << 2;
      int mvy = -(shift * m.mi_size) << 2;
      if (mv_inside_pic(m, x, y, mvx, mvy)) {
        out[count].x = mvx;
        out[count].y = mvy;
        out[count].ref = ssr;
        count++;
      }
    }
  }
  // zero fill, cycling ref idx as the HM zero-merge candidates do
  int zr = 0;
  while (count < m.max_merge) {
    out[count].x = 0;
    out[count].y = 0;
    out[count].ref = zr < m.num_ref ? zr : 0;
    zr++;
    count++;
  }
  return count;
}

static void build_amvp(const FrameMaps& m, int x, int y, int n,
                       MvCand out[2], int ref = 0) {
  // ref TComDataCU::fillMvpCand (TComDataCU.cpp:3297) with the IT rules of
  // xAddMVPCand (:3700-3712): a spatial neighbour predicts only if its
  // vector type matches the target's (SS vs temporal, POC-equality test),
  // and the MI co-located candidate fills a free slot when the target is
  // the SS reference (:3783-3800). Scaling is always identity here (one
  // temporal ref at POC-1, or the SS ref at the current POC -> 4096).
  int64_t zc = m.zat(x, y);
  int count = 0;
  bool target_ss = ref == m.ss_ref_idx();
  auto try_pos = [&](int nx, int ny) -> bool {
    if (!m.navail(nx, ny, zc) || !m.inter_at(nx, ny)) return false;
    if ((m.ref_at(nx, ny) == m.ss_ref_idx()) != target_ss) return false;
    int mx, my;
    m.mv_at(nx, ny, mx, my);
    out[count].x = mx;
    out[count].y = my;
    return true;
  };
  // left candidate: A0 (x-1, y+n) then A1 (x-1, y+n-1)
  if (try_pos(x - 1, y + n)) count++;
  else if (try_pos(x - 1, y + n - 1)) count++;
  // above candidate: B0 (x+n, y-1), B1 (x+n-1, y-1), B2 (x-1, y-1)
  if (try_pos(x + n, y - 1)) count++;
  else if (try_pos(x + n - 1, y - 1)) count++;
  else if (try_pos(x - 1, y - 1)) count++;
  // duplicate removal (fillMvpCand iN==2 check)
  if (count == 2 && out[0].x == out[1].x && out[0].y == out[1].y) count = 1;
  // MI co-located predictor: first available of left/above/above-left,
  // only when predicting INTO the SS reference (xAddMVPCand MI overload)
  if (m.mi_size > 0 && count < 2 && target_ss) {
    int ctb = 1 << m.ctb_log2;
    int shift = (n + m.mi_size - 1) / m.mi_size;  // ceil
    int d = -(shift * m.mi_size) << 2;
    struct { bool avail; int mx, my; } mi[3] = {
        {(x % ctb) != 0, d, 0},        // MD_MI_LEFT
        {(y % ctb) != 0, 0, d},        // MD_MI_ABOVE
        {(x % ctb) != 0, d, d},        // MD_MI_ABOVE_LEFT
    };
    for (auto& c : mi) {
      if (c.avail && mv_inside_pic(m, x, y, c.mx, c.my)) {
        out[count].x = c.mx;
        out[count].y = c.my;
        count++;
        break;
      }
    }
    if (count == 2 && out[0].x == out[1].x && out[0].y == out[1].y)
      count = 1;
  }
  while (count < 2) {
    out[count].x = 0;
    out[count].y = 0;
    count++;
  }
}

// ===========================================================================
// ENCODER walk
// ===========================================================================

struct SliceEncoder {
  FrameMaps m;
  CabacEnc e;
  uint8_t* ctx;

  int cbf_cb_area(int x, int y, int size) const {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 8)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 8)
        if (m.cbf8_cb[(yy >> 3) * m.u8_w + (xx >> 3)]) return 1;
    return 0;
  }
  int cbf_cr_area(int x, int y, int size) const {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 8)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 8)
        if (m.cbf8_cr[(yy >> 3) * m.u8_w + (xx >> 3)]) return 1;
    return 0;
  }
  int cbf_y_area(int x, int y, int size) const {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 4)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 4)
        if (m.cbf4_y[(yy >> 2) * m.u4_w + (xx >> 2)]) return 1;
    return 0;
  }

  void residual_luma(int x, int y, int log2) {
    encode_residual(e, ctx, m.coef_y + (int64_t)y * m.stride_y + x, m.stride_y,
                    log2, 0, m.luma_mode_at(x, y), m.sbh);
  }
  void residual_chroma(int x, int y, int log2c, int c_idx) {
    // x,y luma coords of the chroma TU origin (times two of chroma coords)
    int cmode = m.cmode8[(y >> 3) * m.u8_w + (x >> 3)];
    if (cmode == 36) cmode = m.luma_mode_at(x, y);
    int16_t* plane = c_idx == 1 ? m.coef_cb : m.coef_cr;
    encode_residual(e, ctx,
                    plane + (int64_t)(y >> 1) * m.stride_c + (x >> 1),
                    m.stride_c, log2c, c_idx, cmode, m.sbh);
  }

  // returns nothing; maps fully describe the tree (tu4 = desired TU log2)
  void transform_tree(int x, int y, int log2, int td, bool intra_split,
                      int parent_cb, int parent_cr, int blk_idx,
                      int xbase, int ybase, bool is_intra = true) {
    int size = 1 << log2;
    int max_td = m.max_hier_depth + (intra_split ? 1 : 0);
    bool split;
    if (log2 > 5) split = true;
    else if (intra_split && td == 0) split = true;
    else if (log2 == 2) split = false;
    else if (td >= max_td) split = false;
    else {
      // signaled split_transform_flag (H.265 7.3.8.8)
      split = m.tu4[(y >> 2) * m.u4_w + (x >> 2)] < log2;
      e.bin(ctx, CTX_TRANS_SUBDIV + 5 - log2, split);
    }

    int cbf_cb = parent_cb, cbf_cr = parent_cr;
    if (log2 > 2) {
      cbf_cb = cbf_cb_area(x, y, size);
      cbf_cr = cbf_cr_area(x, y, size);
      if (td == 0 || parent_cb)
        e.bin(ctx, CTX_QT_CBF_CHROMA + td, cbf_cb);
      else cbf_cb = 0;
      if (td == 0 || parent_cr)
        e.bin(ctx, CTX_QT_CBF_CHROMA + td, cbf_cr);
      else cbf_cr = 0;
    }

    if (split) {
      int h = size >> 1;
      transform_tree(x, y, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 0, x, y, is_intra);
      transform_tree(x + h, y, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 1, x, y, is_intra);
      transform_tree(x, y + h, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 2, x, y, is_intra);
      transform_tree(x + h, y + h, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 3, x, y, is_intra);
      return;
    }

    int cbf_luma = cbf_y_area(x, y, size);
    if (is_intra || td != 0 || cbf_cb || cbf_cr)
      e.bin(ctx, CTX_QT_CBF_LUMA + (td == 0 ? 1 : 0), cbf_luma);
    // else: inferred 1 (inter leaf at td0 with no chroma cbf)
    if (cbf_luma) residual_luma(x, y, log2);
    if (log2 > 2) {
      if (cbf_cb) residual_chroma(x, y, log2 - 1, 1);
      if (cbf_cr) residual_chroma(x, y, log2 - 1, 2);
    } else if (blk_idx == 3) {
      if (parent_cb) residual_chroma(xbase, ybase, 2, 1);
      if (parent_cr) residual_chroma(xbase, ybase, 2, 2);
    }
  }

  void ep_exgolomb(uint32_t sym, int count) {
    while (sym >= (1u << count)) {
      e.bypass(1);
      sym -= 1u << count;
      count++;
    }
    e.bypass(0);
    while (count--) e.bypass((sym >> count) & 1);
  }

  void code_mvd(int hor, int ver) {
    e.bin(ctx, CTX_MVD + 0, hor != 0);
    e.bin(ctx, CTX_MVD + 0, ver != 0);
    int ah = hor < 0 ? -hor : hor, av = ver < 0 ? -ver : ver;
    if (hor) e.bin(ctx, CTX_MVD + 1, ah > 1);
    if (ver) e.bin(ctx, CTX_MVD + 1, av > 1);
    if (hor) {
      if (ah > 1) ep_exgolomb(ah - 2, 1);
      e.bypass(hor < 0);
    }
    if (ver) {
      if (av > 1) ep_exgolomb(av - 2, 1);
      e.bypass(ver < 0);
    }
  }

  void code_merge_idx(int idx) {
    int num = m.max_merge;
    if (num <= 1) return;
    for (int ui = 0; ui < num - 1; ui++) {
      int sym = (ui == idx) ? 0 : 1;
      if (ui == 0) e.bin(ctx, CTX_MERGE_IDX, sym);
      else e.bypass(sym);
      if (!sym) break;
    }
  }

  void code_gt(int u8i, bool gtflag) {
    // ref TEncSbac::codeGT (affine: corners 0..2 coded, corner 3 derived)
    if (!gtflag) return;
    const int16_t* v = m.gtv8 + (size_t)u8i * 6;
    for (int c = 0; c < 3; c++) {
      e.bin(ctx, CTX_GT_RES + 0, v[2 * c] != 0);
      e.bin(ctx, CTX_GT_RES + 0, v[2 * c + 1] != 0);
    }
    for (int c = 0; c < 3; c++) {
      int ah = v[2 * c] < 0 ? -v[2 * c] : v[2 * c];
      int av = v[2 * c + 1] < 0 ? -v[2 * c + 1] : v[2 * c + 1];
      if (v[2 * c]) e.bin(ctx, CTX_GT_RES + 1, ah > 1);
      if (v[2 * c + 1]) e.bin(ctx, CTX_GT_RES + 1, av > 1);
    }
    for (int c = 0; c < 3; c++) {
      int ah = v[2 * c] < 0 ? -v[2 * c] : v[2 * c];
      int av = v[2 * c + 1] < 0 ? -v[2 * c + 1] : v[2 * c + 1];
      if (v[2 * c]) {
        if (ah > 1) ep_exgolomb(ah - 2, 1);
        e.bypass(v[2 * c] < 0);
      }
      if (v[2 * c + 1]) {
        if (av > 1) ep_exgolomb(av - 2, 1);
        e.bypass(v[2 * c + 1] < 0);
      }
    }
  }

  void code_ref_idx(int ref) {
    // ref_idx_l0 unary (TEncSbac::codeRefFrmIdx), present when >1 ref
    if (m.num_ref <= 1) return;
    e.bin(ctx, CTX_REF_PIC, ref > 0);
    for (int i = 1; ref > 0 && i < m.num_ref - 1; i++) {
      int more = ref > i;
      e.bin(ctx, CTX_REF_PIC + 1, more);
      if (!more) break;
    }
  }

  void code_inter_cu(int x, int y, int log2, bool skip) {
    int size = 1 << log2;
    int u8i = (y >> 3) * m.u8_w + (x >> 3);
    int mvx, mvy;
    m.mv_at(x, y, mvx, mvy);
    int ref = m.ref_at(x, y);
    bool gt = m.gt8 && m.gt8[u8i];
    MvCand mrg[5];
    build_merge_list(m, x, y, size, mrg);
    int merge_idx = -1;
    if (!gt) {
      for (int i = 0; i < m.max_merge; i++)
        if (mrg[i].x == mvx && mrg[i].y == mvy && mrg[i].ref == ref) {
          merge_idx = i;
          break;
        }
    }
    int cbf_any = cbf_y_area(x, y, size) | cbf_cb_area(x, y, size) |
                  cbf_cr_area(x, y, size);
    if (skip) {
      // caller already coded cu_skip_flag=1
      code_merge_idx(merge_idx);
      for (int yy = y; yy < y + size && yy < m.pic_h; yy += 8)
        for (int xx = x; xx < x + size && xx < m.pic_w; xx += 8)
          m.skip8[(yy >> 3) * m.u8_w + (xx >> 3)] = 1;
      return;
    }
    e.bin(ctx, CTX_PRED_MODE, 0);       // inter
    e.bin(ctx, CTX_PART_SIZE, 1);       // 2Nx2N
    e.bin(ctx, CTX_MERGE_FLAG, merge_idx >= 0);
    if (merge_idx >= 0) {
      code_merge_idx(merge_idx);
    } else {
      code_ref_idx(ref);
      MvCand amvp[2];
      build_amvp(m, x, y, size, amvp, ref);
      // pick the cheaper predictor
      int c0 = (mvx - amvp[0].x < 0 ? -(mvx - amvp[0].x) : mvx - amvp[0].x)
             + (mvy - amvp[0].y < 0 ? -(mvy - amvp[0].y) : mvy - amvp[0].y);
      int c1 = (mvx - amvp[1].x < 0 ? -(mvx - amvp[1].x) : mvx - amvp[1].x)
             + (mvy - amvp[1].y < 0 ? -(mvy - amvp[1].y) : mvy - amvp[1].y);
      int mvp = c1 < c0 ? 1 : 0;
      code_mvd(mvx - amvp[mvp].x, mvy - amvp[mvp].y);
      e.bin(ctx, CTX_MVP_IDX, mvp);
      // gt_flag + GT vectors follow EVERY non-merge PU, temporal or SS
      // (TEncEntropy.cpp:475-476 / TDecEntropy.cpp:251-252, size limit 0)
      e.bin(ctx, CTX_GT_FLAG, gt ? 1 : 0);
      code_gt(u8i, gt);
    }
    if (merge_idx < 0) {
      e.bin(ctx, CTX_QT_ROOT_CBF, cbf_any);
    }  // merge 2Nx2N non-skip: rqt_root_cbf inferred 1
    if (cbf_any || merge_idx >= 0)
      transform_tree(x, y, log2, 0, false, 0, 0, 0, x, y, false);
  }

  bool can_skip(int x, int y, int log2) {
    // skip = inter 2Nx2N whose motion is a merge candidate, gt off,
    // no residual
    int size = 1 << log2;
    int u8i = (y >> 3) * m.u8_w + (x >> 3);
    if (m.pred4[(y >> 2) * m.u4_w + (x >> 2)] != 0) return false;
    if (m.gt8 && m.gt8[u8i]) return false;
    if (cbf_y_area(x, y, size) || cbf_cb_area(x, y, size) ||
        cbf_cr_area(x, y, size))
      return false;
    int mvx, mvy;
    m.mv_at(x, y, mvx, mvy);
    int ref = m.ref_at(x, y);
    MvCand mrg[5];
    build_merge_list(m, x, y, size, mrg);
    for (int i = 0; i < m.max_merge; i++)
      if (mrg[i].x == mvx && mrg[i].y == mvy && mrg[i].ref == ref)
        return true;
    return false;
  }

  void code_cu(int x, int y, int log2) {
    if (m.slice_type >= 3) {
      // inter-capable slice: cu_skip_flag first
      int64_t zc = m.zat(x, y);
      int ctxi = 0;
      if (m.navail(x - 1, y, zc)
          && m.skip8[(y >> 3) * m.u8_w + ((x - 1) >> 3)]) ctxi++;
      if (m.navail(x, y - 1, zc)
          && m.skip8[((y - 1) >> 3) * m.u8_w + (x >> 3)]) ctxi++;
      bool skip = can_skip(x, y, log2);
      e.bin(ctx, CTX_SKIP + ctxi, skip);
      if (skip) {
        code_inter_cu(x, y, log2, true);
        return;
      }
      if (m.pred4[(y >> 2) * m.u4_w + (x >> 2)] == 0) {
        code_inter_cu(x, y, log2, false);
        return;
      }
      e.bin(ctx, CTX_PRED_MODE, 1);  // intra
    }
    int part_nxn = 0;
    if (log2 == 3) {  // min CU: part_mode present
      part_nxn = m.part8[(y >> 3) * m.u8_w + (x >> 3)] == 3;
      e.bin(ctx, CTX_PART_SIZE, !part_nxn);
    }
    int n_pu = part_nxn ? 4 : 1, pu_size = part_nxn ? (1 << (log2 - 1)) : (1 << log2);
    int modes[4], mpms[4][3], in_mpm[4], mpm_idx[4];
    for (int i = 0; i < n_pu; i++) {
      int px = x + (i & 1) * pu_size, py = y + (i >> 1) * pu_size;
      modes[i] = m.luma_mode_at(px, py);
      build_mpm(m, px, py, mpms[i]);
      in_mpm[i] = 0;
      for (int k = 0; k < 3; k++)
        if (mpms[i][k] == modes[i]) { in_mpm[i] = 1; mpm_idx[i] = k; }
      e.bin(ctx, CTX_INTRA_MODE, in_mpm[i]);
    }
    for (int i = 0; i < n_pu; i++) {
      if (in_mpm[i]) {
        e.bypass(mpm_idx[i] > 0);
        if (mpm_idx[i] > 0) e.bypass(mpm_idx[i] - 1);
      } else {
        // sort mpm descending, subtract
        int a = mpms[i][0], b = mpms[i][1], c = mpms[i][2], t;
        if (a > b) { t = a; a = b; b = t; }
        if (a > c) { t = a; a = c; c = t; }
        if (b > c) { t = b; b = c; c = t; }
        int rem = modes[i];
        if (rem > c) rem--;
        if (rem > b) rem--;
        if (rem > a) rem--;
        e.bypass_bins(rem, 5);
      }
    }
    // chroma mode (single PU for 4:2:0)
    int cmode = m.cmode8[(y >> 3) * m.u8_w + (x >> 3)];
    if (cmode == 36) {
      e.bin(ctx, CTX_CHROMA_MODE, 0);
    } else {
      int list[4];
      chroma_cand_list(modes[0], list);
      int idx = 0;
      for (int k = 0; k < 4; k++)
        if (list[k] == cmode) idx = k;
      e.bin(ctx, CTX_CHROMA_MODE, 1);
      e.bypass_bins(idx, 2);
    }
    transform_tree(x, y, log2, 0, part_nxn, 0, 0, 0, x, y);
  }

  void quad(int x, int y, int log2) {
    int size = 1 << log2;
    bool inside = (x + size <= m.pic_w) && (y + size <= m.pic_h);
    int depth_here = m.cu_depth_at(x, y);
    int my_depth = m.ctb_log2 - log2;
    if (inside && log2 > 3) {
      // split_cu_flag with neighbor-depth context
      int ctx_inc = 0;
      if (x > 0 && m.cu_depth_at(x - 1, y) > my_depth) ctx_inc++;
      if (y > 0 && m.cu_depth_at(x, y - 1) > my_depth) ctx_inc++;
      e.bin(ctx, CTX_SPLIT_FLAG + ctx_inc, depth_here > my_depth);
    }
    bool split = inside ? (depth_here > my_depth) : (log2 > 3);
    if (split) {
      int h = size >> 1;
      if (x < m.pic_w && y < m.pic_h) quad(x, y, log2 - 1);
      if (x + h < m.pic_w && y < m.pic_h) quad(x + h, y, log2 - 1);
      if (x < m.pic_w && y + h < m.pic_h) quad(x, y + h, log2 - 1);
      if (x + h < m.pic_w && y + h < m.pic_h) quad(x + h, y + h, log2 - 1);
    } else if (inside || (x < m.pic_w && y < m.pic_h)) {
      code_cu(x, y, log2);
    }
  }

  void tr_bypass(int v, int cmax) {
    for (int k = 0; k < v; k++) e.bypass(1);
    if (v < cmax) e.bypass(0);
  }

  void code_sao(int cx, int cy, int nx) {
    // sao() syntax, H.265 7.3.8.3 (ref TEncSbac + TEncSampleAdaptiveOffset)
    int i = cy * nx + cx;
    int mrg = m.sao_merge[i];
    if (cx > 0) e.bin(ctx, CTX_SAO_MERGE, mrg == 1);
    if (mrg != 1 && cy > 0) e.bin(ctx, CTX_SAO_MERGE, mrg == 2);
    if (mrg) return;
    for (int c = 0; c < 3; c++) {
      uint8_t t = m.sao_type[(size_t)i * 3 + c];
      if (c < 2) {
        e.bin(ctx, CTX_SAO_TYPE, t != 0);
        if (t != 0) e.bypass(t >= 2);  // 0 = BO, 1 = EO
      } else {
        t = m.sao_type[(size_t)i * 3 + 1];  // cr inherits cb
      }
      if (t == 0) continue;
      const int16_t* off = m.sao_off + ((size_t)i * 3 + c) * 4;
      for (int k = 0; k < 4; k++)
        tr_bypass(off[k] < 0 ? -off[k] : off[k], 7);
      if (t == 1) {  // BO: explicit signs + band position
        for (int k = 0; k < 4; k++)
          if (off[k]) e.bypass(off[k] < 0);
        for (int b = 4; b >= 0; b--)
          e.bypass((m.sao_band[(size_t)i * 3 + c] >> b) & 1);
      } else if (c < 2) {  // EO class (cr inherits cb)
        e.bypass(((t - 2) >> 1) & 1);
        e.bypass((t - 2) & 1);
      }
    }
  }

  int64_t run(std::vector<uint8_t>* out) {
    e.out = out;
    int ctb = 1 << m.ctb_log2;
    int n_ctu_x = (m.pic_w + ctb - 1) >> m.ctb_log2;
    int n_ctu_y = (m.pic_h + ctb - 1) >> m.ctb_log2;
    for (int cy = 0; cy < n_ctu_y; cy++)
      for (int cx = 0; cx < n_ctu_x; cx++) {
        if (m.sao_on) code_sao(cx, cy, n_ctu_x);
        quad(cx << m.ctb_log2, cy << m.ctb_log2, m.ctb_log2);
        bool last = (cy == n_ctu_y - 1) && (cx == n_ctu_x - 1);
        e.terminate(last);
        if (last) {
          e.finish();
          e.byte_align_with_stop_bit();
        }
      }
    return (int64_t)out->size();
  }

  // WPP (entropy_coding_sync_enabled_flag, H.265 7.3.8.1): one substream
  // per CTU row; each row's contexts start from the snapshot taken after
  // the 2nd CTU of the row above (TEncSlice.cpp:1158-1160 analog). Rows
  // are coded by worker threads pipelined on the snapshot + the 2-CTU
  // skip-map lag (the encoder writes skip8 as it walks).
  int64_t run_wpp(std::vector<uint8_t>* out, const uint8_t* init_ctx,
                  int64_t* sub_sizes, int nthreads) {
    int ctb = 1 << m.ctb_log2;
    int nx = (m.pic_w + ctb - 1) >> m.ctb_log2;
    int ny = (m.pic_h + ctb - 1) >> m.ctb_log2;
    int sync_col = nx > 1 ? 1 : 0;
    std::vector<std::vector<uint8_t>> bufs(ny), snap(ny);
    std::vector<std::atomic<int>> prog(ny);
    std::vector<std::atomic<int>> snap_ready(ny);
    for (int i = 0; i < ny; i++) {
      prog[i].store(0);
      snap_ready[i].store(0);
    }

    auto encode_row = [&](int cy) {
      SliceEncoder rse;
      rse.m = m;
      rse.e.out = &bufs[cy];
      std::vector<uint8_t> ctxv;
      if (cy == 0) {
        ctxv.assign(init_ctx, init_ctx + NUM_CTX);
      } else {
        while (!snap_ready[cy - 1].load(std::memory_order_acquire))
          std::this_thread::yield();
        ctxv = snap[cy - 1];
      }
      rse.ctx = ctxv.data();
      for (int cx = 0; cx < nx; cx++) {
        if (cy > 0) {
          int need = cx + 2 < nx ? cx + 2 : nx;
          while (prog[cy - 1].load(std::memory_order_acquire) < need)
            std::this_thread::yield();
        }
        if (m.sao_on) rse.code_sao(cx, cy, nx);
        rse.quad(cx << m.ctb_log2, cy << m.ctb_log2, m.ctb_log2);
        bool last = (cy == ny - 1) && (cx == nx - 1);
        rse.e.terminate(last);
        if (cx == sync_col && cy + 1 < ny) {
          snap[cy] = ctxv;
          snap_ready[cy].store(1, std::memory_order_release);
        }
        prog[cy].store(cx + 1, std::memory_order_release);
        if (last) {
          rse.e.finish();
          rse.e.byte_align_with_stop_bit();
        }
      }
      if (cy != ny - 1) {
        rse.e.terminate(1);   // end_of_subset_one_bit
        rse.e.finish();
        rse.e.byte_align_with_stop_bit();
      }
    };

    if (nthreads <= 1 || ny <= 1) {
      for (int cy = 0; cy < ny; cy++) encode_row(cy);
    } else {
      int nt = nthreads < ny ? nthreads : ny;
      std::vector<std::thread> ts;
      for (int t = 0; t < nt; t++)
        ts.emplace_back([&, t] {
          for (int cy = t; cy < ny; cy += nt) encode_row(cy);
        });
      for (auto& th : ts) th.join();
    }
    for (int cy = 0; cy < ny; cy++) {
      sub_sizes[cy] = (int64_t)bufs[cy].size();
      out->insert(out->end(), bufs[cy].begin(), bufs[cy].end());
    }
    return (int64_t)out->size();
  }
};

// ===========================================================================
// DECODER walk
// ===========================================================================

struct SliceDecoder {
  FrameMaps m;
  CabacDec d;
  uint8_t* ctx;

  void set_depth(int x, int y, int size, uint8_t depth) {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 8)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 8)
        m.depth8[(yy >> 3) * m.u8_w + (xx >> 3)] = depth;
  }
  void set_mode(int x, int y, int size, uint8_t mode) {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 4)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 4)
        m.mode4[(yy >> 2) * m.u4_w + (xx >> 2)] = mode;
  }
  void set_cbf_y(int x, int y, int size, uint8_t v) {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 4)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 4)
        m.cbf4_y[(yy >> 2) * m.u4_w + (xx >> 2)] = v;
  }
  void set_cbf_c(uint8_t* map8, int x, int y, int size, uint8_t v) {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 8)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 8)
        map8[(yy >> 3) * m.u8_w + (xx >> 3)] = v;
  }

  void residual_luma(int x, int y, int log2) {
    decode_residual(d, ctx, m.coef_y + (int64_t)y * m.stride_y + x, m.stride_y,
                    log2, 0, m.luma_mode_at(x, y), m.sbh);
  }
  void residual_chroma(int x, int y, int log2c, int c_idx) {
    int cmode = m.cmode8[(y >> 3) * m.u8_w + (x >> 3)];
    if (cmode == 36) cmode = m.luma_mode_at(x, y);
    int16_t* plane = c_idx == 1 ? m.coef_cb : m.coef_cr;
    decode_residual(d, ctx,
                    plane + (int64_t)(y >> 1) * m.stride_c + (x >> 1),
                    m.stride_c, log2c, c_idx, cmode, m.sbh);
  }

  void transform_tree(int x, int y, int log2, int td, bool intra_split,
                      int parent_cb, int parent_cr, int blk_idx,
                      int xbase, int ybase, bool is_intra = true) {
    int size = 1 << log2;
    int max_td = m.max_hier_depth + (intra_split ? 1 : 0);
    bool split;
    if (log2 > 5) split = true;
    else if (intra_split && td == 0) split = true;
    else if (log2 == 2) split = false;
    else if (td >= max_td) split = false;
    else split = d.bin(ctx, CTX_TRANS_SUBDIV + 5 - log2);

    int cbf_cb = parent_cb, cbf_cr = parent_cr;
    if (log2 > 2) {
      if (td == 0 || parent_cb) cbf_cb = d.bin(ctx, CTX_QT_CBF_CHROMA + td);
      else cbf_cb = 0;
      if (td == 0 || parent_cr) cbf_cr = d.bin(ctx, CTX_QT_CBF_CHROMA + td);
      else cbf_cr = 0;
    }

    if (split) {
      int h = size >> 1;
      transform_tree(x, y, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 0, x, y, is_intra);
      transform_tree(x + h, y, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 1, x, y, is_intra);
      transform_tree(x, y + h, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 2, x, y, is_intra);
      transform_tree(x + h, y + h, log2 - 1, td + 1, intra_split, cbf_cb, cbf_cr, 3, x, y, is_intra);
      return;
    }

    int cbf_luma = 1;  // inferred for inter leaf at td0 w/o chroma cbf
    if (is_intra || td != 0 || cbf_cb || cbf_cr)
      cbf_luma = d.bin(ctx, CTX_QT_CBF_LUMA + (td == 0 ? 1 : 0));
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 4)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 4)
        m.tu4[(yy >> 2) * m.u4_w + (xx >> 2)] = (uint8_t)log2;
    set_cbf_y(x, y, size, (uint8_t)cbf_luma);
    if (cbf_luma) residual_luma(x, y, log2);
    if (log2 > 2) {
      set_cbf_c(m.cbf8_cb, x, y, size, (uint8_t)cbf_cb);
      set_cbf_c(m.cbf8_cr, x, y, size, (uint8_t)cbf_cr);
      if (cbf_cb) residual_chroma(x, y, log2 - 1, 1);
      if (cbf_cr) residual_chroma(x, y, log2 - 1, 2);
    } else if (blk_idx == 3) {
      set_cbf_c(m.cbf8_cb, xbase, ybase, size * 2, (uint8_t)parent_cb);
      set_cbf_c(m.cbf8_cr, xbase, ybase, size * 2, (uint8_t)parent_cr);
      if (parent_cb) residual_chroma(xbase, ybase, 2, 1);
      if (parent_cr) residual_chroma(xbase, ybase, 2, 2);
    }
  }

  int dec_ep_exgolomb(int count) {
    uint32_t sym = 0;
    while (d.bypass()) {
      sym += 1u << count;
      count++;
    }
    while (count--)
      if (d.bypass()) sym += 1u << count;
    return (int)sym;
  }

  void dec_mvd(int& hor, int& ver) {
    int g0h = d.bin(ctx, CTX_MVD + 0);
    int g0v = d.bin(ctx, CTX_MVD + 0);
    int g1h = g0h ? d.bin(ctx, CTX_MVD + 1) : 0;
    int g1v = g0v ? d.bin(ctx, CTX_MVD + 1) : 0;
    hor = ver = 0;
    if (g0h) {
      int a = g1h ? 2 + dec_ep_exgolomb(1) : 1;
      hor = d.bypass() ? -a : a;
    }
    if (g0v) {
      int a = g1v ? 2 + dec_ep_exgolomb(1) : 1;
      ver = d.bypass() ? -a : a;
    }
  }

  int dec_merge_idx() {
    int num = m.max_merge;
    if (num <= 1) return 0;
    int idx = 0;
    if (d.bin(ctx, CTX_MERGE_IDX)) {
      idx++;
      for (; idx < num - 1; idx++)
        if (!d.bypass()) break;
    }
    return idx;
  }

  void dec_gt(int u8i, bool gtflag) {
    int16_t* v = m.gtv8 + (size_t)u8i * 6;
    for (int k = 0; k < 6; k++) v[k] = 0;
    if (!gtflag) return;
    int g0[6], g1[6] = {0, 0, 0, 0, 0, 0};
    for (int k = 0; k < 6; k++) g0[k] = d.bin(ctx, CTX_GT_RES + 0);
    for (int k = 0; k < 6; k++)
      if (g0[k]) g1[k] = d.bin(ctx, CTX_GT_RES + 1);
    for (int k = 0; k < 6; k++) {
      if (!g0[k]) continue;
      int a = g1[k] ? 2 + dec_ep_exgolomb(1) : 1;
      v[k] = (int16_t)(d.bypass() ? -a : a);
    }
  }

  void set_inter_maps(int x, int y, int size, int mvx, int mvy,
                      int ref = 0) {
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 4)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 4) {
        size_t u = (size_t)(yy >> 2) * m.u4_w + (xx >> 2);
        m.pred4[u] = 0;
        m.mv4x[u] = (int16_t)mvx;
        m.mv4y[u] = (int16_t)mvy;
        if (m.ref4) m.ref4[u] = (uint8_t)ref;
        m.mode4[u] = 1;  // DC for MPM/scan purposes
      }
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 8)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 8)
        m.cmode8[(yy >> 3) * m.u8_w + (xx >> 3)] = 36;
  }

  int dec_ref_idx() {
    if (m.num_ref <= 1) return 0;
    if (!d.bin(ctx, CTX_REF_PIC)) return 0;
    int ref = 1;
    for (int i = 1; i < m.num_ref - 1; i++) {
      if (!d.bin(ctx, CTX_REF_PIC + 1)) break;
      ref++;
    }
    return ref;
  }

  void dec_inter_cu(int x, int y, int log2, bool skip) {
    int size = 1 << log2;
    int u8i = (y >> 3) * m.u8_w + (x >> 3);
    int mvx = 0, mvy = 0, ref = 0;
    if (skip) {
      int idx = dec_merge_idx();
      MvCand mrg[5];
      build_merge_list(m, x, y, size, mrg);
      mvx = mrg[idx].x;
      mvy = mrg[idx].y;
      ref = mrg[idx].ref;
      for (int yy = y; yy < y + size && yy < m.pic_h; yy += 8)
        for (int xx = x; xx < x + size && xx < m.pic_w; xx += 8)
          m.skip8[(yy >> 3) * m.u8_w + (xx >> 3)] = 1;
      m.merge8[u8i] = (uint8_t)idx;
      set_inter_maps(x, y, size, mvx, mvy, ref);
      set_cbf_y(x, y, size, 0);
      set_cbf_c(m.cbf8_cb, x, y, size, 0);
      set_cbf_c(m.cbf8_cr, x, y, size, 0);
      for (int yy = y; yy < y + size && yy < m.pic_h; yy += 4)
        for (int xx = x; xx < x + size && xx < m.pic_w; xx += 4)
          m.tu4[(yy >> 2) * m.u4_w + (xx >> 2)] = (uint8_t)log2;
      return;
    }
    // part_mode (inter): first bin 1 -> 2Nx2N
    int b0 = d.bin(ctx, CTX_PART_SIZE);
    if (!b0) {
      // non-2Nx2N inter partitions unsupported in this build
      d.size = -1;  // force desync error
      return;
    }
    int merge = d.bin(ctx, CTX_MERGE_FLAG);
    bool gt = false;
    if (merge) {
      int idx = dec_merge_idx();
      MvCand mrg[5];
      build_merge_list(m, x, y, size, mrg);
      mvx = mrg[idx].x;
      mvy = mrg[idx].y;
      ref = mrg[idx].ref;
      m.merge8[u8i] = (uint8_t)idx;
      dec_gt(u8i, false);
    } else {
      ref = dec_ref_idx();
      int mdx, mdy;
      dec_mvd(mdx, mdy);
      int mvp = d.bin(ctx, CTX_MVP_IDX);
      MvCand amvp[2];
      build_amvp(m, x, y, size, amvp, ref);
      mvx = amvp[mvp].x + mdx;
      mvy = amvp[mvp].y + mdy;
      m.mvp8[u8i] = (uint8_t)mvp;
      m.merge8[u8i] = 255;
      // gt_flag follows EVERY non-merge PU (TDecEntropy.cpp:251-252)
      gt = d.bin(ctx, CTX_GT_FLAG) != 0;
      m.gt8[u8i] = gt ? 1 : 0;
      dec_gt(u8i, gt);
    }
    set_inter_maps(x, y, size, mvx, mvy, ref);
    int root_cbf = 1;
    if (!merge) root_cbf = d.bin(ctx, CTX_QT_ROOT_CBF);
    for (int yy = y; yy < y + size && yy < m.pic_h; yy += 4)
      for (int xx = x; xx < x + size && xx < m.pic_w; xx += 4)
        m.tu4[(yy >> 2) * m.u4_w + (xx >> 2)] = (uint8_t)log2;
    if (root_cbf) {
      transform_tree(x, y, log2, 0, false, 0, 0, 0, x, y, false);
    } else {
      set_cbf_y(x, y, size, 0);
      set_cbf_c(m.cbf8_cb, x, y, size, 0);
      set_cbf_c(m.cbf8_cr, x, y, size, 0);
    }
  }

  void code_cu(int x, int y, int log2) {
    if (m.slice_type >= 3) {
      int64_t zc = m.zat(x, y);
      int ctxi = 0;
      if (m.navail(x - 1, y, zc)
          && m.skip8[(y >> 3) * m.u8_w + ((x - 1) >> 3)]) ctxi++;
      if (m.navail(x, y - 1, zc)
          && m.skip8[((y - 1) >> 3) * m.u8_w + (x >> 3)]) ctxi++;
      int skip = d.bin(ctx, CTX_SKIP + ctxi);
      if (skip) {
        dec_inter_cu(x, y, log2, true);
        return;
      }
      int is_intra = d.bin(ctx, CTX_PRED_MODE);
      if (!is_intra) {
        dec_inter_cu(x, y, log2, false);
        return;
      }
    }
    int part_nxn = 0;
    if (log2 == 3) {
      part_nxn = !d.bin(ctx, CTX_PART_SIZE);
      m.part8[(y >> 3) * m.u8_w + (x >> 3)] = part_nxn ? 3 : 0;
    }
    int n_pu = part_nxn ? 4 : 1, pu_size = part_nxn ? (1 << (log2 - 1)) : (1 << log2);
    int prev_flag[4];
    for (int i = 0; i < n_pu; i++) prev_flag[i] = d.bin(ctx, CTX_INTRA_MODE);
    int modes[4];
    for (int i = 0; i < n_pu; i++) {
      int px = x + (i & 1) * pu_size, py = y + (i >> 1) * pu_size;
      int mpm[3];
      build_mpm(m, px, py, mpm);
      if (prev_flag[i]) {
        int idx = d.bypass();
        if (idx) idx += d.bypass();
        modes[i] = mpm[idx];
      } else {
        int rem = (int)d.bypass_bins(5);
        int a = mpm[0], b = mpm[1], c = mpm[2], t;
        if (a > b) { t = a; a = b; b = t; }
        if (a > c) { t = a; a = c; c = t; }
        if (b > c) { t = b; b = c; c = t; }
        if (rem >= a) rem++;
        if (rem >= b) rem++;
        if (rem >= c) rem++;
        modes[i] = rem;
      }
      set_mode(px, py, pu_size, (uint8_t)modes[i]);
    }
    int cmode;
    if (d.bin(ctx, CTX_CHROMA_MODE) == 0) {
      cmode = 36;  // DM marker
    } else {
      int idx = (int)d.bypass_bins(2);
      int list[4];
      chroma_cand_list(modes[0], list);
      cmode = list[idx];
    }
    for (int yy = y; yy < y + (1 << log2) && yy < m.pic_h; yy += 8)
      for (int xx = x; xx < x + (1 << log2) && xx < m.pic_w; xx += 8)
        m.cmode8[(yy >> 3) * m.u8_w + (xx >> 3)] = (uint8_t)cmode;
    transform_tree(x, y, log2, 0, part_nxn, 0, 0, 0, x, y);
  }

  void quad(int x, int y, int log2) {
    int size = 1 << log2;
    bool inside = (x + size <= m.pic_w) && (y + size <= m.pic_h);
    int my_depth = m.ctb_log2 - log2;
    bool split;
    if (inside && log2 > 3) {
      int ctx_inc = 0;
      if (x > 0 && m.cu_depth_at(x - 1, y) > my_depth) ctx_inc++;
      if (y > 0 && m.cu_depth_at(x, y - 1) > my_depth) ctx_inc++;
      split = d.bin(ctx, CTX_SPLIT_FLAG + ctx_inc);
    } else {
      split = inside ? false : (log2 > 3);
    }
    if (split) {
      int h = size >> 1;
      if (x < m.pic_w && y < m.pic_h) quad(x, y, log2 - 1);
      if (x + h < m.pic_w && y < m.pic_h) quad(x + h, y, log2 - 1);
      if (x < m.pic_w && y + h < m.pic_h) quad(x, y + h, log2 - 1);
      if (x + h < m.pic_w && y + h < m.pic_h) quad(x + h, y + h, log2 - 1);
    } else if (inside || (x < m.pic_w && y < m.pic_h)) {
      set_depth(x, y, size, (uint8_t)my_depth);
      code_cu(x, y, log2);
    }
  }

  int dec_tr_bypass(int cmax) {
    int v = 0;
    while (v < cmax && d.bypass()) v++;
    return v;
  }

  void dec_sao(int cx, int cy, int nx) {
    int i = cy * nx + cx;
    int mrg = 0;
    if (cx > 0 && d.bin(ctx, CTX_SAO_MERGE)) mrg = 1;
    if (mrg == 0 && cy > 0 && d.bin(ctx, CTX_SAO_MERGE)) mrg = 2;
    m.sao_merge[i] = (uint8_t)mrg;
    if (mrg) {
      int src = (mrg == 1) ? i - 1 : i - nx;
      for (int c = 0; c < 3; c++) {
        m.sao_type[(size_t)i * 3 + c] = m.sao_type[(size_t)src * 3 + c];
        m.sao_band[(size_t)i * 3 + c] = m.sao_band[(size_t)src * 3 + c];
        for (int k = 0; k < 4; k++)
          m.sao_off[((size_t)i * 3 + c) * 4 + k] =
              m.sao_off[((size_t)src * 3 + c) * 4 + k];
      }
      return;
    }
    for (int c = 0; c < 3; c++) {
      int t;
      if (c < 2) {
        t = 0;
        if (d.bin(ctx, CTX_SAO_TYPE)) t = d.bypass() ? 2 : 1;
      } else {
        t = m.sao_type[(size_t)i * 3 + 1] >= 2
                ? 2  // EO: class filled below from cb
                : m.sao_type[(size_t)i * 3 + 1];
      }
      int16_t* off = m.sao_off + ((size_t)i * 3 + c) * 4;
      if (t == 0) {
        m.sao_type[(size_t)i * 3 + c] = 0;
        for (int k = 0; k < 4; k++) off[k] = 0;
        continue;
      }
      int absv[4];
      for (int k = 0; k < 4; k++) absv[k] = dec_tr_bypass(7);
      if (t == 1) {  // BO
        for (int k = 0; k < 4; k++)
          off[k] = (int16_t)(absv[k] && d.bypass() ? -absv[k] : absv[k]);
        int band = 0;
        for (int b = 0; b < 5; b++) band = (band << 1) | d.bypass();
        m.sao_band[(size_t)i * 3 + c] = (uint8_t)band;
        m.sao_type[(size_t)i * 3 + c] = 1;
      } else {  // EO: categories 1,2 positive; 3,4 negative
        off[0] = (int16_t)absv[0];
        off[1] = (int16_t)absv[1];
        off[2] = (int16_t)-absv[2];
        off[3] = (int16_t)-absv[3];
        int cls;
        if (c < 2) {
          cls = d.bypass() << 1;
          cls |= d.bypass();
        } else {
          cls = m.sao_type[(size_t)i * 3 + 1] - 2;
        }
        m.sao_type[(size_t)i * 3 + c] = (uint8_t)(2 + cls);
      }
    }
  }

  int64_t run() {
    d.start();
    int ctb = 1 << m.ctb_log2;
    int n_ctu_x = (m.pic_w + ctb - 1) >> m.ctb_log2;
    int n_ctu_y = (m.pic_h + ctb - 1) >> m.ctb_log2;
    for (int cy = 0; cy < n_ctu_y; cy++)
      for (int cx = 0; cx < n_ctu_x; cx++) {
        if (m.sao_on) dec_sao(cx, cy, n_ctu_x);
        quad(cx << m.ctb_log2, cy << m.ctb_log2, m.ctb_log2);
        int end = d.terminate();
        bool last = (cy == n_ctu_y - 1) && (cx == n_ctu_x - 1);
        if (end != (last ? 1 : 0)) return -1;  // stream desync
      }
    return d.pos;
  }

  // WPP decode: one substream per CTU row (entry-point sizes from the
  // slice header), contexts inherited from the snapshot after the 2nd CTU
  // of the row above; rows parsed by pipelined worker threads with the
  // standard 2-CTU lag (above-right dependency, TDecSlice.cpp:262,371).
  int64_t run_wpp(const uint8_t* data_all, int64_t total_size,
                  const uint8_t* init_ctx, const int64_t* sub_sizes,
                  int nsub, int nthreads) {
    int ctb = 1 << m.ctb_log2;
    int nx = (m.pic_w + ctb - 1) >> m.ctb_log2;
    int ny = (m.pic_h + ctb - 1) >> m.ctb_log2;
    if (nsub != ny) return -1;
    int sync_col = nx > 1 ? 1 : 0;
    std::vector<int64_t> offs(ny + 1, 0);
    for (int i = 0; i < ny; i++) offs[i + 1] = offs[i] + sub_sizes[i];
    if (offs[ny] > total_size) return -1;
    std::vector<std::vector<uint8_t>> snap(ny);
    std::vector<std::atomic<int>> prog(ny);
    std::vector<std::atomic<int>> snap_ready(ny);
    std::atomic<int> fail(0);
    for (int i = 0; i < ny; i++) {
      prog[i].store(0);
      snap_ready[i].store(0);
    }

    auto decode_row = [&](int cy) {
      SliceDecoder rsd;
      rsd.m = m;
      rsd.d.data = data_all + offs[cy];
      rsd.d.size = sub_sizes[cy];
      std::vector<uint8_t> ctxv;
      if (cy == 0) {
        ctxv.assign(init_ctx, init_ctx + NUM_CTX);
      } else {
        while (!snap_ready[cy - 1].load(std::memory_order_acquire)) {
          if (fail.load(std::memory_order_relaxed)) return;
          std::this_thread::yield();
        }
        ctxv = snap[cy - 1];
      }
      rsd.ctx = ctxv.data();
      rsd.d.start();
      for (int cx = 0; cx < nx; cx++) {
        if (cy > 0) {
          int need = cx + 2 < nx ? cx + 2 : nx;
          while (prog[cy - 1].load(std::memory_order_acquire) < need) {
            if (fail.load(std::memory_order_relaxed)) return;
            std::this_thread::yield();
          }
        }
        if (m.sao_on) rsd.dec_sao(cx, cy, nx);
        rsd.quad(cx << m.ctb_log2, cy << m.ctb_log2, m.ctb_log2);
        int end = rsd.d.terminate();
        bool last = (cy == ny - 1) && (cx == nx - 1);
        if (end != (last ? 1 : 0)) {
          fail.store(1, std::memory_order_relaxed);
          snap_ready[cy].store(1, std::memory_order_release);
          return;
        }
        if (cx == sync_col && cy + 1 < ny) {
          snap[cy] = ctxv;
          snap_ready[cy].store(1, std::memory_order_release);
        }
        prog[cy].store(cx + 1, std::memory_order_release);
      }
      if (cy != ny - 1 && rsd.d.terminate() != 1)  // end_of_subset_one_bit
        fail.store(1, std::memory_order_relaxed);
    };

    if (nthreads <= 1 || ny <= 1) {
      for (int cy = 0; cy < ny && !fail.load(); cy++) decode_row(cy);
    } else {
      int nt = nthreads < ny ? nthreads : ny;
      std::vector<std::thread> ts;
      for (int t = 0; t < nt; t++)
        ts.emplace_back([&, t] {
          for (int cy = t; cy < ny; cy += nt) {
            if (fail.load(std::memory_order_relaxed)) return;
            decode_row(cy);
          }
        });
      for (auto& th : ts) th.join();
    }
    return fail.load() ? -1 : offs[ny];
  }
};

static void fill_maps(FrameMaps& m, int pic_w, int pic_h, int ctb_log2,
                      int max_hier_depth,
                      uint8_t* depth8, uint8_t* part8, uint8_t* mode4,
                      uint8_t* cmode8, uint8_t* tu4, uint8_t* cbf4_y,
                      uint8_t* cbf8_cb, uint8_t* cbf8_cr, int16_t* coef_y,
                      int16_t* coef_cb, int16_t* coef_cr) {
  m.pic_w = pic_w;
  m.pic_h = pic_h;
  m.ctb_log2 = ctb_log2;
  m.max_hier_depth = max_hier_depth;
  m.tu4 = tu4;
  m.u4_w = pic_w >> 2;
  m.u4_h = pic_h >> 2;
  m.build_zplane();
  m.u8_w = pic_w >> 3;
  m.u8_h = pic_h >> 3;
  m.u4_w = pic_w >> 2;
  m.u4_h = pic_h >> 2;
  m.depth8 = depth8;
  m.part8 = part8;
  m.mode4 = mode4;
  m.cmode8 = cmode8;
  m.cbf4_y = cbf4_y;
  m.cbf8_cb = cbf8_cb;
  m.cbf8_cr = cbf8_cr;
  m.coef_y = coef_y;
  m.coef_cb = coef_cb;
  m.coef_cr = coef_cr;
  m.stride_y = pic_w;
  m.stride_c = pic_w >> 1;
  m.sbh = t_sbh;
}

}  // namespace

// ===========================================================================
// C API
// ===========================================================================

extern "C" {

int hevc_num_ctx(void) { return NUM_CTX; }

// Install (or clear, with p == NULL) a [NUM_CTX * 2] uint64 bin-statistics
// buffer; counts accumulate across subsequent encode calls.
void hevc_set_bin_counts(uint64_t* p) { g_bin_counts = p; }

// toggle sign_data_hiding for subsequent slice-data / residual calls
void hevc_set_sbh(int on) { t_sbh = on; }

int64_t hevc_encode_slice_data(
    const uint8_t* ctx_states, int pic_w, int pic_h, int ctb_log2,
    int max_hier_depth,
    const uint8_t* depth8, const uint8_t* part8, const uint8_t* mode4,
    const uint8_t* cmode8, const uint8_t* tu4, const uint8_t* cbf4_y,
    const uint8_t* cbf8_cb, const uint8_t* cbf8_cr, const int16_t* coef_y,
    const int16_t* coef_cb, const int16_t* coef_cr,
    int sao_on, uint8_t* sao_merge, uint8_t* sao_type, int16_t* sao_off,
    uint8_t* sao_band, uint8_t* out, int64_t cap) {
  SliceEncoder se;
  fill_maps(se.m, pic_w, pic_h, ctb_log2, max_hier_depth,
            (uint8_t*)depth8, (uint8_t*)part8,
            (uint8_t*)mode4, (uint8_t*)cmode8, (uint8_t*)tu4,
            (uint8_t*)cbf4_y,
            (uint8_t*)cbf8_cb, (uint8_t*)cbf8_cr, (int16_t*)coef_y,
            (int16_t*)coef_cb, (int16_t*)coef_cr);
  se.m.sao_on = sao_on;
  se.m.sao_merge = sao_merge;
  se.m.sao_type = sao_type;
  se.m.sao_off = sao_off;
  se.m.sao_band = sao_band;
  std::vector<uint8_t> ctx(ctx_states, ctx_states + NUM_CTX);
  se.ctx = ctx.data();
  std::vector<uint8_t> buf;
  int64_t n = se.run(&buf);
  if (n > cap) return -1;
  memcpy(out, buf.data(), (size_t)n);
  return n;
}

// WPP variants: same maps interface; sub_sizes[n_ctu_y] carries the
// per-CTU-row substream byte sizes (encoder out / decoder in).
int64_t hevc_encode_slice_data_wpp(
    const uint8_t* ctx_states, int pic_w, int pic_h, int ctb_log2,
    int max_hier_depth,
    const uint8_t* depth8, const uint8_t* part8, const uint8_t* mode4,
    const uint8_t* cmode8, const uint8_t* tu4, const uint8_t* cbf4_y,
    const uint8_t* cbf8_cb, const uint8_t* cbf8_cr, const int16_t* coef_y,
    const int16_t* coef_cb, const int16_t* coef_cr,
    int sao_on, uint8_t* sao_merge, uint8_t* sao_type, int16_t* sao_off,
    uint8_t* sao_band, uint8_t* out, int64_t cap, int64_t* sub_sizes,
    int nthreads) {
  SliceEncoder se;
  fill_maps(se.m, pic_w, pic_h, ctb_log2, max_hier_depth,
            (uint8_t*)depth8, (uint8_t*)part8,
            (uint8_t*)mode4, (uint8_t*)cmode8, (uint8_t*)tu4,
            (uint8_t*)cbf4_y,
            (uint8_t*)cbf8_cb, (uint8_t*)cbf8_cr, (int16_t*)coef_y,
            (int16_t*)coef_cb, (int16_t*)coef_cr);
  se.m.sao_on = sao_on;
  se.m.sao_merge = sao_merge;
  se.m.sao_type = sao_type;
  se.m.sao_off = sao_off;
  se.m.sao_band = sao_band;
  std::vector<uint8_t> buf;
  int64_t n = se.run_wpp(&buf, ctx_states, sub_sizes, nthreads);
  if (n > cap) return -1;
  memcpy(out, buf.data(), (size_t)n);
  return n;
}

int64_t hevc_decode_slice_data_wpp(
    const uint8_t* ctx_states, int pic_w, int pic_h, int ctb_log2,
    int max_hier_depth,
    const uint8_t* data, int64_t size, uint8_t* depth8, uint8_t* part8,
    uint8_t* mode4, uint8_t* cmode8, uint8_t* tu4, uint8_t* cbf4_y,
    uint8_t* cbf8_cb, uint8_t* cbf8_cr, int16_t* coef_y, int16_t* coef_cb,
    int16_t* coef_cr, int sao_on, uint8_t* sao_merge, uint8_t* sao_type,
    int16_t* sao_off, uint8_t* sao_band, const int64_t* sub_sizes,
    int nsub, int nthreads) {
  SliceDecoder sd;
  fill_maps(sd.m, pic_w, pic_h, ctb_log2, max_hier_depth,
            depth8, part8, mode4, cmode8, tu4,
            cbf4_y, cbf8_cb, cbf8_cr, coef_y, coef_cb, coef_cr);
  sd.m.sao_on = sao_on;
  sd.m.sao_merge = sao_merge;
  sd.m.sao_type = sao_type;
  sd.m.sao_off = sao_off;
  sd.m.sao_band = sao_band;
  return sd.run_wpp(data, size, ctx_states, sub_sizes, nsub, nthreads);
}

int64_t hevc_decode_slice_data(
    const uint8_t* ctx_states, int pic_w, int pic_h, int ctb_log2,
    int max_hier_depth,
    const uint8_t* data, int64_t size, uint8_t* depth8, uint8_t* part8,
    uint8_t* mode4, uint8_t* cmode8, uint8_t* tu4, uint8_t* cbf4_y,
    uint8_t* cbf8_cb, uint8_t* cbf8_cr, int16_t* coef_y, int16_t* coef_cb,
    int16_t* coef_cr, int sao_on, uint8_t* sao_merge, uint8_t* sao_type,
    int16_t* sao_off, uint8_t* sao_band) {
  SliceDecoder sd;
  fill_maps(sd.m, pic_w, pic_h, ctb_log2, max_hier_depth,
            depth8, part8, mode4, cmode8, tu4,
            cbf4_y, cbf8_cb, cbf8_cr, coef_y, coef_cb, coef_cr);
  sd.m.sao_on = sao_on;
  sd.m.sao_merge = sao_merge;
  sd.m.sao_type = sao_type;
  sd.m.sao_off = sao_off;
  sd.m.sao_band = sao_band;
  std::vector<uint8_t> ctx(ctx_states, ctx_states + NUM_CTX);
  sd.ctx = ctx.data();
  sd.d.data = data;
  sd.d.size = size;
  return sd.run();
}

// ISS/PSS (self-similarity) slice data with the inter/SS maps.
int64_t hevc_encode_slice_data_ss(
    const uint8_t* ctx_states, int pic_w, int pic_h, int ctb_log2,
    int max_hier_depth, int slice_type, int mi_size,
    const uint8_t* depth8, const uint8_t* part8, const uint8_t* mode4,
    const uint8_t* cmode8, const uint8_t* tu4, const uint8_t* cbf4_y,
    const uint8_t* cbf8_cb, const uint8_t* cbf8_cr, const int16_t* coef_y,
    const int16_t* coef_cb, const int16_t* coef_cr,
    const uint8_t* pred4, uint8_t* skip8, uint8_t* merge8, uint8_t* mvp8,
    const uint8_t* gt8, const int16_t* mv4x, const int16_t* mv4y,
    const int16_t* gtv8, const uint8_t* ref4, int num_ref,
    int sao_on, uint8_t* sao_merge, uint8_t* sao_type, int16_t* sao_off,
    uint8_t* sao_band, uint8_t* out, int64_t cap) {
  SliceEncoder se;
  fill_maps(se.m, pic_w, pic_h, ctb_log2, max_hier_depth,
            (uint8_t*)depth8, (uint8_t*)part8, (uint8_t*)mode4,
            (uint8_t*)cmode8, (uint8_t*)tu4, (uint8_t*)cbf4_y,
            (uint8_t*)cbf8_cb, (uint8_t*)cbf8_cr, (int16_t*)coef_y,
            (int16_t*)coef_cb, (int16_t*)coef_cr);
  se.m.slice_type = slice_type;
  se.m.mi_size = mi_size;
  se.m.pred4 = (uint8_t*)pred4;
  se.m.skip8 = skip8;
  se.m.merge8 = merge8;
  se.m.mvp8 = mvp8;
  se.m.gt8 = (uint8_t*)gt8;
  se.m.mv4x = (int16_t*)mv4x;
  se.m.mv4y = (int16_t*)mv4y;
  se.m.gtv8 = (int16_t*)gtv8;
  se.m.ref4 = (uint8_t*)ref4;
  se.m.num_ref = num_ref;
  se.m.sao_on = sao_on;
  se.m.sao_merge = sao_merge;
  se.m.sao_type = sao_type;
  se.m.sao_off = sao_off;
  se.m.sao_band = sao_band;
  std::vector<uint8_t> ctx(ctx_states, ctx_states + NUM_CTX);
  se.ctx = ctx.data();
  std::vector<uint8_t> buf;
  int64_t n = se.run(&buf);
  if (n > cap) return -1;
  memcpy(out, buf.data(), (size_t)n);
  return n;
}

int64_t hevc_decode_slice_data_ss(
    const uint8_t* ctx_states, int pic_w, int pic_h, int ctb_log2,
    int max_hier_depth, int slice_type, int mi_size,
    const uint8_t* data, int64_t size, uint8_t* depth8, uint8_t* part8,
    uint8_t* mode4, uint8_t* cmode8, uint8_t* tu4, uint8_t* cbf4_y,
    uint8_t* cbf8_cb, uint8_t* cbf8_cr, int16_t* coef_y, int16_t* coef_cb,
    int16_t* coef_cr, uint8_t* pred4, uint8_t* skip8, uint8_t* merge8,
    uint8_t* mvp8, uint8_t* gt8, int16_t* mv4x, int16_t* mv4y,
    int16_t* gtv8, uint8_t* ref4, int num_ref, int sao_on,
    uint8_t* sao_merge, uint8_t* sao_type, int16_t* sao_off,
    uint8_t* sao_band) {
  SliceDecoder sd;
  fill_maps(sd.m, pic_w, pic_h, ctb_log2, max_hier_depth,
            depth8, part8, mode4, cmode8, tu4,
            cbf4_y, cbf8_cb, cbf8_cr, coef_y, coef_cb, coef_cr);
  sd.m.slice_type = slice_type;
  sd.m.mi_size = mi_size;
  sd.m.pred4 = pred4;
  sd.m.skip8 = skip8;
  sd.m.merge8 = merge8;
  sd.m.mvp8 = mvp8;
  sd.m.gt8 = gt8;
  sd.m.mv4x = mv4x;
  sd.m.mv4y = mv4y;
  sd.m.gtv8 = gtv8;
  sd.m.ref4 = ref4;
  sd.m.num_ref = num_ref;
  sd.m.sao_on = sao_on;
  sd.m.sao_merge = sao_merge;
  sd.m.sao_type = sao_type;
  sd.m.sao_off = sao_off;
  sd.m.sao_band = sao_band;
  std::vector<uint8_t> ctx(ctx_states, ctx_states + NUM_CTX);
  sd.ctx = ctx.data();
  sd.d.data = data;
  sd.d.size = size;
  return sd.run();
}

// Merge/AMVP probes for differential testing from Python.
int64_t probe_merge_list(int pic_w, int pic_h, int ctb_log2, int slice_type,
                         int mi_size, const uint8_t* pred4,
                         const int16_t* mv4x, const int16_t* mv4y,
                         int x, int y, int n, int32_t* out10,
                         const uint8_t* ref4, int num_ref, int amvp_ref) {
  FrameMaps m;
  m.pic_w = pic_w;
  m.pic_h = pic_h;
  m.ctb_log2 = ctb_log2;
  m.u4_w = pic_w >> 2;
  m.u4_h = pic_h >> 2;
  m.slice_type = slice_type;
  m.mi_size = mi_size;
  m.pred4 = (uint8_t*)pred4;
  m.mv4x = (int16_t*)mv4x;
  m.mv4y = (int16_t*)mv4y;
  m.ref4 = (uint8_t*)ref4;
  m.num_ref = num_ref;
  m.build_zplane();
  MvCand c[5];
  build_merge_list(m, x, y, n, c);
  for (int i = 0; i < 5; i++) {
    out10[3 * i] = c[i].x;
    out10[3 * i + 1] = c[i].y;
    out10[3 * i + 2] = c[i].ref;
  }
  MvCand a[2];
  build_amvp(m, x, y, n, a, amvp_ref);
  out10[15] = a[0].x;
  out10[16] = a[0].y;
  out10[17] = a[1].x;
  out10[18] = a[1].y;
  return 0;
}

// Generic op-stream interface for engine-level differential tests.
// ops: 0=ctx bin (a=ctx idx, b=bin), 1=bypass (b), 2=bypass bins (a=n, b=val)
int64_t cabac_encode_ops(const uint8_t* init_states, int nctx,
                         const int32_t* ops, const int32_t* a,
                         const int32_t* b, int n, uint8_t* out, int64_t cap) {
  std::vector<uint8_t> ctx(init_states, init_states + nctx);
  std::vector<uint8_t> buf;
  CabacEnc e;
  e.out = &buf;
  for (int i = 0; i < n; i++) {
    if (ops[i] == 0) e.bin(ctx.data(), a[i], b[i]);
    else if (ops[i] == 1) e.bypass(b[i]);
    else e.bypass_bins((uint32_t)b[i], a[i]);
  }
  e.terminate(1);
  e.finish();
  e.byte_align_with_stop_bit();
  if ((int64_t)buf.size() > cap) return -1;
  memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

int64_t cabac_decode_ops(const uint8_t* init_states, int nctx,
                         const int32_t* ops, const int32_t* a, int32_t* vals,
                         int n, const uint8_t* data, int64_t size) {
  std::vector<uint8_t> ctx(init_states, init_states + nctx);
  CabacDec d;
  d.data = data;
  d.size = size;
  d.start();
  for (int i = 0; i < n; i++) {
    if (ops[i] == 0) vals[i] = d.bin(ctx.data(), a[i]);
    else if (ops[i] == 1) vals[i] = d.bypass();
    else vals[i] = (int32_t)d.bypass_bins(a[i]);
  }
  return d.terminate();
}

// Standalone residual-coding round trip hooks for fuzz tests.
int64_t residual_encode_one(const uint8_t* init_states, const int16_t* coef,
                            int log2, int c_idx, int intra_mode, uint8_t* out,
                            int64_t cap) {
  std::vector<uint8_t> ctx(init_states, init_states + NUM_CTX);
  std::vector<uint8_t> buf;
  CabacEnc e;
  e.out = &buf;
  encode_residual(e, ctx.data(), coef, 1 << log2, log2, c_idx, intra_mode, 0);
  e.terminate(1);
  e.finish();
  e.byte_align_with_stop_bit();
  if ((int64_t)buf.size() > cap) return -1;
  memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

int64_t residual_decode_one(const uint8_t* init_states, int16_t* coef,
                            int log2, int c_idx, int intra_mode,
                            const uint8_t* data, int64_t size) {
  std::vector<uint8_t> ctx(init_states, init_states + NUM_CTX);
  CabacDec d;
  d.data = data;
  d.size = size;
  d.start();
  decode_residual(d, ctx.data(), coef, 1 << log2, log2, c_idx, intra_mode, 0);
  return d.terminate();
}

// Wavefront topological levels for transform blocks (z-order list).
// level(block) = 1 + max(level of z-earlier blocks touched by its
// reference chain). Mirrors models/wavefront.schedule_topo.
// ss_range > 0 additionally makes every z-earlier block within
// (chebyshev) ss_range + n a dependency, so self-similarity prediction may
// reference the full causal area at this block's wavefront step.
// mv_rect: optional per-block dependency rectangle [x0,y0,w,h] (4*nb ints,
// w<=0 -> none) for decoder-side MV-aware scheduling; pass NULL to skip.
int64_t wavefront_levels_ex(const int32_t* bx, const int32_t* by,
                            const int32_t* blog2, int nb, int pic_w,
                            int pic_h, int ctb_log2, int ss_range,
                            const int32_t* mv_rect, int32_t* out_levels) {
  int u4w = pic_w >> 2, u4h = pic_h >> 2;
  std::vector<int64_t> zplane((size_t)u4w * u4h);
  int cshift = ctb_log2 - 2;
  int nctux = (pic_w + (1 << ctb_log2) - 1) >> ctb_log2;
  for (int uy = 0; uy < u4h; uy++)
    for (int ux = 0; ux < u4w; ux++) {
      int64_t ctu = (int64_t)(uy >> cshift) * nctux + (ux >> cshift);
      int lx = ux & ((1 << cshift) - 1), ly = uy & ((1 << cshift) - 1);
      int64_t z = 0;
      for (int b = 0; b < cshift; b++) {
        z |= (int64_t)((lx >> b) & 1) << (2 * b);
        z |= (int64_t)((ly >> b) & 1) << (2 * b + 1);
      }
      zplane[(size_t)uy * u4w + ux] = (ctu << (2 * cshift)) | z;
    }
  std::vector<int32_t> lplane((size_t)u4w * u4h, 0);
  for (int i = 0; i < nb; i++) {
    int x = bx[i], y = by[i], n = 1 << blog2[i];
    int64_t zc = zplane[(size_t)(y >> 2) * u4w + (x >> 2)];
    int32_t lev = 0;
    // chain samples: left column (x-1, y..y+2n-1), corner, top (x..x+2n-1, y-1)
    for (int k = 0; k < 4 * n + 1; k++) {
      int sx, sy;
      if (k < 2 * n) { sx = x - 1; sy = y + k; }
      else if (k == 2 * n) { sx = x - 1; sy = y - 1; }
      else { sx = x + (k - 2 * n - 1); sy = y - 1; }
      if (sx < 0 || sy < 0 || sx >= pic_w || sy >= pic_h) continue;
      size_t u = (size_t)(sy >> 2) * u4w + (sx >> 2);
      if (zplane[u] < zc && lplane[u] > lev) lev = lplane[u];
    }
    if (ss_range > 0) {
      int d = ss_range + n;
      int x0 = x - d < 0 ? 0 : x - d, x1 = x + d >= pic_w ? pic_w - 1 : x + d;
      int y0 = y - d < 0 ? 0 : y - d, y1 = y + d >= pic_h ? pic_h - 1 : y + d;
      for (int uy = y0 >> 2; uy <= y1 >> 2; uy++)
        for (int ux = x0 >> 2; ux <= x1 >> 2; ux++) {
          size_t u = (size_t)uy * u4w + ux;
          if (zplane[u] < zc && lplane[u] > lev) lev = lplane[u];
        }
    }
    if (mv_rect && mv_rect[4 * i + 2] > 0) {
      int x0 = mv_rect[4 * i], y0 = mv_rect[4 * i + 1];
      int x1 = x0 + mv_rect[4 * i + 2] - 1, y1 = y0 + mv_rect[4 * i + 3] - 1;
      if (x0 < 0) x0 = 0;
      if (y0 < 0) y0 = 0;
      if (x1 >= pic_w) x1 = pic_w - 1;
      if (y1 >= pic_h) y1 = pic_h - 1;
      for (int uy = y0 >> 2; uy <= y1 >> 2; uy++)
        for (int ux = x0 >> 2; ux <= x1 >> 2; ux++) {
          size_t u = (size_t)uy * u4w + ux;
          if (lplane[u] > lev) lev = lplane[u];
        }
    }
    lev += 1;
    out_levels[i] = lev;
    for (int yy = y; yy < y + n && yy < pic_h; yy += 4)
      for (int xx = x; xx < x + n && xx < pic_w; xx += 4)
        lplane[(size_t)(yy >> 2) * u4w + (xx >> 2)] = lev;
  }
  return 0;
}

int64_t wavefront_levels(const int32_t* bx, const int32_t* by,
                         const int32_t* blog2, int nb, int pic_w, int pic_h,
                         int ctb_log2, int32_t* out_levels) {
  return wavefront_levels_ex(bx, by, blog2, nb, pic_w, pic_h, ctb_log2, 0,
                             nullptr, out_levels);
}

}  // extern "C"
