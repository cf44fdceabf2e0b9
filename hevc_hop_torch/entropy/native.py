"""ctypes bindings for the native C++ CABAC/syntax runtime (libhevc_hop.so).

Builds on demand with the in-tree Makefile if the shared library is missing
or stale. All array arguments are numpy arrays with C-contiguous layout.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native")
_LIB_PATH = os.path.join(_DIR, "libhevc_hop.so")

_lib = None


def _build() -> None:
    subprocess.run(["make", "-C", _DIR, "-s"], check=True)


def _stale() -> bool:
    src = os.path.join(_DIR, "cabac.cpp")
    return (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src))


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        # processes that start together (test workers) build once: the
        # others wait on the lock and then find the fresh library
        import fcntl
        with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _stale():
                _build()
    lib = ctypes.CDLL(_LIB_PATH)
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    c64 = ctypes.c_int64

    lib.hevc_num_ctx.restype = c
    lib.hevc_encode_slice_data.restype = c64
    lib.hevc_encode_slice_data.argtypes = [
        u8, c, c, c, c, u8, u8, u8, u8, u8, u8, u8, u8, i16, i16, i16,
        c, u8, u8, i16, u8, u8, c64]
    lib.hevc_decode_slice_data.restype = c64
    lib.hevc_decode_slice_data.argtypes = [
        u8, c, c, c, c, u8, c64, u8, u8, u8, u8, u8, u8, u8, u8,
        i16, i16, i16, c, u8, u8, i16, u8]
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.hevc_encode_slice_data_wpp.restype = c64
    lib.hevc_encode_slice_data_wpp.argtypes = [
        u8, c, c, c, c, u8, u8, u8, u8, u8, u8, u8, u8, i16, i16, i16,
        c, u8, u8, i16, u8, u8, c64, i64, c]
    lib.hevc_decode_slice_data_wpp.restype = c64
    lib.hevc_decode_slice_data_wpp.argtypes = [
        u8, c, c, c, c, u8, c64, u8, u8, u8, u8, u8, u8, u8, u8,
        i16, i16, i16, c, u8, u8, i16, u8, i64, c, c]
    lib.cabac_encode_ops.restype = c64
    lib.cabac_encode_ops.argtypes = [u8, c, i32, i32, i32, c, u8, c64]
    lib.cabac_decode_ops.restype = c64
    lib.cabac_decode_ops.argtypes = [u8, c, i32, i32, i32, c, u8, c64]
    lib.residual_encode_one.restype = c64
    lib.residual_encode_one.argtypes = [u8, i16, c, c, c, u8, c64]
    lib.residual_decode_one.restype = c64
    lib.residual_decode_one.argtypes = [u8, i16, c, c, c, u8, c64]
    lib.hevc_encode_slice_data_ss.restype = c64
    lib.hevc_encode_slice_data_ss.argtypes = [
        u8, c, c, c, c, c, c,
        u8, u8, u8, u8, u8, u8, u8, u8, i16, i16, i16,
        u8, u8, u8, u8, u8, i16, i16, i16, u8, c, c, u8, u8, i16, u8,
        u8, c64]
    lib.hevc_decode_slice_data_ss.restype = c64
    lib.hevc_decode_slice_data_ss.argtypes = [
        u8, c, c, c, c, c, c, u8, c64,
        u8, u8, u8, u8, u8, u8, u8, u8, i16, i16, i16,
        u8, u8, u8, u8, u8, i16, i16, i16, u8, c, c, u8, u8, i16, u8]
    lib.probe_merge_list.restype = c64
    lib.probe_merge_list.argtypes = [c, c, c, c, c, u8, i16, i16,
                                     c, c, c, i32, u8, c, c]
    lib.wavefront_levels.restype = c64
    lib.wavefront_levels.argtypes = [i32, i32, i32, c, c, c, c, i32]
    lib.wavefront_levels_ex.restype = c64
    lib.wavefront_levels_ex.argtypes = [i32, i32, i32, c, c, c, c, c,
                                        ctypes.c_void_p, i32]
    lib.hevc_set_bin_counts.restype = None
    lib.hevc_set_bin_counts.argtypes = [ctypes.c_void_p]
    lib.hevc_set_sbh.restype = None
    lib.hevc_set_sbh.argtypes = [c]
    _lib = lib
    return lib


class BinStats:
    """Collect per-context bin statistics across encode calls.

    Usage: with BinStats() as s: ...encode...; s.counts -> [NUM_CTX, 2]
    uint64 (count of 0-bins, 1-bins coded in each context). The telemetry
    hook behind the RDOQ rate-model calibration (tools/calibrate_rdoq.py).
    """

    def __enter__(self):
        lib = get_lib()
        self.counts = np.zeros((lib.hevc_num_ctx(), 2), np.uint64)
        lib.hevc_set_bin_counts(self.counts.ctypes.data)
        return self

    def __exit__(self, *exc):
        get_lib().hevc_set_bin_counts(None)
        return False


def wavefront_levels(bx: np.ndarray, by: np.ndarray, blog2: np.ndarray,
                     pic_w: int, pic_h: int, ctb_log2: int,
                     ss_range: int = 0,
                     mv_rect: np.ndarray | None = None) -> np.ndarray:
    """Topological wavefront level per transform block (z-order input).

    ss_range > 0: every z-earlier block within chebyshev ss_range + n is a
    dependency (self-similarity search area). mv_rect [nb, 4] (x, y, w, h;
    w<=0 none): explicit per-block dependency rectangles (decoder-side
    MV-aware scheduling)."""
    lib = get_lib()
    out = np.zeros(len(bx), np.int32)
    rect_ptr = None
    if mv_rect is not None:
        mv_rect = np.ascontiguousarray(mv_rect, np.int32)
        rect_ptr = mv_rect.ctypes.data_as(ctypes.c_void_p)
    lib.wavefront_levels_ex(
        np.ascontiguousarray(bx, np.int32),
        np.ascontiguousarray(by, np.int32),
        np.ascontiguousarray(blog2, np.int32),
        len(bx), pic_w, pic_h, ctb_log2, ss_range, rect_ptr, out)
    return out


class SliceMaps:
    """Dense per-frame maps exchanged with the native slice codec."""

    def __init__(self, pic_w: int, pic_h: int, ctb_log2: int = 5,
                 max_hier_depth: int = 0) -> None:
        assert pic_w % 8 == 0 and pic_h % 8 == 0
        self.pic_w, self.pic_h, self.ctb_log2 = pic_w, pic_h, ctb_log2
        self.max_hier_depth = max_hier_depth
        u8w, u8h = pic_w // 8, pic_h // 8
        u4w, u4h = pic_w // 4, pic_h // 4
        self.depth8 = np.zeros((u8h, u8w), np.uint8)
        self.part8 = np.zeros((u8h, u8w), np.uint8)
        self.mode4 = np.ones((u4h, u4w), np.uint8)
        self.tu4 = np.full((u4h, u4w), 3, np.uint8)  # leaf TU log2
        self.cmode8 = np.full((u8h, u8w), 36, np.uint8)  # 36 = DM
        self.cbf4_y = np.zeros((u4h, u4w), np.uint8)
        self.cbf8_cb = np.zeros((u8h, u8w), np.uint8)
        self.cbf8_cr = np.zeros((u8h, u8w), np.uint8)
        # the three level planes are views of one buffer, which the
        # decoder copies to the card at once
        ny, nc = pic_h * pic_w, pic_h * pic_w // 4
        self.coef = np.zeros(ny + 2 * nc, np.int16)
        self.coef_y = self.coef[:ny].reshape(pic_h, pic_w)
        self.coef_cb = self.coef[ny:ny + nc].reshape(pic_h // 2, pic_w // 2)
        self.coef_cr = self.coef[ny + nc:].reshape(pic_h // 2, pic_w // 2)
        # inter / self-similarity maps (ISS/PSS slices)
        self.slice_type = 2
        self.mi_size = 0
        self.pred4 = np.ones((u4h, u4w), np.uint8)   # 1=intra
        self.skip8 = np.zeros((u8h, u8w), np.uint8)
        self.merge8 = np.full((u8h, u8w), 255, np.uint8)
        self.mvp8 = np.zeros((u8h, u8w), np.uint8)
        self.gt8 = np.zeros((u8h, u8w), np.uint8)
        self.mv4x = np.zeros((u4h, u4w), np.int16)   # quarter-pel
        self.mv4y = np.zeros((u4h, u4w), np.int16)
        self.gtv8 = np.zeros((u8h, u8w, 6), np.int16)
        self.ref4 = np.zeros((u4h, u4w), np.uint8)   # ref_idx_l0
        self.num_ref = 1                             # L0 count; SS is LAST
        # SAO per-CTU params (resolved): type 0=off, 1=BO, 2+cls=EO
        ncty = (pic_h + (1 << ctb_log2) - 1) >> ctb_log2
        nctx = (pic_w + (1 << ctb_log2) - 1) >> ctb_log2
        self.sbh = 0    # sign_data_hiding_enabled_flag (PPS)
        self.sao_on = 0
        self.sao_merge = np.zeros((ncty, nctx), np.uint8)
        self.sao_type = np.zeros((ncty, nctx, 3), np.uint8)
        self.sao_off = np.zeros((ncty, nctx, 3, 4), np.int16)
        self.sao_band = np.zeros((ncty, nctx, 3), np.uint8)

    def _args(self):
        return (self.depth8, self.part8, self.mode4, self.cmode8, self.tu4,
                self.cbf4_y, self.cbf8_cb, self.cbf8_cr,
                self.coef_y, self.coef_cb, self.coef_cr)

    def _sao_args(self):
        return (self.sao_on, self.sao_merge, self.sao_type, self.sao_off,
                self.sao_band)

    def _ss_args(self):
        return self._args() + (self.pred4, self.skip8, self.merge8,
                               self.mvp8, self.gt8, self.mv4x, self.mv4y,
                               self.gtv8, self.ref4, self.num_ref)


def encode_slice_data(ctx_states: np.ndarray, maps: SliceMaps) -> bytes:
    lib = get_lib()
    cap = maps.pic_w * maps.pic_h * 8 + 65536
    out = np.zeros(cap, np.uint8)
    lib.hevc_set_sbh(int(maps.sbh))
    n = lib.hevc_encode_slice_data(
        np.ascontiguousarray(ctx_states, np.uint8),
        maps.pic_w, maps.pic_h, maps.ctb_log2, maps.max_hier_depth,
        *maps._args(), *maps._sao_args(), out, cap)
    if n < 0:
        raise RuntimeError("slice data overflow")
    return out[:n].tobytes()


def encode_slice_data_wpp(ctx_states: np.ndarray, maps: SliceMaps,
                          nthreads: int = 4):
    """WPP intra slice data: returns (payload bytes, [substream sizes])
    — one substream per CTU row (entropy_coding_sync_enabled_flag,
    TEncSlice.cpp:1158-1160 context-snapshot analog)."""
    lib = get_lib()
    cap = maps.pic_w * maps.pic_h * 8 + 65536
    out = np.zeros(cap, np.uint8)
    ny = (maps.pic_h + (1 << maps.ctb_log2) - 1) >> maps.ctb_log2
    sub = np.zeros(ny, np.int64)
    lib.hevc_set_sbh(int(maps.sbh))
    n = lib.hevc_encode_slice_data_wpp(
        np.ascontiguousarray(ctx_states, np.uint8),
        maps.pic_w, maps.pic_h, maps.ctb_log2, maps.max_hier_depth,
        *maps._args(), *maps._sao_args(), out, cap, sub, nthreads)
    if n < 0:
        raise RuntimeError("slice data overflow")
    return out[:n].tobytes(), [int(s) for s in sub]


def decode_slice_data_wpp(ctx_states: np.ndarray, data: bytes,
                          sub_sizes, pic_w: int, pic_h: int,
                          ctb_log2: int = 5, max_hier_depth: int = 0,
                          sao_on: int = 0, sbh: int = 0,
                          nthreads: int = 4) -> SliceMaps:
    lib = get_lib()
    maps = SliceMaps(pic_w, pic_h, ctb_log2, max_hier_depth)
    maps.sao_on = sao_on
    maps.sbh = sbh
    buf = np.frombuffer(data, np.uint8)
    sub = np.ascontiguousarray(sub_sizes, np.int64)
    lib.hevc_set_sbh(int(maps.sbh))
    n = lib.hevc_decode_slice_data_wpp(
        np.ascontiguousarray(ctx_states, np.uint8), pic_w, pic_h, ctb_log2,
        max_hier_depth, buf, len(data), *maps._args(), *maps._sao_args(),
        sub, len(sub), nthreads)
    if n < 0:
        raise RuntimeError("wpp slice data desync")
    return maps


def decode_slice_data(ctx_states: np.ndarray, data: bytes,
                      pic_w: int, pic_h: int, ctb_log2: int = 5,
                      max_hier_depth: int = 0, sao_on: int = 0,
                      sbh: int = 0) -> SliceMaps:
    lib = get_lib()
    maps = SliceMaps(pic_w, pic_h, ctb_log2, max_hier_depth)
    maps.sao_on = sao_on
    maps.sbh = sbh
    buf = np.frombuffer(data, np.uint8)
    lib.hevc_set_sbh(int(maps.sbh))
    n = lib.hevc_decode_slice_data(
        np.ascontiguousarray(ctx_states, np.uint8), pic_w, pic_h, ctb_log2,
        max_hier_depth, buf, len(data), *maps._args(), *maps._sao_args())
    if n < 0:
        raise RuntimeError("slice data desync")
    return maps


def encode_slice_data_ss(ctx_states: np.ndarray, maps: SliceMaps) -> bytes:
    """ISS/PSS slice-data serialization with the inter/SS maps."""
    lib = get_lib()
    cap = maps.pic_w * maps.pic_h * 8 + 65536
    out = np.zeros(cap, np.uint8)
    lib.hevc_set_sbh(int(maps.sbh))
    n = lib.hevc_encode_slice_data_ss(
        np.ascontiguousarray(ctx_states, np.uint8),
        maps.pic_w, maps.pic_h, maps.ctb_log2, maps.max_hier_depth,
        maps.slice_type, maps.mi_size, *maps._ss_args(),
        *maps._sao_args(), out, cap)
    if n < 0:
        raise RuntimeError("slice data overflow")
    return out[:n].tobytes()


def decode_slice_data_ss(ctx_states: np.ndarray, data: bytes,
                         pic_w: int, pic_h: int, ctb_log2: int,
                         max_hier_depth: int, slice_type: int,
                         mi_size: int, num_ref: int = 1,
                         sao_on: int = 0, sbh: int = 0) -> SliceMaps:
    lib = get_lib()
    maps = SliceMaps(pic_w, pic_h, ctb_log2, max_hier_depth)
    maps.slice_type = slice_type
    maps.mi_size = mi_size
    maps.num_ref = num_ref
    maps.sao_on = sao_on
    maps.sbh = sbh
    buf = np.frombuffer(data, np.uint8)
    lib.hevc_set_sbh(int(maps.sbh))
    n = lib.hevc_decode_slice_data_ss(
        np.ascontiguousarray(ctx_states, np.uint8), pic_w, pic_h, ctb_log2,
        max_hier_depth, slice_type, mi_size, buf, len(data),
        *maps._ss_args(), *maps._sao_args())
    if n < 0:
        raise RuntimeError("slice data desync")
    return maps


def probe_merge_amvp(pic_w, pic_h, ctb_log2, slice_type, mi_size,
                     pred4, mv4x, mv4y, x, y, n, ref4=None, num_ref=1,
                     amvp_ref=0):
    """Returns (merge list [5,3] (x, y, ref), amvp [2,2]) quarter-pel."""
    lib = get_lib()
    out = np.zeros(19, np.int32)
    if ref4 is None:
        ref4 = np.zeros_like(pred4, dtype=np.uint8)
    lib.probe_merge_list(pic_w, pic_h, ctb_log2, slice_type, mi_size,
                         np.ascontiguousarray(pred4, np.uint8),
                         np.ascontiguousarray(mv4x, np.int16),
                         np.ascontiguousarray(mv4y, np.int16),
                         x, y, n, out,
                         np.ascontiguousarray(ref4, np.uint8), num_ref,
                         amvp_ref)
    return out[:15].reshape(5, 3), out[15:19].reshape(2, 2)
