"""Per-picture coding telemetry + sequence summaries.

Capability ref: TEncAnalyze.h:205 (global/per-slice-type accumulators),
TEncGOP.cpp:2383 xCalculateAddPSNR (the per-POC `POC n ( X-SLICE, QP q )
b bits [Y p dB U p dB V p dB]` line), printOutSummary (TEncGOP.cpp:2136).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def plane_psnr(org, rec, bit_depth: int = 8) -> float:
    o = np.asarray(org, np.float64)
    r = np.asarray(rec, np.float64)
    mse = float(np.mean((o - r) ** 2))
    if mse == 0:
        return math.inf
    maxv = (1 << bit_depth) - 1
    return 10.0 * math.log10(maxv * maxv / mse)


@dataclasses.dataclass
class PicStat:
    poc: int
    slice_type: str
    qp: int
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float
    secs: float = 0.0

    def line(self) -> str:
        # TEncGOP.cpp:2510-2556 per-picture printout shape
        return (f"POC {self.poc:4d} ( {self.slice_type}-SLICE, QP "
                f"{self.qp} ) {self.bits:10d} bits "
                f"[Y {self.psnr_y:.4f} dB  U {self.psnr_u:.4f} dB  "
                f"V {self.psnr_v:.4f} dB] [ET {self.secs:5.2f} ]")


class Analyzer:
    """Accumulates per-picture stats; prints HM-shaped summaries."""

    def __init__(self, frame_rate: float = 30.0) -> None:
        self.frame_rate = frame_rate
        self.pics: list[PicStat] = []

    def add_picture(self, poc: int, slice_type: str, qp: int,
                    stream_bits: int, org_yuv, rec_yuv,
                    bit_depth: int = 8, secs: float = 0.0,
                    verbose: bool = False) -> PicStat:
        st = PicStat(poc, slice_type, qp, stream_bits,
                     plane_psnr(org_yuv[0], rec_yuv[0], bit_depth),
                     plane_psnr(org_yuv[1], rec_yuv[1], bit_depth),
                     plane_psnr(org_yuv[2], rec_yuv[2], bit_depth), secs)
        self.pics.append(st)
        if verbose:
            print(st.line())
        return st

    def _summary(self, pics: list) -> dict:
        n = max(len(pics), 1)
        return dict(
            n=len(pics),
            kbps=sum(p.bits for p in pics) / n * self.frame_rate / 1000.0,
            psnr_y=sum(p.psnr_y for p in pics) / n,
            psnr_u=sum(p.psnr_u for p in pics) / n,
            psnr_v=sum(p.psnr_v for p in pics) / n)

    def summary(self, slice_type: str | None = None) -> dict:
        pics = [p for p in self.pics
                if slice_type is None or p.slice_type == slice_type]
        return self._summary(pics)

    def print_summary(self) -> None:
        # printOutSummary (TEncGOP.cpp:2136): global + per-slice-type
        kinds = sorted({p.slice_type for p in self.pics})
        rows = [("a", self.summary())] + [
            (k, self.summary(k)) for k in kinds]
        for tag, s in rows:
            print(f"  {tag.upper():>3s} {s['n']:5d} pics, "
                  f"{s['kbps']:10.4f} kbps  Y {s['psnr_y']:8.4f} dB  "
                  f"U {s['psnr_u']:8.4f} dB  V {s['psnr_v']:8.4f} dB")
