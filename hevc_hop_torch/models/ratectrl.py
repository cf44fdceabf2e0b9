"""Picture-level R-lambda rate control.

Capability ref: TEncRateCtrl.cpp (TEncRCSeq/TEncRCPic: R-lambda model
lambda = alpha * bpp^beta, QP = 4.2005*ln(lambda) + 13.7122, alpha/beta
updated from realized bits, TEncRateCtrl.cpp:40-60 g_RCAlpha/BetaMin/Max,
updateAfterPicture). Like the reference, rate control drives plain
intra coding only — HM exits when RC is combined with the SS/holoscopic
tools (TEncGOP.cpp:1892-1898), and so do we.
"""
from __future__ import annotations

import math


ALPHA0, BETA0 = 3.2003, -1.367          # HM g_RCAlpha/g_RCBeta defaults
ALPHA_MIN, ALPHA_MAX = 0.05, 500.0
BETA_MIN, BETA_MAX = -3.0, -0.1
DELTA_ALPHA, DELTA_BETA = 0.10, 0.05    # picture-level adaptation steps


class RateControl:
    """One instance per sequence; hand it the encoder's frame loop."""

    def __init__(self, target_bps: float, frame_rate: float,
                 width: int, height: int,
                 min_qp: int = 0, max_qp: int = 51) -> None:
        self.pixels = width * height
        self.bpp_target = target_bps / (frame_rate * self.pixels)
        self.alpha, self.beta = ALPHA0, BETA0
        self.min_qp, self.max_qp = min_qp, max_qp
        self.last_qp: int | None = None
        self.history: list = []   # (qp, lambda, target_bits, actual_bits)

    def _lambda(self, bpp: float) -> float:
        return self.alpha * (bpp ** self.beta)

    def pic_qp(self) -> int:
        """QP for the next picture from the current R-lambda model
        (TEncRCPic::estimatePicLambda / estimatePicQP)."""
        lam = self._lambda(self.bpp_target)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        if self.last_qp is not None and len(self.history) >= 2:
            # HM clips per-picture QP moves to +-3 around the previous
            # once the model has settled; the first re-estimate may jump
            qp = max(self.last_qp - 3, min(self.last_qp + 3, qp))
        qp = max(self.min_qp, min(self.max_qp, qp))
        self._pending = (qp, lam)
        return qp

    def update(self, actual_bits: int) -> None:
        """Model adaptation from realized bits
        (TEncRCPic::updateAfterPicture)."""
        qp, lam_used = self._pending
        bpp = max(actual_bits / self.pixels, 1e-7)
        prev = getattr(self, "_last_obs", None)
        if not self.history:
            # one-shot refit from the first observation: the generic
            # alpha seed can be far off for arbitrary content
            self.alpha = lam_used / (bpp ** self.beta)
        elif (prev is not None
              and abs(math.log(bpp) - math.log(prev[1])) > 0.05
              and abs(math.log(lam_used) - math.log(prev[0])) > 1e-6):
            # two-point slope refit: the generic beta badly misjudges how
            # steeply lambda moves bits on some content, and the HM
            # per-picture nudge takes dozens of pictures to catch up
            b_est = ((math.log(lam_used) - math.log(prev[0]))
                     / (math.log(bpp) - math.log(prev[1])))
            b_est = max(BETA_MIN, min(BETA_MAX, b_est))
            self.beta = 0.5 * self.beta + 0.5 * b_est
            self.alpha = lam_used / (bpp ** self.beta)
        else:
            lam_comp = self._lambda(bpp)
            delta = math.log(lam_used) - math.log(lam_comp)
            self.alpha += DELTA_ALPHA * delta * self.alpha
            self.beta += DELTA_BETA * delta * math.log(bpp)
        self._last_obs = (lam_used, bpp)
        self.alpha = max(ALPHA_MIN, min(ALPHA_MAX, self.alpha))
        self.beta = max(BETA_MIN, min(BETA_MAX, self.beta))
        self.last_qp = qp
        self.history.append((qp, lam_used,
                             self.bpp_target * self.pixels, actual_bits))


def encode_rate_controlled(frames: list, width: int, height: int,
                           target_bps: float, frame_rate: float = 30.0,
                           device=None, **enc_kw) -> tuple:
    """Encode frames under picture-level RC. Returns (streams, rc).

    Each picture uses an encoder at the RC-chosen QP (one per QP, kept for
    the pictures that come back to it), on ``device`` (the card unless the
    caller names another)."""
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    rc = RateControl(target_bps, frame_rate, width, height)
    encoders: dict = {}
    streams = []
    for (y, cb, cr) in frames:
        qp = rc.pic_qp()
        enc = encoders.get(qp)
        if enc is None:
            enc = encoders[qp] = IntraEncoder(
                EncoderConfig(width=width, height=height, qp=qp, **enc_kw),
                device=device)
        s = enc.encode_frame(y, cb, cr)
        streams.append(s)
        rc.update(len(s) * 8)
    return streams, rc
