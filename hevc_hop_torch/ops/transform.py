"""Forward/inverse integer transforms, plain PyTorch version.

Counterpart of hevc_hop_tpu/ops/transform.py. On the card the transforms run
inside kernel C3 (``csrc/tq.cu``, wrapped by ``ops/tq.py``), fused with the
quantizer; the functions here are that kernel's plain version and run on any
device.

Bit-exactness: every product and sum is an integer below 2**31 (the first
inverse stage peaks near 9.4e7), so a float64 matrix product is exact; the
result is cast back to int32 before the H.265 8.6.4 shift/round/clip.
torch has no integer matrix product on CUDA, which is why float64 is used.
"""
from __future__ import annotations

import functools

import torch

from hevc_hop_torch.common import rom
from hevc_hop_torch.common.types import COEF_MIN, COEF_MAX


@functools.lru_cache(maxsize=None)
def _mat_np(n: int, dst: bool):
    return rom.DST4 if dst else rom.dct_matrix(n)


def _mat(n: int, dst: bool, device) -> torch.Tensor:
    return torch.as_tensor(_mat_np(n, dst), dtype=torch.float64,
                           device=device)


def _rshift_round(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def fwd_transform(resi: torch.Tensor, bit_depth: int = 8,
                  use_dst: bool = False) -> torch.Tensor:
    """Forward 2-D transform of [..., N, N] int32 residual blocks (HM's
    encoder shifts: log2N + bitDepth - 9, then log2N + 6)."""
    n = resi.shape[-1]
    log2n = n.bit_length() - 1
    t = _mat(n, use_dst, resi.device)
    tmp = _rshift_round(_mm(resi, t.T), log2n + bit_depth - 9)
    return _rshift_round(_mm(t, tmp), log2n + 6)


def inv_transform(coef: torch.Tensor, bit_depth: int = 8,
                  use_dst: bool = False) -> torch.Tensor:
    """Inverse 2-D transform (H.265 8.6.4, both 16-bit clamps)."""
    n = coef.shape[-1]
    t = _mat(n, use_dst, coef.device)
    e = torch.clamp(_rshift_round(_mm(t.T, coef), 7), COEF_MIN, COEF_MAX)
    r = _rshift_round(_mm(e, t), 20 - bit_depth)
    return torch.clamp(r, COEF_MIN, COEF_MAX)
