"""Device ms of kernels C8's and C11's entries on one tree, on the card.

    python3 tools/mc_warp_entries.py <tree>

imports <tree>'s chip_smoke and hevc_hop_torch (a checkout, or one
unpacked with git archive) and times, on the shapes of PERF.md's kernel
table rows and synthetic 1920x1088 planes (seed 20): C8 on 12 chroma 8x8
blocks in the masked form and on 6 luma 16x16 blocks with the residual;
C11 on 50 chroma 8x8 blocks (every other one selected) in the masked form
and on 25 luma 16x16 blocks (the same selection) with the residual. The
device ms per call come from torch.profiler, 10 calls a trace
(chip_smoke._traced_ms). Prints one line, ENTRIES <tree> {json}. Run two
trees in turns in one call to compare them.
"""
import json
import os
import sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from hevc_hop_torch import _cuda  # noqa: E402
from hevc_hop_torch.ops import interp, warp  # noqa: E402

_cuda.lib("interp")
_cuda.lib("warp")
dev = torch.device("cuda")
rng = np.random.default_rng(20)
t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
W, H = 1920, 1088
hc_off = H // 2 + 8
y = t(rng.integers(0, 256, (H + 16, W)))
c = t(rng.integers(0, 256, (2 * hc_off, W // 2)))
resi_y = t(rng.integers(-40, 40, (H + 16, W)))
resi_c = t(rng.integers(-40, 40, (2 * hc_off, W // 2)))


def blocks(b, n, w, h, step):
    g = np.stack(np.meshgrid(np.arange(64, w - n - 64, step),
                             np.arange(64, h - n - 64, step)),
                 -1).reshape(-1, 2)[:b]
    return g


out = {}
pos = blocks(6, 8, W // 2, H // 2, 96)
cpos = t(np.concatenate([pos, pos + [0, hc_off]]))
mv = t(rng.integers(-60, 60, (6, 2)))
only = t(rng.random(6) < 0.7)
base = torch.zeros((12, 8, 8), dtype=torch.int32, device=dev)
out["C8 12 chroma 8x8 masked"] = cs._traced_ms(
    lambda: interp.mc_blocks(c, cpos, mv, 8, True, H // 2, 8, hc_off,
                             out=base, only=only), "mc_kernel", "c8c")[0]
ypos = t(blocks(6, 16, W, H, 200))
ymv = t(rng.integers(-60, 60, (6, 2)))
out["C8 6 luma 16x16 decode"] = cs._traced_ms(
    lambda: interp.mc_blocks(y, ypos, ymv, 16, False, H, 8, resi=resi_y),
    "mc_kernel", "c8y")[0]
pos = blocks(25, 8, W // 2, H // 2, 64)
cpos = t(np.concatenate([pos, pos + [0, hc_off]]))
mv = t(rng.integers(-40, 40, (25, 2)))
gtc = t(rng.integers(-8, 9, (25, 6)))
only = t(np.arange(25) % 2 == 0)
base = torch.zeros((50, 8, 8), dtype=torch.int32, device=dev)
out["C11 50 chroma 8x8 masked"] = cs._traced_ms(
    lambda: warp.gt_pred_blocks(c, cpos, mv, gtc, 8, True, H // 2, 8, hc_off,
                                out=base, only=only), "gt_pred_kernel",
    "c11c")[0]
ypos = t(blocks(25, 16, W, H, 120))
ymv = t(rng.integers(-40, 40, (25, 2)))
ygtc = t(rng.integers(-16, 17, (25, 6)))
out["C11 25 luma 16x16 decode"] = cs._traced_ms(
    lambda: warp.gt_pred_blocks(y, ypos, ymv, ygtc, 16, False, H, 8,
                                resi=resi_y, only=only), "gt_pred_kernel",
    "c11y")[0]
print("ENTRIES", tree, json.dumps(out), flush=True)
