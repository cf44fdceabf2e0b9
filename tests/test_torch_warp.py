"""hevc_hop_torch's GT corner warp (kernel C11's plain version) against the
JAX reference's ``warp_blocks``: the prediction and the safety mask equal
exactly, on every golden case of tests/golden/hm_golden.json and on a
seeded sweep of both forms (luma n = 8, 16, 32; chroma, half-pel, m = 4,
8, 16) at 8 and 10 bit, with corner offsets up to +-n that reach the clamp
and the knife edges."""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.ops import warp as jwarp
from hevc_hop_torch.ops import warp

GOLDEN = pathlib.Path(__file__).parent / "golden" / "hm_golden.json"
T = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's worker: the suite runs parallel
    workers, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(win, corners, n, bd=8, half=False):
    want = jwarp.warp_blocks(jnp.asarray(win), jnp.asarray(corners), n, bd,
                             half)
    got = warp.warp_blocks(T(win), T(corners), n, bd, half)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return got


def test_warp_golden_cases():
    cases = json.loads(GOLDEN.read_text())["gt_warp"]
    assert len(cases) == 12
    for case in cases:
        n = case["n"]
        win = np.array(case["win"], np.int32).reshape(1, 2 * n, 2 * n)
        gtv = np.array(case["gt"], np.int32).reshape(1, 4, 2)
        pred, safe = _same(win, gtv, n)
        if bool(safe[0]):
            # off the knife edges, the reference decoder's own output
            np.testing.assert_array_equal(
                pred[0].numpy(), np.array(case["dst"]).reshape(n, n))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("half", [False, True], ids=["luma", "chroma"])
def test_warp_sweep(half, bd):
    """256 blocks per size: random windows (a quarter of them smooth
    ramps, where rounding ties are common), corner offsets up to +-n (up to
    +-2n half-pel for chroma), the identity and small integral moves, which
    land on truncation boundaries."""
    rng = np.random.default_rng(bd + 2 * half)
    unsafe = 0
    for n in ((4, 8, 16) if half else (8, 16, 32)):
        b = 256
        win = rng.integers(0, 1 << bd, (b, 2 * n, 2 * n))
        ramp = (np.arange(2 * n)[None, :, None] * 3
                + np.arange(2 * n)[None, None, :] * 5) % (1 << bd)
        win[: b // 4] = ramp
        reach = 2 * n if half else n
        corners = rng.integers(-reach, reach + 1, (b, 4, 2))
        corners[b // 4: b // 2] = rng.integers(-1, 2, (b // 4, 4, 2))
        corners[:8] = 0
        _, safe = _same(win, corners, n, bd, half)
        unsafe += int((~safe).sum())
    assert unsafe > 0, "the sweep should reach the knife edges"


def test_trunc_div_toward_zero():
    a = np.arange(-50, 51, dtype=np.int32)
    np.testing.assert_array_equal(warp.trunc_div_tz(T(a), 7).numpy(),
                                  np.asarray(jwarp._trunc_div_tz(a, 7)))
