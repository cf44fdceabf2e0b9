"""hevc_hop_torch as a package: it loads neither JAX nor the JAX package,
its entry points default to the card, its constant tables equal the
reference's, and every configuration of the reference's intra
EncoderConfig builds."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hevc_hop_tpu.common import rom as jrom
from hevc_hop_tpu.models.encoder import EncoderConfig as JaxConfig
from hevc_hop_tpu.ops import deblock as jdb
from hevc_hop_tpu.ops import intra as jintra
from hevc_hop_torch import convert
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "hevc_hop_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',"
            " 'hevc_hop_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    assert len(mods) > 20
    # the lenslet ISS and PSS slices' modules (PSS adds none of its own),
    # the GT warp's among them, and the mesh slice's
    assert {"hevc_hop_torch.models.decoder", "hevc_hop_torch.utils.cli",
            "hevc_hop_torch.ops.interp", "hevc_hop_torch.ops.ss_search",
            "hevc_hop_torch.ops.inter_arms", "hevc_hop_torch.models.ss_scan",
            "hevc_hop_torch.models.ss_partition",
            "hevc_hop_torch.models.ss_encoder", "hevc_hop_torch.ops.warp",
            "hevc_hop_torch.ops.gt", "hevc_hop_torch.parallel.shard_encode",
            "hevc_hop_torch.parallel.mesh"} <= set(mods)


def _supported(**kw):
    return EncoderConfig(width=64, height=64, cu_log2=4, rdoq=False, **kw)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        IntraEncoder(_supported())
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        HoloEncoder(HoloConfig(gt=False))


def test_device_tables_equal_reference_tables():
    tabs = convert.device_tables("cpu")
    want = {f"dct{n}": jrom.dct_matrix(n) for n in (4, 8, 16, 32)}
    want.update(dst4=jrom.DST4, quant_scales=jrom.QUANT_SCALES,
                inv_quant_scales=jrom.INV_QUANT_SCALES,
                hadamard4=jintra._hadamard(4), hadamard8=jintra._hadamard(8),
                tc_table=jdb.TC_TABLE, beta_table=jdb.BETA_TABLE)
    for n in (4, 8, 16, 32):
        for k, v in jintra._static_tables(n).items():
            want[f"intra{n}_{k}"] = v
    for log2 in (2, 3, 4, 5):
        want[f"scan{log2}"] = np.stack(
            [jrom.scan_raster_index(log2, s) for s in (0, 1, 2)])
    assert set(tabs) == set(want)
    for k, v in want.items():
        assert tabs[k].dtype == torch.int32
        np.testing.assert_array_equal(tabs[k].numpy(), v, err_msg=k)


def test_config_from_reference():
    for ref in (JaxConfig(width=416, height=240, qp=27, cu_log2=3,
                          rdoq=False),
                JaxConfig(width=1920, height=1088, qp=32, sao=True,
                          rdoq=False),
                # bench.py's production configuration: RDOQ on
                JaxConfig(width=1920, height=1088, qp=32, sao=True)):
        cfg = convert.config_from_reference(dataclasses.asdict(ref))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        IntraEncoder(cfg, device="cpu")
    with pytest.raises(ValueError):
        convert.config_from_reference({"width": 64, "rate_control": True})


def test_default_encoder_config_constructs():
    """The reference's defaults, RDOQ on, build on the CPU."""
    cfg = EncoderConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxConfig())
    assert cfg.rdoq
    enc = IntraEncoder(cfg, device="cpu")
    assert enc.sps.max_transform_hierarchy_depth_intra == 1


@pytest.mark.parametrize("kw", [
    dict(sao=True), dict(cu_log2=None), dict(cu_log2=None, sao=True),
    dict(cu_log2=None, rqt=False), dict(cu_log2=None, nxn=False),
    dict(cu_log2=None, rqt=False, nxn=False, sao=True, bit_depth=10),
    dict(cu_log2=None, rdoq=True, sao=True),
    dict(cu_log2=None, mode_decision="rmd", rdoq=True),
    dict(cu_log2=None, rdoq=True, bit_depth=10)])
def test_ported_encoder_configurations_construct(kw):
    """The quadtree pre-pass, NxN, the residual quadtree, SAO and RDOQ are
    ported: every configuration builds."""
    enc = IntraEncoder(dataclasses.replace(_supported(), **kw), device="cpu")
    quadtree = (kw.get("cu_log2", 4) is None
                and kw.get("mode_decision", "analysis") == "analysis")
    assert enc.sps.sao_enabled == bool(kw.get("sao"))
    assert enc.sps.max_transform_hierarchy_depth_intra == int(
        quadtree and kw.get("rqt", True))


def test_quadtree_prepass_needs_a_32x32_ctu():
    with pytest.raises(ValueError, match="ctb_log2"):
        IntraEncoder(EncoderConfig(width=64, height=64, rdoq=False,
                                   ctb_log2=4), device="cpu")
