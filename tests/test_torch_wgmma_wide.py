"""The wide head dims' routes (``csrc/attention_wide.cuh``): the forward
and dq at 192 <= D <= 512 in bf16 and f16 run the wgmma kernels, D > 512
and dk/dv the column-chunk kernels. Here: the plain versions the port keeps
beside those kernels at the dims this route adds to the checks, D = 448 (a
column split of 2 x 224) and D = 640 (the chunk kernels), against the
reference's Pallas kernels in interpret mode; the route rule and the
design each kernels-line row names; and the build report's parser on the
new kernels' names. The kernels themselves are held against these plain
versions on the card by ``chip_smoke.py`` phase 23a."""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wide_tests():
    spec = importlib.util.spec_from_file_location(
        "wide_head_dims", os.path.join(_ROOT, "tests",
                                       "test_torch_wide_head_dims.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (family, D, S, dtype, causal): the new checks' dims, on the plain versions
CASES = [
    ("simple", 448, 128, "bfloat16", True),
    ("blocked", 448, 128, "float32", True),
    ("simple", 640, 128, "float32", False),
    ("blocked", 640, 128, "bfloat16", True),
]


@pytest.mark.parametrize(
    "family,d,s,dname,causal", CASES,
    ids=[f"{c[0]}-d{c[1]}-s{c[2]}-{c[3]}-{'causal' if c[4] else 'full'}"
         for c in CASES])
def test_plain_versions_at_new_dims_match_interpret_kernels(family, d, s,
                                                            dname, causal):
    """o, dq, dk and dv of the port's plain versions against the
    reference's Pallas kernels in interpret mode at D = 448 and 640."""
    wide = _wide_tests()
    arrays = wide._inputs(s, d, seed=d + s)
    scale = 1.0 / math.sqrt(d)
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    want_o, want_g = wide._reference(family, *(jnp.asarray(x).astype(jdt)
                                               for x in arrays), scale,
                                     causal)
    got_o, got_g = wide._port(family, *(torch.from_numpy(x).to(tdt)
                                        for x in arrays), scale, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), (got_o, *got_g),
                          (want_o, *want_g)):
        assert g.dtype == tdt and tuple(g.shape) == (wide.B, wide.H, s, d)
        err = wide._rel_err(g.float(), w.astype(jnp.float32))
        assert err < wide.TOL[dname], (name, err)


def test_wgmma_route_is_192_to_512_without_the_tiled_dims():
    """The dims of the wgmma kernels among those the wrappers admit: every
    multiple of 64 from 192 to 512 but 256, which has tiles of its own."""
    cs = _chip_smoke()
    from paddle_tpu_torch.ops.hopper import _launch
    picked = [d for d in range(64, 1100, 64)
              if _launch.head_dim_ok(d) and cs.wgmma_wide(d)]
    assert picked == [192, 320, 384, 448, 512]


def test_kernels_line_design_names_each_route():
    """Each wide row of the kernels line names the design its launches
    run: the wgmma one for forwards and dq at D <= 512, the chunk one for
    dk/dv and above 512, both for a backward row of two launches."""
    cs = _chip_smoke()
    assert cs.wide_design("blocked_flash_fwd", 512) == cs.WGMMA_DESIGN
    assert cs.wide_design("library_flash_bwd_dq", 192) == cs.WGMMA_DESIGN
    assert cs.wide_design("blocked_flash_bwd_dkv", 384) == cs.CHUNK_DESIGN
    assert cs.wide_design("blocked_flash_fwd", 640) == cs.CHUNK_DESIGN
    both = cs.wide_design("simple_attention_bwd", 384)
    assert both.startswith(f"dq: {cs.WGMMA_DESIGN}") and \
        both.endswith(f"dk/dv: {cs.CHUNK_DESIGN}")
    assert {row[1] for row in cs.WIDE_ROWS} <= {192, 384, 512}


# -Xptxas -v lines of the kind nvcc prints for the new kernels
PTXAS_LOG = """\
ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'
ptxas info    : Function properties for {fwd}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 816 bytes cmem[0]
ptxas info    : Compiling entry function '{dq}' for 'sm_90a'
ptxas info    : Function properties for {dq}
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 1072 bytes cmem[0]
ptxas info    : Compiling entry function '{old}' for 'sm_90a'
ptxas info    : Function properties for {old}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 560 bytes cmem[0]
""".format(
    fwd="_ZN12_GLOBAL__N_121wgmma_wide_fwd_kernelI13__nv_bfloat16Li448ELb1E"
        "EEv14CUtensorMap_stS2_S2_PT_PfNS_6LayoutEiifi",
    dq="_ZN12_GLOBAL__N_120wgmma_wide_dq_kernelI6__halfLi512ELb0EEEv14CUte"
       "nsorMap_stS2_S2_S2_NS_7BwdArgsEPT_NS_6LayoutE",
    old="_ZN12_GLOBAL__N_119mma_wide_fwd_kernelI13__nv_bfloat16Lb0EEEvPKT_"
        "S4_S4_PS2_PfNS_6LayoutES7_S7_iiifi")


def test_ptxas_rows_read_the_wgmma_kernels():
    """The build report reads each new kernel's name with its dtype, head
    dim and form, its registers and its spilled bytes, beside the chunk
    kernels' rows."""
    rows = _chip_smoke().ptxas_rows(PTXAS_LOG)
    assert rows == [
        ("wgmma_wide_fwd_kernel<__nv_bfloat16,448,online>", 168, 0),
        ("wgmma_wide_dq_kernel<__half,512,recompute>", 168, 12),
        ("mma_wide_fwd_kernel<__nv_bfloat16,two-pass>", 128, 0),
    ]
    assert all(k.startswith(("mma_", "wide_", "wgmma_")) for k, _, _ in rows)
