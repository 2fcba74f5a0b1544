"""chip_smoke.py's readings of the sky kernel's build, on the CPU: the
registers and spills of each entry function from nvcc's -Xptxas -v log
(ptxas_resources), the static SASS instructions of each function by
opcode from cuobjdump -sass (count_sass), and the mangled name of the template a sky
call launches (sky_variant), which both are looked up by."""

import pytest
import torch

import chip_smoke
from superconductor_tpu_torch.ops import sky as port_sky
from test_torch_deferred_card import SKY_CASES, sky_args

torch.set_num_threads(2)

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN36_GLOBAL__N__ab_6_sky_cu_sc_sky10sky_kernelILi1ELi1ELi1ELi1ELi1ELi1EEEvNS_7SkyArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN36_GLOBAL__N__ab_6_sky_cu_sc_sky10sky_kernelILi1ELi1ELi1ELi1ELi1ELi1EEEvNS_7SkyArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 160 bytes smem, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN36_GLOBAL__N__ab_6_sky_cu_sc_sky10sky_kernelILi1ELi1ELi0ELi0ELi1ELi0EEEvNS_7SkyArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN36_GLOBAL__N__ab_6_sky_cu_sc_sky10sky_kernelILi1ELi1ELi0ELi0ELi1ELi0EEEvNS_7SkyArgsE
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 160 bytes smem, 528 bytes cmem[0]
"""

SASS = """\

Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : _Z1fv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
                                                                                     /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                              /* 0x0000000000007919 */
                                                                                     /* 0x000e220000002100 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x3, PT ;              /* 0x000000030000780c */
                                                                                     /* 0x001fda0003f06270 */
        /*0030*/               @P0 EXIT ;                                          /* 0x000000000000094d */
                                                                                     /* 0x000fea0003800000 */
        /*0040*/                   EXIT ;                                          /* 0x000000000000794d */
                                                                                     /* 0x000fea0003800000 */
        /*0050*/                   BRA 0x50;                                       /* 0xfffffffc00fc7947 */
                                                                                     /* 0x000fc0000383ffff */
        /*0060*/                   NOP;                                            /* 0x0000000000007918 */
                                                                                     /* 0x000fc00000000000 */
\t\t..........


\t\tFunction : _Z1gv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   EXIT ;                                          /* 0x000000000000794d */
                                                                                     /* 0x000fea0003800000 */
        /*0010*/                   BRA 0x10;                                       /* 0xfffffffc00fc7947 */
                                                                                     /* 0x000fc0000383ffff */
"""


def test_ptxas_resources_reads_registers_and_spills():
    res = chip_smoke.ptxas_resources(PTXAS_LOG)
    assert len(res) == 2
    (a, ra), (b, rb) = sorted(res.items())
    assert "ILi1ELi1ELi0ELi0ELi1ELi0E" in a and ra == (48, 16, 12, 12)
    assert "ILi1ELi1ELi1ELi1ELi1ELi1E" in b and rb == (56, 0, 0, 0)


def test_count_sass_counts_instructions_not_nops():
    """Every instruction line by opcode (its modifiers dropped), predicated
    ones included; the encodings' second lines and the padding NOPs are
    not instructions."""
    counts = chip_smoke.count_sass(SASS)
    assert counts == {"_Z1fv": {"LDC": 1, "S2R": 1, "ISETP": 1, "EXIT": 2, "BRA": 1},
                      "_Z1gv": {"EXIT": 1, "BRA": 1}}
    assert sum(counts["_Z1fv"].values()) == 6


@pytest.mark.parametrize("case", sorted(SKY_CASES))
def test_sky_variant_names_its_function(case):
    """The mangled fragment of a call's template: its six int arguments in
    order, as nvcc mangles sky_kernel<...>."""
    name, args = sky_args(case)
    variant, fragment = chip_smoke.sky_variant(name, args)
    assert variant == port_sky.kernel_variant(args["scene"], args["env"],
                                              name == "sample_skybox",
                                              args["inline_tonemapping"], args["inline_srgb"])
    assert fragment == "10sky_kernelI" + "".join(f"Li{v}E" for v in variant) + "EE"
