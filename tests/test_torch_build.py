"""The kernel build's bookkeeping and `chip_smoke.py`'s reading of it, on
the CPU (no nvcc here: a library and its log are laid down by hand).

`_build.library_path` keys a library by its sources, `_build.build_log`
returns the nvcc output kept beside a built library, and
`chip_smoke.flash_instantiations` turns ``-Xptxas -v`` output into the
registers and spill bytes of each instantiation of the flash kernel's two
bodies, and `chip_smoke._kind` files profiled kernels under their kernel.
"""
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

_NS = "_ZN45_GLOBAL__N__b3b144b4_12_flash_fwd_cu_bb92b78a"
_VS = "_ZN42_GLOBAL__N__0c1d2e3f_9_vsconv_cu_4a5b6c7d"
_DW = "_ZN45_GLOBAL__N__1a2b3c4d_12_vsconv_dw_cu_5e6f7a8b"
PTXAS = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_NS}16flash_mma_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiifi' for 'sm_90a'
ptxas info    : Function properties for {_NS}16flash_mma_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '{_NS}16flash_mma_kernelILi240EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiifi' for 'sm_90a'
ptxas info    : Function properties for {_NS}16flash_mma_kernelILi240EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 237 registers, used 1 barriers
ptxas info    : Compiling entry function '{_NS}17flash_simt_kernelIfLi3EEEvPKT_S3_S3_PS1_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for {_NS}17flash_simt_kernelIfLi3EEEvPKT_S3_S3_PS1_iiiiiif
    24 bytes stack frame, 20 bytes spill stores, 116 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z11vsmm_kernelPKfS0_' for 'sm_90a'
ptxas info    : Function properties for _Z11vsmm_kernelPKfS0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


def test_ptxas_usage_reads_every_entry_function():
    usage = chip_smoke.ptxas_usage(PTXAS)
    assert len(usage) == 4
    assert usage["_Z11vsmm_kernelPKfS0_"] == {
        "registers": 64, "spill_stores": 0, "spill_loads": 0}


def test_flash_instantiations_name_body_and_head_dim():
    rows = chip_smoke.flash_instantiations(PTXAS)
    assert rows == [
        {"body": "mma", "hd": 128, "registers": 128, "spill_stores": 0,
         "spill_loads": 0},
        {"body": "mma", "hd": 240, "registers": 237, "spill_stores": 0,
         "spill_loads": 0},
        {"body": "simt", "hd": 96, "registers": 128, "spill_stores": 20,
         "spill_loads": 116},
    ]


def test_profile_kinds_name_every_kernel():
    assert {chip_smoke._kind(n) for n in (
        f"{_NS}16flash_mma_kernelILi128EEEvPK13__nv_bfloat16",
        f"{_NS}17flash_simt_kernelIfLi4EEEvPKT_")} == {"flash_fwd"}
    assert chip_smoke._kind("void vsconv_dw_halo_kernel<4>(...)") == \
        "vsconv_dw_halo"
    assert chip_smoke._kind("void vsconv_halo_kernel(...)") == "vsconv_halo"
    # the stem bodies are filed under their kernels, demangled or not
    for name, kind in (
            ("void (anonymous namespace)::vsconv_halo_stem_kernel<2, 8>("
             "const float *, ...)", "vsconv_halo"),
            ("void (anonymous namespace)::vsconv_stack_stem_kernel<1, 8>("
             "const float *, ...)", "vsconv_stack"),
            (f"{_VS}23vsconv_halo_stem_kernelILi2ELi8EEEvPKfS1_",
             "vsconv_halo"),
            (f"{_VS}24vsconv_stack_stem_kernelILi1ELi16EEEvPKfS1_",
             "vsconv_stack"),
            ("void (anonymous namespace)::vsconv_dw_stack_kernel<0, 1>("
             "const float *, ...)", "vsconv_dw_stack"),
            (f"{_DW}21vsconv_dw_halo_kernelILi128ELi4EEEvPKfS1_",
             "vsconv_dw_halo")):
        assert chip_smoke._kind(name) == kind, name
    assert chip_smoke._kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert chip_smoke._kind("nvjet_tst_128x64_64x4") == "gemm"
    assert chip_smoke._kind("elementwise_kernel") == "other"


def _entry(name: str, regs: int, spill: int = 0) -> str:
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\n    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\nptxas info    : Used {regs} "
            f"registers, used 1 barriers\n")


def test_stencil_instantiations_name_body_and_template():
    conv = (_entry(f"{_VS}23vsconv_halo_stem_kernelILi2ELi8EEEvPKf", 90)
            + _entry(f"{_VS}24vsconv_stack_stem_kernelILi1ELi16EEEvPKf", 70,
                     spill=8)
            + _entry("_Z18vsconv_halo_kernelPKf", 64))   # the generic body
    dw = _entry(f"{_DW}21vsconv_dw_halo_kernelILi0ELi1EEEvPKf", 40)
    rows = chip_smoke.stencil_instantiations(conv, dw)
    assert {r["kernel"] for r in rows} == {
        "vsconv_halo_stem", "vsconv_stack_stem", "vsconv_dw_halo"}
    by = {r["kernel"]: r for r in rows}
    assert by["vsconv_halo_stem"] == {
        "kernel": "vsconv_halo_stem", "vn": 64, "c": 8, "registers": 90,
        "spill_stores": 0, "spill_loads": 0}
    assert by["vsconv_stack_stem"]["vn"] == 32
    assert by["vsconv_stack_stem"]["c"] == 16
    assert by["vsconv_stack_stem"]["spill_stores"] == 8
    assert by["vsconv_dw_halo"] == {
        "kernel": "vsconv_dw_halo", "vc": 0, "vec": 1, "registers": 40,
        "spill_stores": 0, "spill_loads": 0}


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    (csrc / "common.cuh").write_text("// a header\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return csrc


def test_library_path_follows_the_sources(build_dir):
    first = _build.library_path("k")
    assert first.parent == _build.BUILD and first.suffix == ".so"
    (build_dir / "common.cuh").write_text("// an edited header\n")
    assert _build.library_path("k") != first


def test_build_log_is_kept_beside_a_built_library(build_dir):
    lib = _build.library_path("k")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")          # built already: no nvcc is started
    lib.with_suffix(".log").write_text(PTXAS)
    assert _build.build("k") == {}
    assert _build.build_log("k") == PTXAS


_MM = "_ZN12_GLOBAL__N__2b3c4d5e_7_vsmm_cu_6f7a8b9c"


def test_profile_kinds_file_the_new_entry_functions():
    """vsmm's phase-1 and phase-2 kernels and the int8 stem bodies are
    filed under their kernel and branch."""
    for name, kind in (
            (f"{_MM}11vsmm_kernelILi2EEEvPKfS1_", "vsmm"),
            (f"{_MM}18vsmm_reduce_kernelEPKfS1_", "vsmm"),
            (f"{_MM}16vsmm_int8_kernelILi8ELb1EEEvPKa", "vsmm_int8"),
            (f"{_MM}23vsmm_int8_reduce_kernelEPK4int2", "vsmm_int8"),
            ("void (anonymous namespace)::vsconv_halo_stem_int8_kernel<2, 8>("
             "const signed char *, ...)", "vsconv_halo_int8"),
            (f"{_VS}29vsconv_stack_stem_int8_kernelILi1ELi8EEEvPKa",
             "vsconv_stack_int8")):
        assert chip_smoke._kind(name) == kind, name


def test_vsmm_and_int8_instantiations_name_their_templates():
    mm = (_entry(f"{_MM}11vsmm_kernelILi8EEEvPKf", 96)
          + _entry(f"{_MM}18vsmm_reduce_kernelEPKf", 20)
          + _entry(f"{_MM}16vsmm_int8_kernelILi2ELb0EEEvPKa", 60)
          + _entry(f"{_MM}16vsmm_int8_kernelILi8ELb1EEEvPKa", 110, spill=4)
          + _entry(f"{_MM}23vsmm_int8_reduce_kernelEPK4int2", 30))
    rows = chip_smoke.vsmm_instantiations(mm)
    assert [(r["kernel"], r.get("rt"), r.get("split")) for r in rows] == [
        ("vsmm", 8, None), ("vsmm_int8", 2, False), ("vsmm_int8", 8, True),
        ("vsmm_int8_reduce", None, None), ("vsmm_reduce", None, None)]
    assert rows[2]["spill_stores"] == 4
    conv = (_entry(f"{_VS}29vsconv_stack_stem_int8_kernelILi2ELi16EEEvPKa",
                   80)
            + _entry(f"{_VS}23vsconv_halo_stem_kernelILi2ELi8EEEvPKf", 90)
            + _entry(f"{_VS}23vsconv_halo_int8_kernelEPKa", 64))
    dw = _entry(f"{_DW}26vsconv_dw_halo_int8_kernelILi128ELi4EEEvPKa", 48)
    rows = chip_smoke.int8_instantiations({"vsmm": mm, "vsconv": conv,
                                           "vsconv_dw": dw})
    by = {r["kernel"]: r for r in rows}
    assert set(by) == {"vsmm_int8", "vsmm_int8_reduce", "vsconv_halo_int8",
                       "vsconv_stack_stem_int8", "vsconv_dw_halo_int8"}
    assert len(rows) == 6  # two vsmm_int8 instantiations
    assert (by["vsconv_stack_stem_int8"]["vn"],
            by["vsconv_stack_stem_int8"]["c"]) == (64, 16)
    assert (by["vsconv_dw_halo_int8"]["vc"],
            by["vsconv_dw_halo_int8"]["vec"]) == (128, 4)
    stencils = chip_smoke.stencil_instantiations(conv, dw)
    assert {r["kernel"] for r in stencils} == {"vsconv_stack_stem_int8",
                                               "vsconv_halo_stem"}
