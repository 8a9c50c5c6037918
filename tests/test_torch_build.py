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
    assert chip_smoke._kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert chip_smoke._kind("nvjet_tst_128x64_64x4") == "gemm"
    assert chip_smoke._kind("elementwise_kernel") == "other"


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
