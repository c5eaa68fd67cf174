"""The kernel library's build plan, on the CPU (no ``nvcc`` is run).

``ops/_kernels.py`` names the library by a hash of every file under
``csrc/`` (sources and the headers they include) and compiles only the
``.cu`` sources, one ``nvcc`` each, and keeps ptxas's ``-v`` report
beside the library.  These tests point ``CSRC`` at a temporary tree and
stand in for ``nvcc``.
"""

from pathlib import Path

import pytest

from tpu_network_operator_torch.ops import _kernels

# ptxas -v's report of two kernels as nvcc names them, the first with a
# serialization note (lines from a real build of flash_bwd.cu, once
# serialized, and rms_norm_fwd.cu)
DQ = ("_ZN45_GLOBAL__N__922062ec_12_flash_bwd_cu_e05f861519flash_bwd_dq_kernel"
      "ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_PviiiiiNS_7StridesEfii")
RMS = ("_ZN48_GLOBAL__N__0056cede_15_rms_norm_fwd_cu_2e798a9f19rms_norm_fwd_"
       "kernelI13__nv_bfloat16Li8ELi8EEEvPKT_S4_PS2_Pfiif")
PTXAS_LOG = f"""\
ptxas info    : (C7519) warpgroup.arrive is injected in around line 11699 by compiler to allow use of registers in GMMA in function '{DQ}'
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '{DQ}'
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{DQ}' for 'sm_90a'
ptxas info    : Function properties for {DQ}
    56 bytes stack frame, 296 bytes spill stores, 104 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '{RMS}' for 'sm_90a'
ptxas info    : Function properties for {RMS}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 143 registers, used 0 barriers
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "hopper.cuh").write_text("// shared header\n")
    (csrc / "a.cu").write_text('#include "hopper.cuh"\n')
    (csrc / "b.cu").write_text("// another source\n")
    (csrc / "notes.txt").write_text("not part of the build\n")
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_editing_a_header_changes_the_library(tree):
    before = _kernels.library_path()
    assert _kernels.library_path() == before           # stable
    (tree / "hopper.cuh").write_text("// shared header, edited\n")
    after = _kernels.library_path()
    assert after != before and after.parent == before.parent
    (tree / "notes.txt").write_text("edited\n")         # not a build input
    assert _kernels.library_path() == after
    (tree / "b.cu").write_text("// edited source\n")
    assert _kernels.library_path() != after


def test_only_sources_are_compiled(tree, monkeypatch):
    calls = []

    def fake_run(cmds, what):
        calls.append((what, cmds))
        for cmd in cmds:                                # make each output
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return [PTXAS_LOG if what == "compile" else ""] * len(cmds)

    monkeypatch.setattr(_kernels, "_run", fake_run)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    target = _kernels.build()
    assert target == _kernels.library_path() and target.exists()
    (what, compiles), (link_what, links) = calls
    assert what == "compile" and link_what == "link" and len(links) == 1
    compiled = sorted(Path(c[c.index("-c") + 1]).name for c in compiles)
    assert compiled == ["a.cu", "b.cu"]                 # no header on its own
    objs = [Path(a).stem for a in links[0] if str(a).endswith(".o")]
    assert sorted(objs) == ["a", "b"]                   # one object each
    assert all("-Xptxas" in c and "-v" in c for c in compiles)
    report = _kernels.ptxas_report()                    # kept with the library
    assert report["kernels"]["flash_bwd_dq_kernel<64>"]["registers"] == 168
    calls.clear()
    assert _kernels.build() == target and not calls     # cached: no rebuild


def test_ptxas_report_reads_registers_spills_and_notes():
    report = _kernels.parse_ptxas(PTXAS_LOG)
    assert report["kernels"] == {
        "flash_bwd_dq_kernel<64>": {"spill_stores": 296, "spill_loads": 104,
                                    "registers": 168},
        "rms_norm_fwd_kernel<__nv_bfloat16,8,8>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 143},
    }
    # the C7512 note, not C7519's (registers handed over, no serializing)
    (note,) = report["wgmma_serialized"]
    assert note.startswith("ptxas info    : (C7512)")
    assert _kernels.parse_ptxas("")["wgmma_serialized"] == []
