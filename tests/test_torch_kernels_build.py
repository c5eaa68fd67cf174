"""The kernel library's build plan, on the CPU (no ``nvcc`` is run).

``ops/_kernels.py`` names the library by a hash of every file under
``csrc/`` (sources and the headers they include) and compiles only the
``.cu`` sources, one ``nvcc`` each.  These tests point ``CSRC`` at a
temporary tree and stand in for ``nvcc``.
"""

from pathlib import Path

import pytest

from tpu_network_operator_torch.ops import _kernels


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
    calls.clear()
    assert _kernels.build() == target and not calls     # cached: no rebuild
