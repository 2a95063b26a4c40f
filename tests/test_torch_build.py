"""The port's kernel build key (paddle_tpu_torch.ops._build): a library
is named by a hash of its source, of every local header the source
includes (followed through the headers' own includes) and of the nvcc
flags, so editing a shared header rebuilds every kernel that includes
it instead of loading a stale library. Nothing here runs nvcc."""
from paddle_tpu_torch.ops import _build


def _tree(tmp_path):
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                                   "int k;\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b, first version\n")
    (tmp_path / "other.cu").write_text("int other;\n")


def test_header_edits_change_the_library_name(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    k0, other0 = _build._target("k")[1], _build._target("other")[1]
    (tmp_path / "b.cuh").write_text("// b, second version\n")
    k1, other1 = _build._target("k")[1], _build._target("other")[1]
    assert k0 != k1 and k1.name.startswith("k-")
    assert other0 == other1          # no include, no change
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a\n')
    assert _build._target("k")[1] not in (k0, k1)


def test_sources_follow_local_includes_once(tmp_path):
    _tree(tmp_path)
    (tmp_path / "c.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n')
    names = [p.name for p in _build._sources(tmp_path / "c.cu")]
    assert names == ["c.cu", "a.cuh", "b.cuh"]
    names = [p.name for p in _build._sources(tmp_path / "k.cu")]
    assert names == ["k.cu", "a.cuh", "b.cuh"]      # <cuda.h> is not local


def test_the_flash_kernels_share_the_hopper_header():
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        names = [p.name for p in _build._sources(_build._CSRC / f"{name}.cu")]
        assert names == [f"{name}.cu", "hopper.cuh"]
    decode = _build._sources(_build._CSRC / "paged_decode.cu")
    assert [p.name for p in decode] == ["paged_decode.cu"]


class _DoneNvcc:
    """A finished nvcc process: exit 0 and its `-Xptxas -v` output."""
    returncode = 0

    def __init__(self, out):
        self.out = out

    def communicate(self):
        return self.out, None


_PTXAS = """ptxas info    : Compiling entry function '_Z4kernPi' for 'sm_90a'
ptxas info    : Function properties for _Z4kernPi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 1024 bytes smem, 368 bytes cmem[0]
"""


def test_ptxas_report_is_kept_beside_the_library(tmp_path, monkeypatch):
    """A finished build leaves its ptxas report beside the library, so a
    later process that loads the library as it is still reads the
    registers and spills (the smoke fails on a spill either way)."""
    _tree(tmp_path)
    out_dir = tmp_path / "build"
    out_dir.mkdir()
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    monkeypatch.setattr(_build, "build_dir", lambda: out_dir)
    assert _build.ptxas_info("k") == {}            # not built yet
    so = _build._target("k")[1]
    tmp = out_dir / "k-partial.so"
    tmp.write_bytes(b"library")
    _build._finish("k", _DoneNvcc(_PTXAS), str(tmp), so)
    assert so.read_bytes() == b"library" and not tmp.exists()
    want = {"_Z4kernPi": {"spills": (4, 4), "registers": 40, "smem": 1024}}
    assert _build.ptxas_info("k") == want
    # a process that finds the library built reads the same report
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build._start("k") == (None, None, so)
    assert _build.ptxas_info("k") == want


def test_a_library_without_its_report_is_rebuilt(tmp_path, monkeypatch):
    """A library left by a build that kept no report is built again, so
    its ptxas report can always be read."""
    _tree(tmp_path)
    out_dir = tmp_path / "build"
    out_dir.mkdir()
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    monkeypatch.setattr(_build, "build_dir", lambda: out_dir)
    so = _build._target("k")[1]
    so.write_bytes(b"library")
    started = []

    def popen(cmd, **kw):
        started.append(cmd)
        return _DoneNvcc(_PTXAS)

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    proc, tmp, got = _build._start("k")
    assert got == so and proc is not None and len(started) == 1
    assert started[0][-1] == str(tmp_path / "k.cu")
    _build._finish("k", proc, tmp, so)
    assert _build.ptxas_info("k")["_Z4kernPi"]["registers"] == 40
