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
