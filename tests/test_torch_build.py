"""splice_tpu_torch.ops._build names each library by a hash of its source,
the headers the source includes and the flags, so that an edited header
builds a new library instead of loading a stale one. CPU only: nothing is
compiled here."""
import pytest

from splice_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary CSRC_DIR: lib.cu includes a.cuh, which includes
    b.cuh."""
    (tmp_path / "lib.cu").write_text(
        '#include <stdint.h>\n#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\ninline int g();\n')
    (tmp_path / "b.cuh").write_text("inline int h() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited", ["lib.cu", "a.cuh", "b.cuh"])
def test_digest_follows_every_included_file(csrc, edited):
    before = _build._target("lib")
    assert before == _build._target("lib")          # deterministic
    (csrc / edited).write_text((csrc / edited).read_text() + "// edit\n")
    assert _build._target("lib") != before


def test_sources_lists_each_quoted_include_once(csrc):
    (csrc / "b.cuh").write_text('#include "a.cuh"\n')   # a cycle
    names = [p.name for p in _build._sources(csrc / "lib.cu")]
    assert names == ["lib.cu", "a.cuh", "b.cuh"]


def test_the_conv_and_attention_sources_include_the_split_header():
    """Both libraries hash csrc/tf32.cuh, the split-TF32 helpers they
    share."""
    for name in ("attention", "conv"):
        names = [p.name for p in _build._sources(
            _build.CSRC_DIR / f"{name}.cu")]
        assert names == [f"{name}.cu", "tf32.cuh"]
