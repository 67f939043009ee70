"""The port's kernel build (`horovod_tpu_torch.ops._build`) on the CPU:
a library's file name follows its source, the shared headers beside it
and the compiler flags, so an edited header never loads a stale build.
Nothing here needs `nvcc`."""

import pathlib
import shutil

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    """A copy of the kernel sources, free to edit."""
    return pathlib.Path(shutil.copytree(_build.CSRC, tmp_path / "csrc"))


def test_every_source_has_a_distinct_target(csrc):
    names = [_build._target(src).name for src in sorted(csrc.glob("*.cu"))]
    assert len(names) == len(set(names)) >= 5
    assert all(n.startswith("lib") and n.endswith(".so") for n in names)
    # The copy names the same libraries as the package's own sources.
    assert names == [_build._target(src).name
                     for src in sorted(_build.CSRC.glob("*.cu"))]


@pytest.mark.parametrize("stem", ["flash_bwd_dq", "flash_bwd_dkv",
                                  "flash_fwd"])
def test_editing_a_shared_header_renames_every_library(csrc, stem):
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    src = csrc / f"{stem}.cu"
    before = _build._target(src)
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = _build._target(src)
    assert after != before and after.parent == _build.BUILD_DIR


def test_a_new_header_and_a_source_edit_rename(csrc):
    src = csrc / "flash_bwd_dq.cu"
    t0 = _build._target(src)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    t1 = _build._target(src)
    src.write_text(src.read_text() + "\n")
    t2 = _build._target(src)
    assert len({t0, t1, t2}) == 3
    # An edit of another source leaves this library's name alone.
    other = csrc / "flash_fwd.cu"
    other.write_text(other.read_text() + "\n")
    assert _build._target(src) == t2
