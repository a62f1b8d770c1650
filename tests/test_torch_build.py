"""The port's kernel build (ops/cuda/build.py) on a host without nvcc:
one library per csrc/*.cu source, keyed by that source, the headers and
the flags; every missing library compiled at once; a source that fails
to compile leaves the others built.  A stand-in for nvcc writes the
libraries."""

import pytest

from disinfect_slam_tpu_torch.ops.cuda import build


def test_every_kernel_source_has_a_library_of_its_own():
    names = build.sources()
    assert {"errors", "fuse_rows", "sample_rows", "splat_rows", "splat_probe"} <= set(names)
    assert len({build.library_path(n) for n in names}) == len(names)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ and an empty build directory, both under tmp_path."""
    copy = tmp_path / "csrc"
    copy.mkdir()
    for p in build.CSRC.iterdir():
        (copy / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return copy


def test_a_library_key_follows_its_source_and_every_header(csrc):
    before = {n: build.library_path(n) for n in build.sources()}
    (csrc / "fuse_rows.cu").write_text((csrc / "fuse_rows.cu").read_text() + "\n")
    after = {n: build.library_path(n) for n in build.sources()}
    assert [n for n in before if after[n] != before[n]] == ["fuse_rows"]
    header = csrc / "persistent_grid.cuh"
    header.write_text(header.read_text() + "\n")
    assert all(build.library_path(n) != after[n] for n in after)


def _fake_nvcc(tmp_path, fail: str) -> str:
    """An nvcc that writes an empty library to its -o path, or exits 2 on
    csrc/<fail>.cu."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f'for a in "$@"; do case "$a" in *{fail}.cu) echo "{fail}: error"; exit 2;; esac; done\n'
        'prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'echo "ptxas info : built $out"\n'
        ': > "$out"\n'
    )
    script.chmod(0o755)
    return str(script)


def test_build_compiles_every_missing_source_and_keeps_a_failure_to_itself(
        csrc, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(tmp_path, "splat_probe"))
    with pytest.raises(RuntimeError, match=r"splat_probe\.cu: nvcc exited with code 2"):
        build.build()
    built = {n: build.library_path(n).exists() for n in build.sources()}
    assert built == {n: n != "splat_probe" for n in built}
    assert not list(build.BUILD_DIR.glob("*.tmp"))
    # what exists is not compiled again
    good = [n for n in built if n != "splat_probe"]
    paths, log, seconds = build.build(good)
    assert (log, seconds) == ("", 0.0)
    assert paths == {n: build.library_path(n) for n in good}


def test_build_returns_every_compiler_log(csrc, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(tmp_path, "no_such_source"))
    paths, log, _ = build.build(["fuse_rows", "splat_rows"])
    assert all(p.exists() for p in paths.values())
    assert log.count("ptxas info : built") == 2
