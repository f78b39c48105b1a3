"""``build(force=True)`` of the port's two native libraries, as the
reference's ``vtd_tpu/native/__init__.py:build`` and
``vtd_tpu/native/video.py:build`` take it: a forced build compiles again
into the same target, a library already loaded stays loaded, and a forced
build that cannot run raises (the port never falls back).

Each case builds into its own temporary directory, so the libraries other
tests load are never replaced under them.
"""
import numpy as np
import pytest


def _stamp(path):
    st = path.stat()
    return st.st_mtime_ns, st.st_ino


def test_forced_ctc_beam_build_rebuilds_and_decodes(monkeypatch, tmp_path):
    from vtd_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    first = native.build()
    assert first.parent == tmp_path and native.build() == first
    before = _stamp(first)
    loaded = native._get_lib()
    assert native.build(force=True) == first
    after = _stamp(first)
    assert after[0] > before[0] and after[1] != before[1]
    assert native._get_lib() is loaded  # a loaded library stays loaded
    assert [p.name for p in tmp_path.iterdir()] == [first.name]

    monkeypatch.setattr(native, "_lib", None)  # load the rebuilt library
    rng = np.random.default_rng(16)
    logits = rng.normal(0.0, 3.0, (6, 20, 12)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    seqs, scores = native.ctc_beam_decode(lp, beam_width=8)
    pseqs, pscores = native.ctc_beam_decode_plain(lp, beam_width=8)
    assert seqs == pseqs
    np.testing.assert_allclose(scores, pscores, atol=1e-4)


def test_forced_ctc_beam_build_raises_on_failure(monkeypatch, tmp_path):
    from vtd_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    target = native._target()
    target.write_bytes(b"an earlier build")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "_target", lambda: target)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(force=True)
    assert target.read_bytes() == b"an earlier build"
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [target.name, bad.name])  # no temporary file left behind


def test_forced_video_build_rebuilds(monkeypatch, tmp_path):
    from vtd_tpu_torch.native import video

    missing = video.libav_missing()
    if missing:
        pytest.skip(f"needs libav's development files: {missing}")
    monkeypatch.setattr(video, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(video, "_lib", None)
    first = video.build()
    before = _stamp(first)
    assert video.build(force=True) == first
    after = _stamp(first)
    assert after[0] > before[0] and after[1] != before[1]
    assert video._get_lib().vtd_vd_open is not None


def test_forced_video_build_without_libav_raises(monkeypatch, tmp_path):
    """Where libav is absent (the card's machine) a forced build raises
    naming what is missing, even over an existing target."""
    from vtd_tpu_torch.native import video

    monkeypatch.setattr(video, "BUILD_DIR", tmp_path)
    target = video._target()
    target.write_bytes(b"an earlier build")
    monkeypatch.setattr(
        video, "libav_missing",
        lambda: "libav development headers not found by g++ -E: "
                "libavcodec/avcodec.h")
    assert video.build() == target
    with pytest.raises(RuntimeError, match="libavcodec/avcodec.h"):
        video.build(force=True)
    assert target.read_bytes() == b"an earlier build"
