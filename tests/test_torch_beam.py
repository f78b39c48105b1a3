"""The port's native CTC prefix beam (``vtd_tpu_torch/native``) against its
plain Python version and against ``vtd_tpu.native``, and the recogniser's
``decoder="beam"`` against ``vtd_tpu``'s recogniser.

Tolerances: sequences equal; scores within 1e-5 (the C++ sums in float32,
the plain version in float64); on the trained CRNN transcripts equal and
confidences within 1e-4, float32 on both sides.
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERIFY = os.path.join(REPO, "tests", "torch_data", "verify_frames.npz")


def _log_softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(
        np.float32)


def _log_probs(seed, b, t, v, scale):
    rng = np.random.default_rng(seed)
    return _log_softmax(rng.normal(size=(b, t, v)) * scale)


CASES = [(0, 4, 12, 20, 2.0, 6), (1, 16, 31, 97, 1.0, 8),
         (2, 8, 32, 97, 3.0, 8), (3, 6, 20, 97, 5.0, 4), (4, 3, 5, 6, 1.0, 1)]


@pytest.mark.parametrize("seed,b,t,v,scale,width", CASES)
def test_cpp_beam_equals_plain_version(seed, b, t, v, scale, width):
    from vtd_tpu_torch.native import ctc_beam_decode, ctc_beam_decode_plain

    lp = _log_probs(seed, b, t, v, scale)
    seqs, scores = ctc_beam_decode(lp, beam_width=width)
    want_seqs, want_scores = ctc_beam_decode_plain(lp, beam_width=width)
    assert seqs == want_seqs
    np.testing.assert_allclose(scores, want_scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,b,t,v,scale,width", CASES)
def test_beam_equals_reference(seed, b, t, v, scale, width):
    from vtd_tpu import native as ref
    from vtd_tpu_torch.native import ctc_beam_decode, ctc_beam_decode_plain

    lp = _log_probs(seed, b, t, v, scale)
    seqs, scores = ctc_beam_decode(lp, beam_width=width)
    ref_seqs, ref_scores = ref.ctc_beam_decode(lp, beam_width=width)
    assert seqs == ref_seqs
    np.testing.assert_allclose(scores, ref_scores, atol=1e-5, rtol=0)
    plain = ctc_beam_decode_plain(lp, beam_width=width)
    py = ref._py_beam_batch(lp, width, 0, 64)
    assert plain[0] == py[0]
    np.testing.assert_array_equal(plain[1], py[1])


def test_beam_threads_and_max_len():
    from vtd_tpu_torch.native import ctc_beam_decode

    lp = _log_probs(5, 16, 31, 97, 2.0)
    one = ctc_beam_decode(lp, beam_width=8, n_threads=1)
    four = ctc_beam_decode(lp, beam_width=8, n_threads=4)
    assert one[0] == four[0]
    np.testing.assert_array_equal(one[1], four[1])
    short = ctc_beam_decode(lp, beam_width=8, max_len=3)[0]
    assert short == [s[:3] for s in one[0]]


def test_beam_recovers_obvious_sequence():
    from vtd_tpu_torch.native import ctc_beam_decode

    lp = np.full((1, 6, 10), -10.0, np.float32)
    for t, s in enumerate([5, 5, 0, 7, 0, 0]):
        lp[0, t, s] = 0.0
    seqs, scores = ctc_beam_decode(lp, beam_width=4)
    assert seqs[0] == [5, 7] and scores[0] > -1.0


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: without g++ the decoder raises."""
    from vtd_tpu_torch import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.ctc_beam_decode(np.zeros((1, 2, 3), np.float32))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native.shutil, "which", lambda name: "g++")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def _crops():
    """The shipped frame's three words and two noise crops, normalised to
    [N, 32, 128, 3] in [0, 1] as the recogniser takes them."""
    import cv2

    frame = np.load(VERIFY)["frame_bgr"]
    boxes = [(78, 105, 267, 161), (78, 265, 281, 321), (77, 425, 194, 482)]
    crops = [frame[y1:y2, x1:x2] for x1, y1, x2, y2 in boxes]
    rng = np.random.default_rng(0)
    crops += [rng.integers(0, 256, (30, 90, 3), np.uint8) for _ in range(2)]
    return np.stack([
        cv2.resize(c, (128, 32)).astype(np.float32) / 255.0 for c in crops
    ])


def test_recognizer_beam_matches_reference():
    import jax.numpy as jnp

    from vtd_tpu.models.crnn import CRNN as RefCRNN
    from vtd_tpu.runtime.recognizer import TextRecognizer as RefRecognizer
    from vtd_tpu_torch.runtime import TextRecognizer

    path = os.path.join(REPO, "models", "text_recognizer")
    kw = dict(use_transformer=False, pad_batch=16, decoder="beam",
              beam_width=6)
    ref = RefRecognizer(path, **kw)
    ref.crnn = RefCRNN(dtype=jnp.float32)  # float32, as the port on the CPU
    crops = _crops()
    want_texts, want_conf = ref.recognize_crops_device(jnp.asarray(crops))
    rec = TextRecognizer(path, device="cpu", **kw)
    assert (rec.pad_batch, rec.beam_width, rec.decoder) == (16, 6, "beam")
    texts, conf = rec.recognize_crops_device(torch.from_numpy(crops))
    assert texts == list(want_texts)
    assert texts[:3] == ["HELLO", "WORLD", "123"]
    np.testing.assert_allclose(conf, want_conf, atol=1e-4)
    empty = rec.recognize_crops_device(torch.zeros((0, 32, 128, 3)))
    assert empty[0] == [] and empty[1].shape == (0,)


def test_pipeline_takes_reference_recognizer_kwargs():
    """A reference ``recognizer_kwargs`` builds the port's pipeline; the
    pipeline's own CRNN path decodes greedily on the device, as the
    reference's does."""
    from vtd_tpu_torch.runtime import VideoTextPipeline

    pipe = VideoTextPipeline(
        device="cpu", use_transformer_ocr=False, detector_input_size=160,
        batch_size=2,
        recognizer_kwargs={"pad_batch": 32, "beam_width": 4,
                           "decoder": "beam"},
    )
    rec = pipe.recognizer
    assert (rec.pad_batch, rec.beam_width, rec.decoder) == (32, 4, "beam")
    frames = np.zeros((2, 64, 64, 3), np.uint8)
    assert pipe.process_batch(frames, np.ones(2, bool)) == [[], []]
