"""The port's CRNN and CTC decode against the committed golden, the
trained demo checkpoint and ``vtd_tpu``'s own functions.

Tolerances: the golden's atol 2e-3 / rtol 1e-3 (those of
tests/test_import_goldens.py); trained-checkpoint logits within 1e-4
with equal greedy ids, float32 on both sides.
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vocab_matches_reference():
    from vtd_tpu.models.crnn import BLANK_ID, CRNN_VOCAB, UNK_ID
    from vtd_tpu_torch.models import crnn

    assert crnn.CRNN_VOCAB == CRNN_VOCAB
    assert (crnn.BLANK_ID, crnn.UNK_ID) == (BLANK_ID, UNK_ID) == (0, 96)


def test_crnn_golden():
    from vtd_tpu_torch.models.crnn import CRNN

    z = np.load(os.path.join(REPO, "tests", "goldens", "crnn_golden.npz"))
    sd = {
        k[len("sd:"):]: torch.from_numpy(np.asarray(z[k]).astype(
            np.float32 if z[k].dtype == np.float16 else z[k].dtype
        ))
        for k in z.files if k.startswith("sd:")
    }
    model = CRNN().eval()
    model.load_state_dict(sd)  # the reference torch layout loads as is
    with torch.no_grad():
        ours = model(torch.from_numpy(z["x"]).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == z["ref"].shape == (2, 31, 97)
    np.testing.assert_allclose(ours, z["ref"], atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def trained():
    from vtd_tpu.train.checkpoint import restore_variables

    return restore_variables(
        os.path.join(REPO, "demo_models2", "crnn", "crnn_final")
    )


def test_trained_crnn_matches_reference(trained):
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.crnn import CRNN as RefCRNN
    from vtd_tpu.ops.ctc import ctc_greedy_decode_arrays as ref_decode
    from vtd_tpu_torch.convert import crnn_from_jax
    from vtd_tpu_torch.models.crnn import CRNN
    from vtd_tpu_torch.ops.ctc import ctc_greedy_decode_arrays

    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 128, 3)).astype(np.float32)
    x[:2, 10:22, 8:120] *= 0.2  # dark strokes on two of the crops
    ref = RefCRNN(dtype=jnp.float32)
    want = np.asarray(jax.jit(ref.apply)(trained, jnp.asarray(x)))
    want_ids = np.asarray(ref_decode(jnp.asarray(want))["ids"])

    model = CRNN().eval()
    model.load_state_dict(crnn_from_jax(trained))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_array_equal(
        ctc_greedy_decode_arrays(got)["ids"].numpy(), want_ids
    )


def test_ctc_greedy_decode_matches_reference():
    import jax.numpy as jnp

    from vtd_tpu.ops.ctc import ctc_greedy_decode_arrays as ref_decode
    from vtd_tpu.ops.ctc import emit_mask_np as ref_emit
    from vtd_tpu.ops.ctc import ids_to_text as ref_text
    from vtd_tpu_torch.ops.ctc import (
        ctc_greedy_decode_arrays, emit_mask_np, ids_to_text,
    )

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 31, 97)).astype(np.float32) * 3
    logits[0, :, 0] = 50.0  # all blank
    logits[1, 5:9, 40] = 60.0  # a repeat that collapses
    logits[1, 3, 96] = 60.0  # <unk> is skipped
    logits[2, 4, 11] = logits[2, 4, 12] = 70.0  # tie: first maximum wins
    want = {k: np.asarray(v) for k, v in ref_decode(jnp.asarray(logits)).items()}
    got = {k: v.numpy() for k, v in
           ctc_greedy_decode_arrays(torch.from_numpy(logits)).items()}
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["emit"], want["emit"])
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6)
    np.testing.assert_allclose(got["confidence"], want["confidence"], atol=1e-6)
    np.testing.assert_array_equal(emit_mask_np(got["ids"]), ref_emit(want["ids"]))
    assert ids_to_text(got["ids"], got["emit"]) == ref_text(
        want["ids"], want["emit"]
    )


def test_recognizer_rejects_later_slices():
    from vtd_tpu_torch.runtime import TextRecognizer

    # the beam decoder is ported (tests/test_torch_beam.py); an unknown
    # decoder still raises
    rec = TextRecognizer(use_transformer=False, decoder="beam", beam_width=4,
                         device="cpu")
    assert (rec.decoder, rec.beam_width) == ("beam", 4)
    with pytest.raises(ValueError, match="decoder"):
        TextRecognizer(use_transformer=False, decoder="viterbi", device="cpu")
    # the transformer engine is ported: the facade builds it
    from vtd_tpu_torch.models.trocr import small_config

    rec = TextRecognizer(
        use_transformer=True, transformer_config=small_config(), device="cpu"
    )
    assert rec.use_transformer and rec.transformer is not None


def test_recognizer_facade_on_ragged_crops():
    from vtd_tpu_torch.runtime import TextRecognizer

    rng = np.random.default_rng(0)
    rec = TextRecognizer(use_transformer=False, device="cpu")
    crops = [
        rng.integers(0, 255, (40, 200, 3), np.uint8),
        rng.integers(0, 255, (20, 80), np.uint8),
    ]
    out = rec.recognize_batch(crops)
    assert len(out) == 2
    for r in out:
        assert set(r) == {"text", "confidence"}
        assert isinstance(r["text"], str)
    assert rec.recognize(crops[0])["text"] == out[0]["text"]
