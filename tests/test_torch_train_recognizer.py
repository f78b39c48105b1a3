"""The port's CRNN training (``vtd_tpu_torch.train.recognizer_trainer``)
against ``vtd_tpu.train.recognizer_trainer`` on the same numpy-seeded
inputs and the same weights (flax's init carried across by
``convert.crnn_from_jax``), float32 on both sides.

Tolerances: synthetic crops byte-equal and labels equal; the CTC loss
within rtol 1e-5 of the mean of ``optax.ctc_loss``; a train step's loss
within rtol 1e-5, each gradient tensor of the LSTM and classifier with
|g_port - g_ref| <= 1e-4 |g_ref| + 1e-7; the conv stack's gradients and
the new running statistics within the same bounds (1e-5 for statistics)
plus 10x the float32 rounding the port's own step carries there (its
float32 against its float64 step on the same weights; the gap to the
reference measured 1.0-2.4x it).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def test_synthetic_text_lines_byte_equal():
    from vtd_tpu.train.recognizer_trainer import (
        synthesize_text_lines as ref_synth,
    )
    from vtd_tpu_torch.train.recognizer_trainer import synthesize_text_lines

    for kw in ({"seed": 3}, {"seed": 4, "height": 48, "width": 192,
                             "length_range": (8, 9)}):
        want_img, want_txt = ref_synth(12, **kw)
        got_img, got_txt = synthesize_text_lines(12, **kw)
        assert got_txt == want_txt
        assert got_img.dtype == want_img.dtype
        assert got_img.tobytes() == want_img.tobytes()


def test_encode_labels_equal():
    from vtd_tpu.train.recognizer_trainer import encode_labels as ref_encode
    from vtd_tpu_torch.train.recognizer_trainer import encode_labels

    texts = ["ab", "", "Hello, World!", "x" * 20, "été"]
    for got, want in zip(encode_labels(texts), ref_encode(texts)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_ctc_loss_is_the_mean_of_sequence_nlls():
    """Labels of lengths 1..8: a mean of per-target-length averages
    (``F.ctc_loss(reduction="mean")``) would miss by a factor of ~3."""
    import jax.numpy as jnp
    import optax

    from vtd_tpu_torch.train.recognizer_trainer import ctc_loss

    rng = np.random.default_rng(0)
    logits = rng.normal(0.0, 2.0, (4, 31, 97)).astype(np.float32)
    labels = np.zeros((4, 15), np.int32)
    pads = np.ones((4, 15), np.float32)
    for i, n in enumerate((1, 3, 5, 8)):
        labels[i, :n] = rng.integers(1, 97, n)
        pads[i, :n] = 0.0
    want = float(jnp.mean(optax.ctc_loss(
        jnp.asarray(logits), jnp.zeros((4, 31)), jnp.asarray(labels),
        jnp.asarray(pads), blank_id=0)))
    got = float(ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.from_numpy(pads)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def ref_step():
    """The reference CRNN (flax init), a batch of 8 synthetic crops with
    their labels, and the loss, gradients and new statistics of its
    train step (value_and_grad over its own apply and CTC mean)."""
    import jax
    import jax.numpy as jnp
    import optax

    from vtd_tpu.models.crnn import CRNN
    from vtd_tpu.train.recognizer_trainer import (
        encode_labels,
        synthesize_text_lines,
    )

    model = CRNN(dtype=jnp.float32)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 3), jnp.float32)))
    images, texts = synthesize_text_lines(8, seed=2)
    labels, pads = encode_labels(texts)

    def loss_fn(p):
        logits, mutated = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        b, t, _ = logits.shape
        loss = jnp.mean(optax.ctc_loss(
            logits, jnp.zeros((b, t)), jnp.asarray(labels),
            jnp.asarray(pads), blank_id=0))
        return loss, mutated["batch_stats"]

    (loss, new_stats), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return {"variables": variables, "images": images, "labels": labels,
            "pads": pads, "loss": float(loss),
            "grads": jax.device_get(grads),
            "new_stats": jax.device_get(new_stats)}


def _port_step(ref, dtype):
    """One port CRNN step from the reference's weights (lr 0: the step's
    gradients and statistics, parameters unmoved)."""
    from vtd_tpu_torch.convert import crnn_from_jax
    from vtd_tpu_torch.models.crnn import CRNN
    from vtd_tpu_torch.train.recognizer_trainer import make_crnn_train_step

    model = CRNN(dtype=torch.float32)
    model.load_state_dict(crnn_from_jax(ref["variables"]))
    model = model.to(dtype)
    opt = torch.optim.AdamW(model.parameters(), lr=0.0)
    loss = make_crnn_train_step(model, opt, augment=False)(
        torch.from_numpy(ref["images"]).to(dtype),
        torch.from_numpy(ref["labels"]), torch.from_numpy(ref["pads"]))
    return model, loss


def test_crnn_train_step_matches_reference(ref_step):
    """Loss within rtol 1e-5. Gradients: the LSTM and classifier within
    1e-4 |g| + 1e-7; the conv stack's gradients carry ~0.5% of float32
    rounding at flax's init (the port's float32 step against its float64
    step on the same weights; the last train-mode BatchNorm's backward
    cancels ~2.5 digits), so every tensor is held to the stated bound
    plus 10x that measured gap, as the whole DBNet is."""
    from vtd_tpu_torch.convert import crnn_from_jax

    ref = ref_step
    model, loss = _port_step(ref, torch.float32)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    model64, _ = _port_step(ref, torch.float64)

    want = crnn_from_jax({"params": ref["grads"],
                          "batch_stats": ref["new_stats"]})
    g64 = dict(model64.named_parameters())
    n = 0
    for name, p in model.named_parameters():
        g, w = p.grad.double().numpy(), want[name].numpy()
        noise = np.linalg.norm(g - g64[name].grad.numpy())
        err = np.linalg.norm(g - w)
        assert err <= 1e-4 * np.linalg.norm(w) + 1e-7 + 10 * noise, (
            name, err, noise)
        if name.startswith(("rnn.", "classifier.")):
            assert err <= 1e-4 * np.linalg.norm(w) + 1e-7, (name, err)
        n += 1
    assert n == len(list(model.parameters()))
    s64 = dict(model64.named_buffers())
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            s, w = buf.double().numpy(), want[name].numpy()
            err = np.linalg.norm(s - w)
            assert err <= 1e-5 * (np.linalg.norm(w) + np.sqrt(w.size)) + 10 * (
                np.linalg.norm(s - s64[name].numpy())), name


def test_crnn_augmentation_draws_from_the_generator():
    """augment=True jitters the crops from the caller's generator: the
    same seed gives the same step, and the crops stay in [0, 1]."""
    from vtd_tpu_torch.core.device import seeded_init_
    from vtd_tpu_torch.models.crnn import CRNN
    from vtd_tpu_torch.train.recognizer_trainer import (
        encode_labels,
        make_crnn_train_step,
        photometric_jitter,
    )

    x = torch.rand(4, 32, 128, 3)
    jit = photometric_jitter(x, torch.Generator().manual_seed(1), 0.2, 0.12,
                             0.03).clamp(0, 1)
    assert not torch.equal(jit, x) and 0 <= float(jit.min()) <= float(
        jit.max()) <= 1
    labels, pads = (torch.from_numpy(a) for a in encode_labels(["ab"] * 4))
    losses = []
    for _ in range(2):
        model = seeded_init_(CRNN(), 0)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        step = make_crnn_train_step(model, opt, augment=True,
                                    generator=torch.Generator().manual_seed(5))
        losses.append([float(step(x, labels, pads)) for _ in range(2)])
    assert losses[0] == losses[1]
    with pytest.raises(ValueError):
        make_crnn_train_step(model, opt, augment=True)


def test_recognizer_trainer_loss_decreases_and_reloads(tmp_path):
    from vtd_tpu_torch.runtime.recognizer import TextRecognizer
    from vtd_tpu_torch.train.recognizer_trainer import (
        RecognizerTrainer,
        synthesize_text_lines,
    )

    images, texts = synthesize_text_lines(64, seed=1)
    trainer = RecognizerTrainer(
        {
            "checkpoint_dir": str(tmp_path),
            "max_epochs": 3,
            "batch_size": 16,
            "learning_rate": 1e-3,
        },
        device="cpu",
    )
    result = trainer.train(images, texts, images[:16], texts[:16])
    assert result["status"] == "success", result
    h = result["history"]
    assert h[-1]["train_loss"] < h[0]["train_loss"]
    assert "val_exact_match" in h[-1] and "val_char_accuracy" in h[-1]
    assert result["epochs_trained"] == 3
    assert result["best_model_path"].endswith("crnn_final.pt")

    rec = TextRecognizer(model_path=result["best_model_path"],
                         use_transformer=False, pad_batch=8, device="cpu")
    out = rec.recognize_batch([np.full((40, 160, 3), 255, np.uint8)])
    assert isinstance(out[0]["text"], str)
    # the runtime reads the trained weights as saved
    sd = torch.load(result["best_model_path"], weights_only=True)
    for k, v in rec.crnn.state_dict().items():
        assert torch.equal(v.float(), sd[k].float()), k


def test_recognizer_trainer_failure_dict(tmp_path):
    from vtd_tpu_torch.train.recognizer_trainer import RecognizerTrainer

    trainer = RecognizerTrainer(
        {"checkpoint_dir": str(tmp_path), "max_epochs": 1, "batch_size": 4},
        device="cpu",
    )
    bad = np.zeros((4, 31, 128, 3), np.float32)  # H=31: no 1-row feature map
    result = trainer.train(bad, ["ab"] * 4)
    assert result["status"] == "failed" and "error" in result
