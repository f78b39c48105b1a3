"""The port's TrOCR training (``vtd_tpu_torch.train.trocr_trainer``) and
the port's command line against ``vtd_tpu``'s, on the same numpy-seeded
inputs and the same weights (flax's init carried across by
``convert.trocr_from_jax``).

Tolerances: the schedule within 1e-7 of optax's at every step; tokens
equal; float32 steps: per-step loss within rtol 1e-5, parameters after 3
steps within lr * 1e-3 (plus 2 float32 ulps) where every step's gradient
is above 1e-6 and within 2 * lr elsewhere; bf16 compute with float32
weights against the reference's bf16 TrOCR: per-step loss within rtol
1e-3 (both cast float32 weights to bf16 at use and keep the attention
scores, softmax, LayerNorm and head in float32; the gap measured 8.7e-5).
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

LR = 1e-3
WD = 1e-4


def _small(dtype_name):
    """The same small config in both packages."""
    import jax.numpy as jnp

    from vtd_tpu.models.trocr import small_config as ref_small
    from vtd_tpu_torch.models.trocr import CharTokenizer, small_config

    kw = dict(image_size=32, patch_size=8, max_len=12,
              vocab_size=CharTokenizer().vocab_size)
    return (ref_small(dtype=getattr(jnp, dtype_name), **kw),
            small_config(dtype=getattr(torch, dtype_name), **kw))


def test_schedule_equals_optax():
    import optax

    from vtd_tpu_torch.train.trocr_trainer import warmup_cosine

    for peak, warmup, total in ((6e-4, 5, 40), (1e-3, 1, 10),
                                (3e-4, 0, 12), (2e-4, 100, 101)):
        sched = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
        for step in range(total + 5):
            want = float(sched(step))
            got = warmup_cosine(step, peak, warmup, total)
            assert abs(got - want) <= 1e-7, (peak, warmup, total, step)
        assert warmup == 0 or warmup_cosine(0, peak, warmup, total) == 0.0


def test_encode_tokens_equal():
    from vtd_tpu.models.trocr import CharTokenizer as RefTok
    from vtd_tpu.train.trocr_trainer import encode_tokens as ref_encode
    from vtd_tpu_torch.models.trocr import CharTokenizer
    from vtd_tpu_torch.train.trocr_trainer import encode_tokens

    texts = ["AB", "", "Hello, World!", "x" * 30, "été"]
    for max_len in (6, 16):
        got = encode_tokens(texts, CharTokenizer(), max_len)
        want = ref_encode(texts, RefTok(), max_len)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _ref_run(cfg, images, tokens, steps, total):
    """The reference's make_trocr_train_step over ``steps`` updates from
    flax's init -> (initial params, losses, gradients at each step, final
    params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from vtd_tpu.models.trocr import CharTokenizer, TrOCR
    from vtd_tpu.train.trocr_trainer import make_trocr_train_step

    model = TrOCR(cfg)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.image_size, cfg.width, 3)),
        jnp.zeros((1, 2), jnp.int32))["params"])
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, 1, total),
                     weight_decay=WD)
    step = make_trocr_train_step(model, tx, augment=False)

    def loss_fn(p):
        x = jnp.asarray(images).astype(jnp.float32) / 127.5 - 1.0
        tok = jnp.asarray(tokens)
        logits = model.apply({"params": p}, x, tok[:, :-1])
        mask = (tok[:, 1:] != CharTokenizer.PAD).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                             tok[:, 1:])
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    p = jax.tree_util.tree_map(jnp.array, params)
    opt_state = tx.init(p)
    losses, grads = [], []
    for _ in range(steps):
        grads.append(jax.device_get(jax.grad(loss_fn)(p)))
        p, opt_state, loss = step(p, opt_state, jnp.asarray(images),
                                  jnp.asarray(tokens), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return params, losses, grads, jax.device_get(p)


def _port_run(cfg, params, images, tokens, steps, total):
    from vtd_tpu_torch.convert import trocr_from_jax
    from vtd_tpu_torch.models.trocr import TrOCR
    from vtd_tpu_torch.train.trocr_trainer import (
        make_trocr_train_step,
        warmup_cosine,
    )

    model = TrOCR(cfg).float()  # float32 master weights, cfg.dtype compute
    model.load_state_dict(trocr_from_jax({"params": params}, cfg))
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WD)
    step = make_trocr_train_step(
        model, opt, schedule=lambda n: warmup_cosine(n, LR, 1, total))
    x, tok = torch.from_numpy(images), torch.from_numpy(tokens)
    return model, [float(step(x, tok)) for _ in range(steps)]


@pytest.fixture(scope="module")
def batch():
    from vtd_tpu_torch.models.trocr import CharTokenizer
    from vtd_tpu_torch.train.trocr_trainer import (
        pack_u8,
        encode_tokens,
        synthesize_trocr_crops,
    )

    _, cfg = _small("float32")
    images, texts = synthesize_trocr_crops(8, cfg, seed=3)
    return pack_u8(images), encode_tokens(texts, CharTokenizer(),
                                           cfg.max_len)


def test_three_float32_steps_match_reference(batch):
    """Warmup 1: the first update runs at lr 0.0 (moments only), the next
    two at the schedule's rates."""
    from vtd_tpu_torch.convert import trocr_from_jax

    ref_cfg, cfg = _small("float32")
    images, tokens = batch
    params, ref_losses, grads, final = _ref_run(ref_cfg, images, tokens, 3,
                                                total=10)
    model, losses = _port_run(cfg, params, images, tokens, 3, total=10)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)

    want = trocr_from_jax({"params": final}, cfg)
    gs = [trocr_from_jax({"params": g}, cfg) for g in grads]
    start = trocr_from_jax({"params": params}, cfg)
    moved = 0
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        live = np.all([np.abs(g[name].numpy()) > 1e-6 for g in gs], axis=0)
        ulp = np.spacing(np.abs(want[name].numpy()))
        assert (d[live] <= (LR * 1e-3 + 2 * ulp)[live]).all(), (
            name, d[live].max())
        assert (d <= 2 * LR).all(), (name, d.max())
        moved += int((np.abs(want[name].numpy() - start[name].numpy())
                      > LR / 2).sum())
    assert moved > 0  # the steps past the 0.0 of step 0 did move


def test_bf16_compute_matches_reference_bf16(batch):
    """bf16 compute with float32 master weights against the reference's
    bf16 TrOCR (float32 parameters cast at use): per-step loss within rtol
    1e-3 over 3 steps; the master weights stay float32."""
    ref_cfg, cfg = _small("bfloat16")
    images, tokens = batch
    params, ref_losses, _, _ = _ref_run(ref_cfg, images, tokens, 3, total=10)
    model, losses = _port_run(cfg, params, images, tokens, 3, total=10)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert losses[-1] < losses[0]


def test_trocr_train_and_reload(tmp_path):
    from vtd_tpu_torch.models.trocr import CharTokenizer, small_config
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer
    from vtd_tpu_torch.train.trocr_trainer import (
        TrOCRTrainer,
        synthesize_trocr_crops,
    )

    cfg = small_config(image_size=32, patch_size=8,
                       vocab_size=CharTokenizer().vocab_size, max_len=16)
    images, texts = synthesize_trocr_crops(64, cfg, seed=0)
    trainer = TrOCRTrainer(
        {
            "checkpoint_dir": str(tmp_path), "max_epochs": 2,
            "batch_size": 16, "learning_rate": 1e-3, "warmup_steps": 2,
            "save_every": 1,
        },
        model_config=cfg, device="cpu",
    )
    out = trainer.train(images, texts, images[:8], texts[:8])
    assert out["status"] == "success", out
    assert out["history"][-1]["train_loss"] < out["history"][0]["train_loss"]
    assert "val_exact_match" in out["history"][-1]
    assert out["best_model_path"].endswith("trocr_final.pt")
    assert (tmp_path / "trocr_final_config.json").exists()
    latest = (tmp_path / "autosave_latest.txt").read_text().splitlines()
    assert latest[0].endswith("trocr_autosave_a.pt") and latest[1] == "epoch=1"
    assert (tmp_path / "trocr_autosave_b.pt").exists()

    # the sidecar rebuilds the architecture without a config argument
    rec = TransformerRecognizer(model_path=out["best_model_path"],
                                pad_batch=4, device="cpu")
    assert rec.cfg == cfg
    crop = (np.random.default_rng(0).random((20, 60, 3)) * 255).astype(
        np.uint8)
    r = rec.recognize(crop)
    assert set(r) == {"text", "confidence"}

    # init_from: a later run starts from the saved weights
    again = TrOCRTrainer({"init_from": out["best_model_path"]},
                         model_config=cfg, device="cpu").build_model()
    sd = torch.load(out["best_model_path"], weights_only=True)
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_trocr_init_from_reference_checkpoint(tmp_path):
    """A JAX package checkpoint (``variables.pkl``) seeds the port's
    trainer through ``convert.trocr_from_jax``."""
    import pickle

    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.trocr import TrOCR as RefTrOCR
    from vtd_tpu_torch.convert import trocr_from_jax
    from vtd_tpu_torch.train.trocr_trainer import TrOCRTrainer

    ref_cfg, cfg = _small("float32")
    params = jax.device_get(RefTrOCR(ref_cfg).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 2), jnp.int32))["params"])
    ckpt = tmp_path / "ref_ckpt"
    ckpt.mkdir()
    with open(ckpt / "variables.pkl", "wb") as f:
        pickle.dump({"params": params}, f)
    model = TrOCRTrainer({"init_from": str(ckpt)}, model_config=cfg,
                         device="cpu").build_model()
    want = trocr_from_jax({"params": params}, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_train_detector(tmp_path, capsys):
    from vtd_tpu_torch.__main__ import main

    rc = main(["train-detector", "--synthetic", "--n-samples", "6",
               "--image-size", "64", "--epochs", "1", "--batch-size", "4",
               "--checkpoint-dir", str(tmp_path / "db"), "--device", "cpu"])
    res = _last_json(capsys.readouterr().out)
    assert rc == 0 and res["status"] == "success", res
    assert res["best_model_path"].endswith(".pt")
    with pytest.raises(NotImplementedError, match="item 7"):
        main(["train-detector", "--mesh", "2x1", "--device", "cpu"])


def test_cli_train_recognizer(tmp_path, capsys):
    from vtd_tpu_torch.__main__ import main

    rc = main(["train-recognizer", "--synthetic", "--n-samples", "20",
               "--epochs", "1", "--batch-size", "8", "--no-augment",
               "--checkpoint-dir", str(tmp_path / "crnn"), "--device", "cpu"])
    res = _last_json(capsys.readouterr().out)
    assert rc == 0 and res["status"] == "success", res
    assert res["best_model_path"].endswith("crnn_final.pt")


def test_cli_train_trocr(tmp_path, capsys):
    from vtd_tpu_torch.__main__ import main

    rc = main(["train-trocr", "--samples", "32", "--epochs", "1",
               "--batch-size", "16", "--image-size", "16", "--image-width",
               "32", "--enc-dim", "32", "--layers", "1", "--checkpoint-dir",
               str(tmp_path), "--device", "cpu"])
    res = _last_json(capsys.readouterr().out)
    assert rc == 0 and res["status"] == "success", res
    assert res["heldout_exact_match_random8"].endswith("/32")
    assert 0.0 <= res["heldout_char_accuracy_random8"] <= 1.0
    cfg = json.loads((tmp_path / "trocr_final_config.json").read_text())
    assert (cfg["enc_dim"], cfg["enc_layers"], cfg["image_width"],
            cfg["dtype"]) == (32, 1, 32, "float32")


@pytest.mark.parametrize("argv", [["serve"], ["worker"],
                                  ["process", "x.mp4", "--data-parallel", "2"],
                                  ["process", "x.mp4", "--two-stage"]])
def test_cli_not_ported_commands_exit_nonzero(argv, capsys):
    """Commands of later slices exit 2 naming their ROADMAP item; serve
    and worker are ported and exit 2 here because the host has no CUDA
    (brokerd: tests/test_torch_fleet.py)."""
    from vtd_tpu_torch.__main__ import main

    assert main(argv) == 2
    want = ("CUDA is not available" if argv[0] in ("serve", "worker")
            else "ROADMAP queue 1 item")
    assert want in capsys.readouterr().err
