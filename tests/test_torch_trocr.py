"""The port's TrOCR model, converter and recogniser runtime against
``vtd_tpu``.

The same weights (drawn with numpy on top of ``model.init``, carried
across by ``vtd_tpu_torch.convert.trocr_from_jax``) and the same
numpy-seeded inputs go through both packages in float32: teacher-forced
logits within 1e-4 (float32 sums taken in another order), greedy tokens
equal, confidences within 1e-4. The HF-layout golden
(``tests/goldens/trocr_golden.npz``) loads through ``trocr_from_hf_state``
without JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "trocr_golden.npz")


def _configs(kind):
    """(reference config, port config) of one small architecture."""
    import jax.numpy as jnp

    from vtd_tpu.models import trocr as ref
    from vtd_tpu_torch.models import trocr as port

    if kind == "pre_ln":
        return ref.small_config(), port.small_config()
    if kind == "rect":
        kw = dict(image_size=32, image_width=96, patch_size=16)
        return ref.small_config(**kw), port.small_config(**kw)
    kw = dict(
        vocab_size=61, image_size=32, patch_size=16, enc_dim=32, enc_layers=2,
        enc_heads=4, enc_mlp=64, dec_dim=48, dec_layers=2, dec_heads=4,
        dec_mlp=64, max_len=10, scale_embedding=(kind == "hf_scaled"),
    )
    return (ref.hf_config(dtype=jnp.float32, **kw),
            port.hf_config(dtype=torch.float32, **kw))


def _pair(kind, seed=0):
    """Reference model + variables and the port's model holding the same
    weights; every leaf is perturbed so biases and LayerNorms count."""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.trocr import TrOCR as RefTrOCR
    from vtd_tpu_torch.convert import trocr_from_jax
    from vtd_tpu_torch.models.trocr import TrOCR

    rcfg, pcfg = _configs(kind)
    ref = RefTrOCR(rcfg)
    variables = ref.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, rcfg.image_size, rcfg.width, 3), jnp.float32),
        jnp.zeros((1, 2), jnp.int32),
    )
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables,
    )
    port = TrOCR(pcfg).eval()
    port.load_state_dict(trocr_from_jax(variables, pcfg))
    return ref, variables, port, pcfg


def _inputs(cfg, seed, b=3, t=7):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (b, cfg.image_size, cfg.width, 3)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return images, tokens


KINDS = ["pre_ln", "rect", "hf", "hf_scaled"]


@pytest.mark.parametrize("kind", KINDS)
def test_teacher_forced_logits_match_reference(kind):
    ref, variables, port, cfg = _pair(kind)
    images, tokens = _inputs(cfg, 1)
    want = np.asarray(ref.apply(variables, images, tokens))
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (3, 7, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_encoder_states_match_reference(kind):
    from vtd_tpu.models.trocr import TrOCR as RefTrOCR

    ref, variables, port, cfg = _pair(kind)
    images, _ = _inputs(cfg, 2)
    want = np.asarray(ref.apply(variables, images, method=RefTrOCR.encode))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(images))
    assert got.shape == (3, cfg.num_patches, cfg.enc_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_greedy_generate_matches_reference(kind):
    from vtd_tpu.models.trocr import greedy_generate as ref_generate
    from vtd_tpu_torch.models.trocr import greedy_generate

    ref, variables, port, cfg = _pair(kind, seed=4)
    images, _ = _inputs(cfg, 3, b=5)
    want_t, want_c = ref_generate(ref, variables, images, bos_id=1, eos_id=2)
    got_t, got_c = greedy_generate(
        port, torch.from_numpy(images), bos_id=1, eos_id=2
    )
    assert got_t.dtype == torch.int32
    assert got_t.shape == (5, cfg.max_len) and got_c.shape == (5,)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-4)


def test_greedy_generate_stops_rows_at_eos():
    """A head biased to <eos>: every row ends at step 0, emits <pad>
    after, and its confidence is that one step's probability."""
    from vtd_tpu.models.trocr import greedy_generate as ref_generate
    from vtd_tpu_torch.convert import trocr_from_jax
    from vtd_tpu_torch.models.trocr import greedy_generate

    ref, variables, port, cfg = _pair("pre_ln")
    bias = np.array(variables["params"]["decoder"]["lm_head"]["bias"])
    bias[2] += 50.0
    variables["params"]["decoder"]["lm_head"]["bias"] = bias
    port.load_state_dict(trocr_from_jax(variables, cfg))
    images, _ = _inputs(cfg, 5, b=2)
    want_t, want_c = ref_generate(ref, variables, images)
    got_t, got_c = greedy_generate(port, torch.from_numpy(images))
    assert got_t[:, 0].tolist() == [2, 2] and not got_t[:, 1:].any()
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_static_step_matches_greedy_decode(kind):
    """``DecodeState.rows`` views of one state sized 5, the buffers the
    card's graphs replay over: chunks of 5, 1, 3 and 5 rows in turn, each
    after the first reusing buffers another chunk left behind, stepped
    with ``greedy_step_``. The head's <eos> column is scaled so that some
    rows end early and others run to ``max_len``. Tokens and confidences
    equal to ``greedy_decode`` on a state of the chunk's own rows; tokens
    equal to the reference's, confidences within 1e-4."""
    from vtd_tpu.models.trocr import greedy_generate as ref_generate
    from vtd_tpu_torch.convert import trocr_from_jax
    from vtd_tpu_torch.models.trocr import (
        DecodeState, greedy_decode, greedy_step_)

    ref, variables, port, cfg = _pair(kind, seed=4)
    head = variables["params"]["decoder"]["lm_head"]
    kernel = np.array(head["kernel"])
    kernel[:, 2] *= 4.0
    head["kernel"] = kernel
    port.load_state_dict(trocr_from_jax(variables, cfg))
    images, _ = _inputs(cfg, 3, b=5)
    want_t, want_c = (np.asarray(a) for a in ref_generate(
        ref, variables, images, bos_id=1, eos_id=2))
    ended = (want_t == 2).any(axis=1)
    assert ended.any() and not ended.all()
    state = DecodeState(cfg, 5)
    x = torch.from_numpy(images)
    for rows in ([0, 1, 2, 3, 4], [3], [4, 0, 2], [4, 3, 2, 1, 0]):
        with torch.inference_mode():
            enc_kvs = port.encode_kv(x[rows])
            own_t, own_c = greedy_decode(port, enc_kvs)
            view = state.rows(len(rows))
            view.start(enc_kvs)
            for _ in range(cfg.max_len):
                greedy_step_(port, view)
            got_t, got_c = view.toks.clone(), view.confidences()
        assert int(state.pos) == cfg.max_len
        assert torch.equal(got_t, own_t) and torch.equal(got_c, own_c)
        np.testing.assert_array_equal(got_t.numpy(), want_t[rows])
        np.testing.assert_allclose(got_c.numpy(), want_c[rows], atol=1e-4)


def test_cached_step_equals_teacher_forced_forward():
    """decode_step with the K/V caches reproduces the full-sequence
    logits position by position (pre-LN and post-norm)."""
    from vtd_tpu_torch.models.trocr import init_decoder_cache

    for kind in ("pre_ln", "hf"):
        _, _, port, cfg = _pair(kind)
        images, tokens = _inputs(cfg, 6, b=2, t=6)
        images, tokens = torch.from_numpy(images), torch.from_numpy(tokens)
        with torch.no_grad():
            full = port(images, tokens)
            enc_kvs = port.encode_kv(images)
            caches = init_decoder_cache(cfg, 2)
            for t in range(tokens.shape[1]):
                logits, caches = port.decode_step(
                    tokens[:, t], enc_kvs, caches, t
                )
                np.testing.assert_allclose(
                    logits.numpy(), full[:, t].numpy(), atol=1e-5
                )


def _golden_model():
    from vtd_tpu_torch.convert import trocr_from_hf_state
    from vtd_tpu_torch.models.trocr import TrOCR, hf_config

    g = np.load(GOLDEN)
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd:")}
    cfg = hf_config(
        vocab_size=53, image_size=32, patch_size=16, enc_dim=32, enc_layers=2,
        enc_heads=4, enc_mlp=64, dec_dim=32, dec_layers=2, dec_heads=4,
        dec_mlp=64, max_len=12,
    )
    model = TrOCR(cfg).eval()
    model.load_state_dict(trocr_from_hf_state(sd, cfg))
    return model, g


def test_hf_golden_logits():
    model, g = _golden_model()
    with torch.no_grad():
        got = model(torch.from_numpy(g["images"]),
                    torch.from_numpy(g["tokens"]))
    assert got.shape == g["logits_ref"].shape
    np.testing.assert_allclose(got.numpy(), g["logits_ref"], atol=2e-3, rtol=0)


def test_hf_golden_greedy_tokens():
    from vtd_tpu_torch.models.trocr import greedy_generate

    model, g = _golden_model()
    toks, conf = greedy_generate(
        model, torch.from_numpy(g["gen_images"]), bos_id=1, eos_id=2
    )
    assert conf.shape == (3,)
    for b in range(3):
        ref_row = list(g["gen_ref"][b][1:])  # drop decoder_start
        for r, o in zip(ref_row, toks[b].tolist()):
            assert r == o, (b, ref_row, toks[b].tolist())
            if r == 2:  # eos: the rest is padding in both
                break


def test_hf_converter_equals_reference_importer():
    """``trocr_from_hf_state`` and vtd_tpu's importer followed by
    ``trocr_from_jax`` give one state dict."""
    from vtd_tpu.models.import_torch import import_trocr_state
    from vtd_tpu.models.trocr import hf_config as ref_hf_config
    from vtd_tpu_torch.convert import trocr_from_hf_state, trocr_from_jax

    model, g = _golden_model()
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd:")}
    kw = dict(
        vocab_size=53, image_size=32, patch_size=16, enc_dim=32, enc_layers=2,
        enc_heads=4, enc_mlp=64, dec_dim=32, dec_layers=2, dec_heads=4,
        dec_mlp=64, max_len=12,
    )
    via_jax = trocr_from_jax(
        import_trocr_state(sd, ref_hf_config(**kw)), model.cfg
    )
    direct = trocr_from_hf_state(sd, model.cfg)
    assert set(via_jax) == set(direct) == set(model.state_dict())
    for k in direct:
        assert torch.equal(via_jax[k], direct[k]), k
    from vtd_tpu_torch.models.trocr import small_config

    with pytest.raises(ValueError, match="hf_config"):
        trocr_from_hf_state(sd, small_config())


def test_char_tokenizer_equals_reference():
    from vtd_tpu.models.trocr import CharTokenizer as RefTok
    from vtd_tpu_torch.models.trocr import CharTokenizer

    ref, tok = RefTok(), CharTokenizer()
    assert tok.vocab_size == ref.vocab_size == 98
    assert tok.char_to_id == ref.char_to_id
    text = "Hello, World! 123 é"
    ids = tok.encode(text)
    assert ids == ref.encode(text)
    assert ids[0] == tok.BOS and ids[-1] == tok.EOS
    assert tok.decode(ids[1:]) == ref.decode(ids[1:]) == "Hello, World! 123 "


def test_config_defaults_and_sidecar(tmp_path):
    """Field for field the reference's dataclass; the JSON sidecar of a
    trained checkpoint loads with its dtype as a torch dtype."""
    import dataclasses

    from vtd_tpu.models.trocr import TrOCRConfig as RefConfig
    from vtd_tpu.train.trocr_trainer import load_config as ref_load
    from vtd_tpu_torch.models.trocr import TrOCRConfig, load_config

    ref, cfg = dataclasses.asdict(RefConfig()), dataclasses.asdict(TrOCRConfig())
    assert ref.pop("dtype").__name__ == "bfloat16"
    assert cfg.pop("dtype") == torch.bfloat16
    assert ref == cfg
    assert TrOCRConfig().num_patches == 577 == RefConfig().num_patches

    path = os.path.join(REPO, "models", "text_recognizer_trocr_config.json")
    got, want = dataclasses.asdict(load_config(path)), dataclasses.asdict(
        ref_load(path))
    assert got.pop("dtype") == torch.float32 and str(want.pop("dtype")) == "float32"
    assert got == want
    bad = tmp_path / "bad_config.json"
    bad.write_text(json.dumps({"dtype": "int8"}))
    with pytest.raises(ValueError, match="unsupported dtype"):
        load_config(str(bad))


def test_bfloat16_forward_stays_near_float32():
    """The working type of the card, at a tiny size on the CPU: the
    dtype plumbing (float32 LayerNorm, scores, head; bf16 projections)
    holds together and stays near the float32 result."""
    import dataclasses

    from vtd_tpu_torch.models.trocr import TrOCR, greedy_generate

    _, _, port, cfg = _pair("pre_ln")
    bf = TrOCR(dataclasses.replace(cfg, dtype=torch.bfloat16)).eval()
    bf.load_state_dict(port.state_dict())
    assert bf.encoder.block0.attn.q.weight.dtype == torch.bfloat16
    assert bf.decoder.lm_head.weight.dtype == torch.float32
    assert bf.encoder.block0.ln1.weight.dtype == torch.float32
    images, tokens = _inputs(cfg, 7)
    with torch.no_grad():
        want = port(torch.from_numpy(images), torch.from_numpy(tokens))
        got = bf(torch.from_numpy(images), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.25
    toks, conf = greedy_generate(bf, torch.from_numpy(images))
    assert toks.shape == (3, cfg.max_len) and torch.isfinite(conf).all()


def test_seeded_init_is_reproducible():
    from vtd_tpu_torch.models.trocr import TrOCR, init_weights_, small_config

    a = init_weights_(TrOCR(small_config()), torch.Generator().manual_seed(3))
    b = init_weights_(TrOCR(small_config()), torch.Generator().manual_seed(3))
    c = init_weights_(TrOCR(small_config()), torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["decoder.block0.mlp.fc1.weight"],
                           sc["decoder.block0.mlp.fc1.weight"])
    assert not sa["encoder.cls_token"].any()


# ---------------------------------------------------------------------------
# Runtime: TransformerRecognizer and the TextRecognizer facade
# ---------------------------------------------------------------------------
def _crops(seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 255, (40, 200, 3)).astype(np.uint8),
        rng.integers(0, 255, (64, 64)).astype(np.uint8),  # grayscale
        rng.integers(0, 255, (17, 90, 3)).astype(np.uint8),
    ]


@pytest.fixture(scope="module")
def recognizers(tmp_path_factory):
    """vtd_tpu's TransformerRecognizer on seeded weights and the port's
    on the same weights, saved as a torch-format file with its sidecar."""
    import dataclasses
    import jax

    from vtd_tpu.models.trocr import small_config as ref_small
    from vtd_tpu.runtime.trocr_runtime import TransformerRecognizer as Ref
    from vtd_tpu_torch.convert import trocr_from_jax
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer

    kw = dict(image_size=32, image_width=96)
    ref = Ref(config=ref_small(**kw), pad_batch=4, seed=5)
    out = tmp_path_factory.mktemp("trocr")
    variables = jax.tree_util.tree_map(np.asarray, ref.variables)
    cfg = small_config(**kw)
    torch.save(trocr_from_jax(variables, cfg), out / "small.pt")
    side = dataclasses.asdict(cfg)
    side["dtype"] = "float32"
    (out / "small_config.json").write_text(json.dumps(side))
    port = TransformerRecognizer(str(out / "small.pt"), device="cpu")
    return ref, port


def test_recognizer_reads_sidecar_and_matches_reference(recognizers):
    ref, port = recognizers
    assert port.cfg.width == 96 and port.cfg.dtype == torch.float32
    crops = _crops()
    np.testing.assert_array_equal(port._prepare(crops), ref._prepare(crops))
    want, got = ref.recognize_batch(crops), port.recognize_batch(crops)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == {"text", "confidence"}
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4
        assert 0.0 <= g["confidence"] <= 1.0
    assert port.recognize(crops[0])["text"] == want[0]["text"]
    assert port.recognize_batch([]) == []
    texts, confs = port.recognize_crops_device(
        torch.zeros((0, 32, 96, 3)))
    assert texts == [] and confs.shape == (0,)


def test_recognizer_rows_are_independent(recognizers):
    """No padding to pad_batch multiples: a row decodes the same alone,
    twice in a batch, or beside other rows."""
    _, port = recognizers
    crops = _crops(1)
    alone = port.recognize_batch([crops[0]])[0]
    both = port.recognize_batch([crops[0], crops[2], crops[0]])
    assert both[0]["text"] == both[2]["text"] == alone["text"]
    assert abs(both[0]["confidence"] - alone["confidence"]) <= 1e-5


def test_recognizer_seeded_init_and_facade():
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.runtime import TextRecognizer
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer

    cfg = small_config(image_size=32, image_width=64, max_len=6)
    a = TransformerRecognizer(config=cfg, seed=2, device="cpu")
    b = TextRecognizer(use_transformer=True, transformer_config=cfg, seed=2,
                       device="cpu")
    assert b.use_transformer and b.crnn is None
    assert b.transformer.pad_batch == 16
    crops = _crops(2)
    assert a.recognize_batch(crops) == b.recognize_batch(crops)
    batch = torch.from_numpy(a._prepare(crops))
    texts_a, conf_a = a.recognize_crops_device(batch)
    texts_b, conf_b = b.recognize_crops_device(batch)
    assert texts_a == texts_b and np.array_equal(conf_a, conf_b)
    c = TransformerRecognizer(config=cfg, seed=3, device="cpu")
    assert not torch.equal(c.model.decoder.lm_head.weight,
                           a.model.decoder.lm_head.weight)
    # the default architecture is the full-width one; float32 on the CPU
    assert TransformerRecognizer._sidecar_config("no/such/file.pt") is None


def test_recognizer_loads_hf_layout_checkpoint(tmp_path):
    from vtd_tpu_torch.models.trocr import greedy_generate
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer

    model, g = _golden_model()
    sd = {k[3:]: torch.from_numpy(g[k]) for k in g.files
          if k.startswith("sd:")}
    torch.save({"model_state_dict": sd}, tmp_path / "hf.pth")
    rec = TransformerRecognizer(
        str(tmp_path / "hf.pth"), config=model.cfg, device="cpu")
    want, _ = greedy_generate(model, torch.from_numpy(g["gen_images"]))
    got, _ = rec.generate(torch.from_numpy(g["gen_images"]))
    assert torch.equal(got, want)
    # the reference's orbax directory loads too (with its sidecar); a path
    # that holds no checkpoint raises
    orbax = TransformerRecognizer(
        os.path.join(REPO, "models", "text_recognizer_trocr"), device="cpu")
    assert orbax.cfg.image_size == 48
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        TransformerRecognizer(str(tmp_path / "absent"), config=model.cfg,
                              device="cpu")


def test_transformer_entry_points_default_to_cuda():
    from vtd_tpu_torch.runtime import TextRecognizer, VideoTextPipeline
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    for entry in (
        TransformerRecognizer,
        lambda: TextRecognizer(use_transformer=True),
        lambda: VideoTextPipeline(use_transformer_ocr=True),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
