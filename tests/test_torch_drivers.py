"""The port's drivers (``vtd_tpu_torch.examples``, ``vtd_tpu_torch.tools``)
and the API it lacked against ``vtd_tpu``.

``verify_checkpoints`` on the CRNN path must reproduce the ``e2e`` record
of ``demo_models2/report.json`` (the JAX package's reading of the same
clip with the same settings), ``update_report`` both engines' records
(``e2e``, ``e2e_transformer``: the whole report, since it is given no
training log; the CRNN run is shared with ``verify_checkpoints``'s) and
``eval_trocr_ckpt`` its held-out score;
the held-out crops it stores must be the reference's slice;
``profile_device`` must report its nine stages on the CPU, its
``post_full`` equal to ``db_postprocess`` called directly. The API:
``extract_frames_generator`` gives the reference's items;
``preprocess_frames`` with ``bgr_to_rgb`` or ``antialias`` off is within
1e-5 of the reference's (float32 on both sides, 720x1280 -> 640);
``db_postprocess`` takes ``cc_iters`` as the reference does (the labels
equal at 4 and 8, the detections at 4, and the port's outputs at 4 equal
those at 8).
"""
import asyncio
import json
import os

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "demo_models2", "dbnet", "best_bf16")
CRNN = os.path.join(REPO, "demo_models2", "crnn", "crnn_final")
TROCR = os.path.join(REPO, "models", "text_recognizer_trocr")


@pytest.fixture(scope="module")
def report():
    with open(os.path.join(REPO, "demo_models2", "report.json")) as f:
        return json.load(f)


def test_verify_clip_is_the_shipped_frame():
    from vtd_tpu_torch.examples.verify_checkpoints import clip_frames

    want = np.load(os.path.join(REPO, "tests", "torch_data",
                                "verify_frames.npz"))["frame_bgr"]
    frames = list(clip_frames())
    assert len(frames) == 60
    for f in frames:
        np.testing.assert_array_equal(f, want)


@pytest.fixture(scope="module")
def clip_runs():
    """``verify_checkpoints.run_clip`` remembered for this module: the
    verify clip goes through each engine once on the CPU, and
    ``verify`` and ``update_report`` read the same run. Yields the runs
    made, by their arguments."""
    from vtd_tpu_torch.examples import verify_checkpoints

    real, runs = verify_checkpoints.run_clip, {}

    def run_clip(*args):
        if args not in runs:
            runs[args] = real(*args)
        return runs[args]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(verify_checkpoints, "run_clip", run_clip)
        yield runs


def test_verify_checkpoints_crnn_reproduces_report(report, clip_runs):
    from vtd_tpu_torch.examples.verify_checkpoints import verify

    got = verify(DET, CRNN, use_transformer=False, device="cpu")
    want = report["e2e"]
    assert (got["frames"], got["detections"]) == (20, 60) == (
        want["frames"], want["detections"])
    assert got["detected_texts"] == want["detected_texts"] == [
        "123", "HELLO", "WORLD"]
    assert got["exact_matches"] == want["exact_matches"] == 3
    assert got["clean"] is want["clean"] is True
    assert got["engine"] == "crnn"


def test_update_report_reproduces_report(report, clip_runs, tmp_path):
    from vtd_tpu_torch.tools import update_report

    out = tmp_path / "report.json"
    assert update_report.main(["--detector", DET, "--crnn", CRNN,
                               "--trocr", TROCR, "--out", str(out),
                               "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    # the JAX package's tool wrote both sections; the trocr section and
    # the training ones are untouched without --trocr-log
    assert got == report
    assert got["e2e"]["avg_det_conf"] == 0.95
    assert (DET, CRNN, False, "cpu") in clip_runs
    assert (DET, TROCR, True, "cpu") in clip_runs


def test_eval_trocr_ckpt_scores_as_report(report):
    from vtd_tpu_torch.tools.eval_trocr_ckpt import evaluate

    ckpt = os.path.join("demo_models2", "trocr_r5", "trocr_final")
    got = evaluate(os.path.join(REPO, ckpt), device="cpu")
    assert report["trocr"]["checkpoint"] == ckpt
    assert got["heldout_exact_match_random8"] == report["trocr"][
        "heldout_exact_match_random8"] == "32/32"
    assert got["heldout_char_accuracy_random8"] == 1.0


def test_eval_trocr_heldout_is_the_reference_slice():
    from vtd_tpu.train.trocr_trainer import (
        load_config as ref_load_config,
        synthesize_trocr_crops as ref_synthesize,
    )
    from vtd_tpu_torch.models.trocr import load_config
    from vtd_tpu_torch.tools.eval_trocr_ckpt import heldout

    path = os.path.join(REPO, "demo_models2", "trocr_r5",
                        "trocr_final_config.json")
    images, texts, source = heldout(load_config(path))
    want, want_texts = ref_synthesize(32, ref_load_config(path),
                                      seed=424242, length_range=(8, 9))
    assert source == "stored"
    assert texts == want_texts and all(len(t) == 8 for t in texts)
    np.testing.assert_array_equal(images, want)


def test_profile_device_on_cpu_reports_every_stage():
    from vtd_tpu_torch.ops.db_postprocess import db_postprocess
    from vtd_tpu_torch.tools.profile_device import (
        STAGES, profile_stages, report,
    )

    res = profile_stages(batch=2, iters=1, device="cpu")
    assert list(res["stages"]) == list(STAGES) == [
        "pre", "fwd", "post_cc", "post_topk", "post_bnd", "post_full",
        "crop", "crnn", "fused"]
    for name, s in res["stages"].items():
        assert s["wall_ms"] > 0, name
        assert s["device_ms"] is None and s["idle"] is None, name
    assert res["timing"] == "not measured (CPU)"
    text = report(res, 2, 1, "CPU")
    for name in STAGES:
        assert f"\n{name} " in text
    with torch.inference_mode():
        direct = db_postprocess(res["outputs"]["fwd"], 0.5, max_dets=64)
    got = res["outputs"]["post_full"]
    assert set(got) == set(direct)
    for k in direct:
        assert torch.equal(got[k], direct[k]), k
    assert res["outputs"]["fused"].shape[:2] == (2, 64)


@pytest.fixture(scope="module")
def small_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "c.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (160, 120))
    rng = np.random.default_rng(3)
    for _ in range(24):
        w.write(rng.integers(0, 255, (120, 160, 3), np.uint8))
    w.release()
    return path


def test_extract_frames_generator_matches_reference(small_clip):
    from vtd_tpu.video.processor import VideoProcessor as RefProcessor
    from vtd_tpu_torch.video.processor import VideoProcessor

    async def items(vp):
        return [x async for x in vp.extract_frames_generator(small_clip, 10)]

    got = asyncio.run(items(VideoProcessor()))
    want = asyncio.run(items(RefProcessor()))
    assert len(got) == len(want) == 8
    for (gf, gi, gt), (wf, wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        assert (gi, gt) == (wi, wt)


@pytest.mark.parametrize("bgr_to_rgb,antialias",
                         [(False, True), (True, False), (False, False)])
def test_preprocess_options_match_reference(bgr_to_rgb, antialias):
    import jax.numpy as jnp

    from vtd_tpu.ops.preprocess import preprocess_frames as ref_pre
    from vtd_tpu_torch.ops.preprocess import preprocess_frames

    frames = np.random.default_rng(5).integers(
        0, 255, (2, 720, 1280, 3), np.uint8)
    want = np.asarray(ref_pre(jnp.asarray(frames), out_size=640,
                              dtype=jnp.float32, bgr_to_rgb=bgr_to_rgb,
                              antialias=antialias))
    got = preprocess_frames(torch.from_numpy(frames), 640, torch.float32,
                            bgr_to_rgb=bgr_to_rgb, antialias=antialias)
    assert got.shape == want.shape == (2, 640, 640, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the option changes the result: these are not the defaults' numbers
    default = preprocess_frames(torch.from_numpy(frames), 640, torch.float32)
    assert not torch.allclose(got, default, atol=1e-3)


def _blob_maps():
    m = np.zeros((3, 160, 160), np.float32)
    for i, (cx, cy, w, h, ang) in enumerate(
            [(80, 80, 90, 20, 0), (60, 50, 70, 16, 30), (90, 100, 120, 8, -45)]):
        box = cv2.boxPoints(((cx, cy), (w, h), ang))
        cv2.fillPoly(m[i], [np.round(box).astype(np.int32)], 0.9)
    m[1, 120:140, 20:60] = 0.8
    return m


def test_db_postprocess_takes_cc_iters_as_reference():
    import jax
    import jax.numpy as jnp

    from vtd_tpu.ops.db_postprocess import db_postprocess as ref_pp
    from vtd_tpu_torch.ops.db_postprocess import (
        db_postprocess, db_postprocess_batch,
    )

    maps = _blob_maps()
    outs = {}
    for iters in (4, 8):
        labels = db_postprocess(torch.from_numpy(maps), 0.5, max_dets=8,
                                cc_iters=iters, stage="cc")["labels"]
        want_labels = jax.vmap(lambda p: ref_pp(
            p, 0.5, max_dets=8, cc_iters=iters, stage="cc")["labels"])(
                jnp.asarray(maps))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
        outs[iters] = db_postprocess_batch(torch.from_numpy(maps), 0.5,
                                           max_dets=8, cc_iters=iters)
    want = jax.vmap(lambda p: ref_pp(p, 0.5, max_dets=8, cc_iters=4))(
        jnp.asarray(maps))
    np.testing.assert_array_equal(outs[4]["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_array_equal(outs[4]["areas"].numpy(),
                                  np.asarray(want["areas"]))
    np.testing.assert_allclose(outs[4]["boxes"].numpy(),
                               np.asarray(want["boxes"]), atol=1e-3)
    assert outs[4]["valid"].sum() == 4
    for k in outs[8]:
        assert torch.equal(outs[4][k], outs[8][k]), k
