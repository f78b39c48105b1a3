"""The port's video paths as a whole, against ``vtd_tpu``'s.

``process_video`` runs on a synthetic clip with burned-in text through
both packages, on the trained demo detector with the trained CRNN and
with the trained TrOCR (restored with ``vtd_tpu``'s loader and carried
across by ``vtd_tpu_torch.convert``), float32 on both sides: transcripts
equal, boxes matched at IoU >= 0.95, temporal-dedup tracks equal.
Also: the overflow second pass, recognition in chunks, the device rule,
the multi-device modes against the fused path, and that the port never
imports JAX.
"""
import ast
import asyncio
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(
    use_transformer_ocr=False, batch_size=4, max_dets=16,
    detector_input_size=160, decode_backend="cv2", transfer_format="yuv420",
)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """1-second 320x240 @ 30 fps clip, 'HELLO WORLD' on half the frames;
    sampled at 10 fps it gives two full batches of 4 and a padded tail."""
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (320, 240)
    )
    for i in range(30):
        frame = np.full((240, 320, 3), 255, np.uint8)
        if (i // 15) % 2 == 0:
            cv2.putText(frame, "HELLO WORLD", (20, 120),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 2)
        writer.write(frame)
    writer.release()
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Trained demo weights: reference checkpoint dirs and the port's
    torch-format files converted from them."""
    from vtd_tpu.train.checkpoint import restore_variables
    from vtd_tpu_torch.convert import (
        crnn_from_jax, dbnet_from_jax, trocr_from_jax,
    )
    from vtd_tpu_torch.models.trocr import load_config

    out = tmp_path_factory.mktemp("weights")
    det_dir = os.path.join(REPO, "demo_models2", "dbnet", "best_bf16")
    rec_dir = os.path.join(REPO, "demo_models2", "crnn", "crnn_final")
    tr_dir = os.path.join(REPO, "models", "text_recognizer_trocr")
    torch.save(dbnet_from_jax(restore_variables(det_dir)), out / "dbnet.pt")
    torch.save(crnn_from_jax(restore_variables(rec_dir)), out / "crnn.pt")
    # the trained TrOCR with its architecture sidecar beside it
    shutil.copy(tr_dir + "_config.json", out / "trocr_config.json")
    torch.save(
        trocr_from_jax(restore_variables(tr_dir),
                       load_config(str(out / "trocr_config.json"))),
        out / "trocr.pt",
    )
    return {"ref": (det_dir, rec_dir),
            "port": (str(out / "dbnet.pt"), str(out / "crnn.pt")),
            "ref_trocr": (det_dir, tr_dir),
            "port_trocr": (str(out / "dbnet.pt"), str(out / "trocr.pt"))}


def _reference_pipeline(det_dir, rec_dir, **kw):
    """vtd_tpu's pipeline computing in float32 on float32 weights. (The
    demo detector is stored in bf16; fed as is, flax's BatchNorm adds eps
    to the bf16 variance in bf16, which moves this clip's probabilities
    by up to 0.03. The port converts the weights to float32.)"""
    import jax
    import jax.numpy as jnp

    from vtd_tpu.models.crnn import CRNN
    from vtd_tpu.models.dbnet import DBNet
    from vtd_tpu.runtime import VideoTextPipeline as RefPipeline

    pipe = RefPipeline(
        detector_path=det_dir, recognizer_path=rec_dir,
        recognizer_kwargs={"pad_batch": 32}, **kw,
    )
    pipe.detector.model = DBNet(dtype=jnp.float32)
    pipe.detector.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), pipe.detector.variables
    )
    if pipe.recognizer.crnn is not None:
        pipe.recognizer.crnn = CRNN(dtype=jnp.float32)
    pipe._detect_crop = pipe._build_detect_crop()
    return pipe


def _iou(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1)


def _assert_same_video_result(got, want):
    assert got["status"] == want["status"] == "success", got.get("error")
    assert got["video_info"] == want["video_info"]
    assert [r["frame_number"] for r in got["results"]] == [
        r["frame_number"] for r in want["results"]
    ]
    n = 0
    for g, w in zip(got["results"], want["results"]):
        assert g["timestamp"] == w["timestamp"]
        assert [d["text"] for d in g["detections"]] == [
            d["text"] for d in w["detections"]
        ]
        for dg, dw in zip(g["detections"], w["detections"]):
            assert set(dg) == set(dw)
            assert _iou(dg["bbox"], dw["bbox"]) >= 0.95
            n += 1
    assert n > 0, "the demo detector found no text"
    assert any(d["text"] for r in got["results"] for d in r["detections"])
    for key in ("total_frames", "frames_with_text", "total_detections",
                "unique_texts", "detected_texts"):
        assert got["summary"][key] == want["summary"][key], key


def test_process_video_matches_reference(clip, weights):
    from vtd_tpu_torch.runtime import VideoTextPipeline

    ref = _reference_pipeline(*weights["ref"], **SETTINGS)
    want = asyncio.run(ref.process_video(clip, ""))
    port = VideoTextPipeline(
        *weights["port"], device="cpu", **SETTINGS
    )
    got = asyncio.run(port.process_video(clip, ""))
    _assert_same_video_result(got, want)
    assert "text_tracks" not in got["summary"]


def test_process_video_transformer_matches_reference(clip, weights):
    """The TrOCR engine end to end on the trained checkpoint
    (48x192 input, 4+4 layers), with temporal dedup on: transcripts,
    boxes, summary and text tracks against the reference's."""
    from vtd_tpu_torch.runtime import VideoTextPipeline

    settings = dict(SETTINGS, use_transformer_ocr=True)
    ref = _reference_pipeline(*weights["ref_trocr"], **settings)
    want = asyncio.run(ref.process_video(clip, "", temporal_dedup=True))
    port = VideoTextPipeline(
        *weights["port_trocr"], device="cpu", temporal_dedup=True, **settings
    )
    assert port.crop_hw == ref.crop_hw == (48, 192)
    assert port.rec_chunk == ref.rec_chunk == 16
    got = asyncio.run(port.process_video(clip, ""))
    _assert_same_video_result(got, want)
    for dg, dw in zip(
        (d for r in got["results"] for d in r["detections"]),
        (d for r in want["results"] for d in r["detections"]),
    ):
        assert abs(dg["recognition_confidence"]
                   - dw["recognition_confidence"]) <= 1e-3
    tracks_g, tracks_w = (
        r["summary"]["text_tracks"] for r in (got, want)
    )
    assert len(tracks_g) == len(tracks_w) > 0
    for tg, tw in zip(tracks_g, tracks_w):
        for key in ("text", "first_frame", "last_frame", "count"):
            assert tg[key] == tw[key], key
        assert _iou(tg["bbox"], tw["bbox"]) >= 0.95
    # per call, the switch overrides the instance's default
    off = asyncio.run(port.process_video(clip, "", temporal_dedup=False))
    assert "text_tracks" not in off["summary"]


def test_transformer_engine_recognizes_in_chunks(text_image):
    """rec_chunk bounds the crops per recogniser call and changes no
    result: chunks of 1, a short last chunk, and one chunk for all."""
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.runtime import VideoTextPipeline

    frames = np.stack([text_image, text_image[::-1].copy()] * 3)[:5]
    valid = np.ones(5, bool)
    outs, calls = [], []
    for chunk in (1, 3, None):
        pipe = VideoTextPipeline(
            use_transformer_ocr=True, batch_size=5, max_dets=8,
            max_box_frac=1.0, detector_input_size=160, device="cpu",
            rec_chunk=chunk,
            recognizer_kwargs={"transformer_config": small_config(
                image_size=32, image_width=64, max_len=6)},
        )
        tr = pipe.recognizer.transformer
        sizes = []
        generate = tr.generate
        tr.generate = lambda crops, _g=generate, _s=sizes: (
            _s.append(crops.shape[0]) or _g(crops))
        outs.append(pipe.process_batch(frames, valid))
        calls.append(sizes)
    n = sum(len(d) for d in outs[0])
    assert n >= 4, "fixture too sparse to fill more than one chunk"
    # float32 sums are blocked by batch size: confidences to 1e-5
    for other in outs[1:]:
        for dets_a, dets_b in zip(outs[0], other):
            assert len(dets_a) == len(dets_b)
            for da, db in zip(dets_a, dets_b):
                conf_a, conf_b = (dict(d).pop("recognition_confidence")
                                  for d in (da, db))
                assert abs(conf_a - conf_b) <= 1e-5
                assert {k: v for k, v in da.items()
                        if k != "recognition_confidence"} == {
                    k: v for k, v in db.items()
                    if k != "recognition_confidence"}
    assert calls[0] == [1] * n
    assert calls[1] == [3] * (n // 3) + ([n % 3] if n % 3 else [])
    assert calls[2] == [n]  # default chunk: the recogniser's 16
    for dets in outs[0]:
        for d in dets:
            assert set(d) == {"bbox", "text", "detection_confidence",
                              "recognition_confidence", "polygon"}
            assert 0.0 <= d["recognition_confidence"] <= 1.0
    # padding frames produce nothing and reach no recogniser call
    pad = np.array([True, False, True, False, False])
    out_p = pipe.process_batch(frames, pad)
    assert [bool(d) for d in out_p] == [bool(d) and bool(v)
                                        for d, v in zip(outs[0], pad)]
    with pytest.raises(ValueError, match="rec_chunk"):
        VideoTextPipeline(use_transformer_ocr=True, rec_chunk=-1,
                          detector_input_size=160, device="cpu",
                          recognizer_kwargs={
                              "transformer_config": small_config()})


def test_rec_budget_overflow_recovers_all_transcripts(text_image):
    """More valid detections than the recognition budget: the full-budget
    second pass restores every transcript, and the pipeline latches."""
    from vtd_tpu_torch.runtime import VideoTextPipeline

    kwargs = dict(
        use_transformer_ocr=False, batch_size=4, max_dets=16,
        max_box_frac=1.0, detector_input_size=160, device="cpu",
    )
    frames = np.stack([text_image] * 4)
    valid = np.ones(4, bool)
    full = VideoTextPipeline(rec_budget=4 * 16, **kwargs)
    out_full = full.process_batch(frames, valid)
    n_dets = sum(len(d) for d in out_full)
    assert n_dets >= 2, "fixture too sparse to overflow a budget of 1"

    tight = VideoTextPipeline(rec_budget=max(1, n_dets // 2), **kwargs)
    key = [[(d["text"], d["bbox"]) for d in dets] for dets in out_full]
    out_t = tight.process_batch(frames, valid)
    assert [[(d["text"], d["bbox"]) for d in dets] for dets in out_t] == key
    assert tight._full_budget_latched
    handles = tight.dispatch_batch(frames, valid_frames=valid)
    out_t2 = tight.process_batch(frames, valid, handles=handles)
    assert [[(d["text"], d["bbox"]) for d in dets] for dets in out_t2] == key

    # padding frames never take slots or produce results
    pad = np.array([True, True, False, False])
    out_p = full.process_batch(frames, pad)
    assert out_p[:2] == out_full[:2] and out_p[2:] == [[], []]


def test_process_single_frame_schema(text_image):
    from vtd_tpu_torch.runtime import VideoTextPipeline

    pipe = VideoTextPipeline(
        use_transformer_ocr=False, batch_size=1, max_dets=8,
        detector_input_size=160, max_box_frac=1.0, device="cpu",
    )
    out = pipe.process_single_frame(text_image)
    assert "detections" in out and "error" not in out
    for d in out["detections"]:
        assert set(d) == {"bbox", "text", "detection_confidence",
                          "recognition_confidence"}


def test_detector_yuv420_transfer(text_image):
    """yuv420 transfer is bit-exact with a BGR detector fed the frames the
    device unpacks; already-packed input passes through."""
    from vtd_tpu_torch.ops.preprocess import yuv420_to_bgr
    from vtd_tpu_torch.runtime import TextDetector

    frames = np.stack([text_image, text_image[::-1].copy()])
    kw = dict(input_size=160, max_dets=16, max_box_frac=1.0, device="cpu")
    det_yuv = TextDetector(transfer_format="yuv420", **kw)
    det_bgr = TextDetector(**kw)
    packed = np.stack(
        [cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in frames]
    )
    roundtrip = yuv420_to_bgr(torch.from_numpy(packed)).numpy()
    out_yuv = det_yuv.detect_batch(frames)
    assert out_yuv == det_bgr.detect_batch(roundtrip)
    assert det_yuv.detect_batch(packed) == out_yuv
    assert det_yuv.detect(frames[0]) == out_yuv[0]
    with pytest.raises(ValueError, match="transfer_format"):
        TextDetector(transfer_format="rgb", **kw)


def test_entry_points_default_to_cuda_and_raise_without_it():
    from vtd_tpu_torch.runtime import (
        TextDetector, TextRecognizer, VideoTextPipeline,
    )

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    for entry in (VideoTextPipeline, TextDetector, TextRecognizer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


@pytest.mark.parametrize(
    "kwargs",
    [
        {"parallel_mode": "two_stage"},
        {"mesh": 2},
    ],
)
def test_later_slices_raise(kwargs, text_image):
    """The paths that raised before the multi-device slice (the two-stage
    runner; a mesh, here of two CPU entries) now run and give the fused
    one-device pipeline's results."""
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.runtime import VideoTextPipeline

    kw = dict(use_transformer_ocr=False, batch_size=2, max_dets=8,
              detector_input_size=160, max_box_frac=1.0, device="cpu")
    if "mesh" in kwargs:
        kwargs = {"mesh": make_mesh(n_data=kwargs["mesh"], device="cpu")}
    frames = np.stack([text_image, text_image[::-1].copy()])
    valid = np.ones(2, bool)
    pipe = VideoTextPipeline(**kw, **kwargs)
    try:
        got = pipe.process_batch(frames, valid)
    finally:
        pipe.close()
    assert got == VideoTextPipeline(**kw).process_batch(frames, valid)
    assert sum(map(len, got)) > 0


def _port_files():
    pkg = os.path.join(REPO, "vtd_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_never_imports_jax():
    banned = {"jax", "jaxlib", "flax", "orbax", "tensorstore", "vtd_tpu",
              "prometheus_client"}
    files = _port_files()
    assert len(files) > 15
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not banned & set(roots), (path, node.lineno, roots)
        # cv2 only inside functions, never at module level
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [
                    getattr(node, "module", None) or ""
                ]
                assert "cv2" not in names, (path, node.lineno)

    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").replace(
            ".__init__", "")
        for p in files if "vtd_tpu_torch" in p
    )
    code = (
        f"import sys; sys.path.insert(0, {REPO!r})\n"
        f"import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'tensorstore', 'vtd_tpu', 'cv2', "
        "'prometheus_client'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
