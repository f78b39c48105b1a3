"""The port's two-stage runner (``parallel/pipeline.py:TwoStagePipeline``,
``VideoTextPipeline(parallel_mode="two_stage")``) on the CPU: the
counterparts of tests/test_pipeline_parallel.py, and one comparison with
``vtd_tpu``'s runner, which splits its 8 host devices 4/4.

The runner's default devices are ``[cpu, cpu]`` here (every visible card
on the card). Tolerances: against the fused path of the port, equal
results (every field, the recognition confidence within 1e-5 on the
transformer path, whose crops are decoded in other chunks); against
``vtd_tpu``'s runner, transcripts equal, boxes at IoU >= 0.95, detection
confidences within 5e-3 (tests/test_torch_parallel.py).
"""
import numpy as np
import pytest
import torch

import torch_mesh_tasks as tasks

torch.set_num_threads(2)

KW = dict(use_transformer_ocr=False, batch_size=4, max_dets=16,
          detector_input_size=160, device="cpu")


@pytest.fixture(scope="module")
def pipelines():
    from vtd_tpu_torch.runtime import VideoTextPipeline

    fused = VideoTextPipeline(**KW)
    two_stage = VideoTextPipeline(parallel_mode="two_stage", **KW)
    yield fused, two_stage
    two_stage.close()


def test_stage_device_split(pipelines):
    """Half the devices detect, the rest recognise; each stage's devices
    have their own replica (thread, models); with distinct devices the
    groups would be disjoint, on the CPU they repeat ``cpu``."""
    from vtd_tpu_torch.parallel.pipeline import TwoStagePipeline

    fused, two_stage = pipelines
    runner = two_stage._two_stage
    assert runner.group_sizes == (1, 1)
    assert runner.stage_devices() == (["cpu"], ["cpu"])
    # the first device of each stage keeps the pipeline's own model
    assert runner.stage_a[0].detector is two_stage.detector
    assert runner.stage_b[0].recognizer is two_stage.recognizer
    four = TwoStagePipeline(fused.detector, fused.recognizer,
                            devices=["cpu"] * 4, max_dets=16)
    try:
        assert four.group_sizes == (2, 2)
        a, b = four.stage_devices()
        assert len(a) == len(b) == 2
        reps = four.stage_a + four.stage_b
        assert len({id(r) for r in reps}) == 4
        assert len({id(r.detector.model) for r in four.stage_a}) == 2
        assert len({id(r.recognizer.crnn) for r in four.stage_b}) == 2
        assert all(r.recognizer is None for r in four.stage_a)
        assert all(r.detector is None for r in four.stage_b)
    finally:
        four.close()


def test_two_stage_matches_fused(pipelines):
    fused, two_stage = pipelines
    frames = tasks.text_frames(b=4, text="AB12")
    valid = np.ones(4, bool)
    want = fused.process_batch(frames, valid)
    assert two_stage.process_batch(frames, valid) == want
    part = np.array([True, False, True, False])
    assert two_stage.process_batch(frames, part) == \
        fused.process_batch(frames, part)


@pytest.fixture(scope="module")
def twelve(pipelines):
    """A 12-frame batch and the fused path's results on it."""
    fused, _ = pipelines
    frames = tasks.text_frames(b=12, text="AB12")
    return frames, fused.process_batch(frames, np.ones(12, bool))


@pytest.mark.parametrize("split,n", [(1, 3), (2, 3), (2, 4), (3, 4)])
def test_uneven_stage_groups_match_fused(pipelines, twelve, split, n):
    """Stage B regroups stage A's blocks when the groups differ in size
    (a 12-frame batch split 1/2, 2/1, 2/2 and 3/1)."""
    from vtd_tpu_torch.parallel.pipeline import TwoStagePipeline

    fused, _ = pipelines
    frames, want = twelve
    runner = TwoStagePipeline(fused.detector, fused.recognizer,
                              devices=["cpu"] * n, split=split, max_dets=16)
    try:
        (pack,) = runner(frames, 0.5)
    finally:
        runner.close()
    assert fused.process_batch(frames, np.ones(12, bool), handles={
        "shards": [{"pack": torch.from_numpy(pack), "event": None,
                    "crops": None}], "replicas": [None]}) == want


def test_two_stage_invalid_combo():
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.parallel.pipeline import TwoStagePipeline
    from vtd_tpu_torch.runtime import TextDetector, TextRecognizer, \
        VideoTextPipeline

    with pytest.raises(ValueError, match="mutually exclusive"):
        VideoTextPipeline(mesh=make_mesh(n_data=2, device="cpu"),
                          parallel_mode="two_stage", **KW)
    with pytest.raises(ValueError, match="parallel_mode"):
        VideoTextPipeline(parallel_mode="bogus", **KW)
    with pytest.raises(ValueError, match="rec_budget"):
        VideoTextPipeline(parallel_mode="two_stage", rec_budget=8, **KW)
    det = TextDetector(input_size=160, max_dets=16, device="cpu")
    rec = TextRecognizer(use_transformer=False, device="cpu")
    with pytest.raises(ValueError, match=">= 2 devices"):
        TwoStagePipeline(det, rec, devices=["cpu"])
    with pytest.raises(ValueError, match="without devices"):
        TwoStagePipeline(det, rec, devices=["cpu"] * 2, split=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TwoStagePipeline(det, rec)
    runner = TwoStagePipeline(det, rec, devices=["cpu"] * 3, max_dets=16)
    try:
        with pytest.raises(ValueError, match="divisible"):
            runner.dispatch(tasks.text_frames(b=3), 0.5)
    finally:
        runner.close()


def test_run_batches_wire_format(pipelines):
    """The fused program's layout: one uint8 pack [B, K, nbytes] a batch."""
    fused, two_stage = pipelines
    frames = tasks.text_frames(b=4, text="AB12")
    out = two_stage._two_stage.run_batches([frames, frames])
    assert len(out) == 2
    want, _ = fused._collect(fused.dispatch_batch(frames))
    for (pack,) in out:
        assert pack.dtype == np.uint8
        assert pack.shape == want.shape and pack.shape[:2] == (4, 16)
        # the det block equals the fused pack's; the runner reads every
        # slot, the fused program its budget's
        det = fused._parse_pack(pack, 4)
        ref = fused._parse_pack(want, 4)
        for k in ("boxes", "polys", "scores", "valid"):
            np.testing.assert_array_equal(det[k], ref[k])


def test_two_stage_transformer_smoke():
    """Transformer path: detect on stage A, crops hop to stage B where the
    TrOCR decode runs; equal to the fused transformer path."""
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.runtime import VideoTextPipeline

    kw = dict(KW, use_transformer_ocr=True, max_dets=8, max_box_frac=1.0,
              recognizer_kwargs={"transformer_config": small_config(),
                                 "pad_batch": 4})
    frames = tasks.text_frames(b=4, text="AB12")
    valid = np.ones(4, bool)
    p = VideoTextPipeline(parallel_mode="two_stage", **kw)
    try:
        det_bytes, crops = p._two_stage(frames, 0.5)
        assert det_bytes.dtype == np.uint8 and det_bytes.shape[:2] == (4, 8)
        assert len(crops) == 1
        assert crops[0].shape == (4 * 8, *p.crop_hw, 3)
        out = p.process_batch(frames, valid)
    finally:
        p.close()
    want = VideoTextPipeline(**kw).process_batch(frames, valid)
    assert len(out) == len(want) == 4 and sum(map(len, out)) >= 4
    for dets, ref in zip(out, want):
        assert len(dets) == len(ref)
        for d, r in zip(dets, ref):
            assert isinstance(d["text"], str)
            assert abs(d.pop("recognition_confidence")
                       - r.pop("recognition_confidence")) <= 1e-5
            assert d == r


def test_two_stage_forwards_max_box_frac():
    from vtd_tpu_torch.runtime import VideoTextPipeline

    p = VideoTextPipeline(parallel_mode="two_stage", max_box_frac=1.0,
                          **dict(KW, max_dets=8))
    try:
        assert p._two_stage.max_box_frac == 1.0
    finally:
        p.close()


def test_two_stage_matches_reference_runner(tmp_path):
    """The port's runner against vtd_tpu's (its 8 host devices split 4/4)
    on the same frames and trained weights (float32 on both sides)."""
    import os

    from vtd_tpu_torch.runtime import VideoTextPipeline

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    det_dir = os.path.join(repo, "demo_models2", "dbnet", "best_bf16")
    rec_dir = os.path.join(repo, "demo_models2", "crnn", "crnn_final")
    kw = dict(tasks.PIPE, batch_size=8, parallel_mode="two_stage")
    ref = tasks.reference_pipeline(det_dir, rec_dir, **kw)
    assert ref._detect_crop.group_sizes == (4, 4)
    port = VideoTextPipeline(
        *tasks.converted_weights(tmp_path, det_dir, rec_dir), device="cpu",
        **kw)
    frames = tasks.text_frames()
    valid = np.ones(8, bool)
    try:
        got = port.process_batch(frames, valid)
    finally:
        port.close()
    assert tasks.assert_like_reference(got, ref.process_batch(frames, valid)
                                       ) >= 8
