"""Data-parallel inference of the port (``VideoTextPipeline(mesh=...)``,
``process --data-parallel``, serving over a mesh is in
``tests/test_torch_serve.py``) against ``vtd_tpu``'s on its 8-device host
mesh (tests/conftest.py): the CRNN engine, batch 8, 16 slots, 160x160,
the trained demo checkpoints in float32 on both sides.

Tolerances: against ``vtd_tpu``'s mesh pipeline, transcripts equal, boxes
at IoU >= 0.95 (the two frameworks' float32, as tests/test_torch_pipeline.py)
and detection confidences within the reference test's 5e-3
(tests/test_parallel.py); the port's mesh against the port on one device:
equal results, every field.
"""
import asyncio
import json
import os

import numpy as np
import pytest
import torch

import torch_mesh_tasks as tasks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_DIR = os.path.join(REPO, "demo_models2", "dbnet", "best_bf16")
REC_DIR = os.path.join(REPO, "demo_models2", "crnn", "crnn_final")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return tasks.converted_weights(tmp_path_factory.mktemp("w"), DET_DIR,
                                   REC_DIR)


@pytest.fixture(scope="module")
def single(weights):
    from vtd_tpu_torch.runtime import VideoTextPipeline

    pipe = VideoTextPipeline(*weights, batch_size=8, device="cpu",
                             **tasks.PIPE)
    yield pipe
    pipe.close()


@pytest.fixture(scope="module")
def ref_mesh():
    """vtd_tpu's pipeline on 2 of its 8 host devices."""
    import jax

    from vtd_tpu.core.mesh import make_mesh

    return tasks.reference_pipeline(
        DET_DIR, REC_DIR, batch_size=8,
        mesh=make_mesh(n_data=2, devices=jax.devices()[:2]), **tasks.PIPE)


def _mesh_pipeline(weights, n, **kw):
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.runtime import VideoTextPipeline

    kw.setdefault("batch_size", 8)
    return VideoTextPipeline(
        *weights, mesh=make_mesh(n_data=n, devices=["cpu"] * n),
        **tasks.PIPE, **kw)


def test_mesh_pipeline_matches_reference_mesh(weights, ref_mesh):
    frames = tasks.text_frames()
    valid = np.ones(8, bool)
    pipe = _mesh_pipeline(weights, 2)
    try:
        got = pipe.process_batch(frames, valid)
    finally:
        pipe.close()
    want = ref_mesh.process_batch(frames, valid)
    assert tasks.assert_like_reference(got, want) >= 8
    assert [d["text"] for f in got for d in f] == [
        f"TXT{i}" for i in range(8)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_equals_one_device(weights, single, n):
    """n replicas, each with its own models, thread and block of frames,
    give what the pipeline gives on one device; padding frames stay
    empty; the handles of ``dispatch_batch`` hold one block a replica."""
    frames = tasks.text_frames()
    valid = np.ones(8, bool)
    part = valid.copy()
    part[5:] = False
    pipe = _mesh_pipeline(weights, n)
    try:
        assert len(pipe.replicas) == n
        assert len({id(r.detector.model) for r in pipe.replicas}) == n
        handles = pipe.dispatch_batch(frames, valid_frames=valid)
        assert len(handles["shards"]) == n
        assert pipe.process_batch(frames, valid, handles=handles) == \
            single.process_batch(frames, valid)
        assert pipe.process_batch(frames, part) == \
            single.process_batch(frames, part)
    finally:
        pipe.close()


def test_mesh_refusals(weights):
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.parallel import n_split
    from vtd_tpu_torch.runtime import VideoTextPipeline

    with pytest.raises(ValueError, match="divisible"):
        VideoTextPipeline(*weights, batch_size=6, device="cpu",
                          mesh=make_mesh(n_data=4, device="cpu"),
                          **tasks.PIPE)
    # with a model axis the batch divides by the data axis only: 6 frames
    # do not go over 4 data rows, 3 go over one row of 2 entries
    with pytest.raises(ValueError, match="divisible"):
        VideoTextPipeline(*weights, batch_size=6, device="cpu",
                          mesh=make_mesh(n_data=4, n_model=2, device="cpu"),
                          **tasks.PIPE)
    tp = VideoTextPipeline(*weights, batch_size=3, device="cpu",
                           mesh=make_mesh(n_data=1, n_model=2, device="cpu"),
                           **tasks.PIPE)
    try:
        assert len(tp.replicas) == 1
        assert n_split(tp.replicas[0].detector.model) == 38
        frames = tasks.text_frames(b=3)
        out = tp.process_batch(frames, np.ones(3, bool))
        assert [d["text"] for f in out for d in f] == [
            "TXT0", "TXT1", "TXT2"]
    finally:
        tp.close()
    pipe = _mesh_pipeline(weights, 2)
    try:
        with pytest.raises(ValueError, match="divisible"):
            pipe.dispatch_batch(tasks.text_frames(b=3))
        # as the reference's single-frame call on a mesh, it reports the
        # error instead of raising
        out = pipe.process_single_frame(tasks.text_frames(b=1)[0])
        assert out["detections"] == [] and "divisible" in out["error"]
    finally:
        pipe.close()


def test_global_recognition_budget(weights, single, ref_mesh):
    """All of a batch's text in the first of two blocks: 20-30 valid slots
    there, above the block's share (16) of the batch's budget (32) but
    under the budget. The reference recognises every one (its top-32 of
    the whole batch); so does the port, by dispatching that block again
    at the full budget, without latching."""
    frames = tasks.dense_frames()
    valid = np.ones(8, bool)
    pipe = _mesh_pipeline(weights, 2)
    reruns = []
    orig = pipe._dispatch_batch

    def counting(*a, **kw):
        reruns.append(kw.get("shards"))
        return orig(*a, **kw)

    try:
        packed, _ = pipe._collect(pipe.dispatch_batch(frames))
        first = pipe._parse_pack(packed, 8)
        n_valid = first["valid"].reshape(2, -1).sum(1)
        assert n_valid[1] == 0
        # the first pass leaves the valid slots past the block's share
        # unread (confidence 0; an empty read may score 0 too)
        conf = first["ctc"]["confidence"].reshape(8, -1)
        assert int((first["valid"] & (conf == 0)).sum()) >= \
            n_valid[0] - pipe._shard_budget(8, 2)
        assert pipe._shard_budget(8, 2) < n_valid[0]
        assert n_valid[0] <= pipe._effective_rec_budget(8)
        pipe._dispatch_batch = counting
        got = pipe.process_batch(frames, valid)
        assert reruns == [None, [0]]
        assert not pipe._full_budget_latched
    finally:
        pipe.close()
    want = ref_mesh.process_batch(frames, valid)
    assert tasks.assert_like_reference(got, want) >= 17
    assert got == single.process_batch(frames, valid)


def test_engine_over_a_mesh_pipeline(weights, single):
    from vtd_tpu_torch.runtime import InferenceEngine

    frames = tasks.text_frames()
    valid = np.ones(8, bool)
    want = single.process_batch(frames, valid)
    pipe = _mesh_pipeline(weights, 2)
    engine = InferenceEngine(pipeline=pipe)
    try:
        futs = [engine.submit_batch(frames, valid) for _ in range(2)]
        single_futs = [engine.submit_frame(f) for f in frames[:3]]
        assert [f.result(timeout=120) for f in futs] == [want, want]
        assert [f.result(timeout=120) for f in single_futs] == want[:3]
    finally:
        engine.close()
        pipe.close()


def test_cli_process_data_parallel(weights, tmp_path, capsys):
    """``process --data-parallel 2 --device cpu`` gives the result of the
    same command without it."""
    import cv2

    from vtd_tpu_torch.__main__ import main

    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (320, 240))
    for f in tasks.text_frames(b=10):
        writer.write(f)
    writer.release()
    det, rec = weights
    base = ["process", clip, "--crnn", "--detector", det, "--recognizer",
            rec, "--batch-size", "4", "--max-dets", "16", "--input-size",
            "160", "--device", "cpu"]
    outs = []
    for extra in ([], ["--data-parallel", "2"]):
        out = str(tmp_path / f"r{len(extra)}.json")
        assert main(base + extra + ["--out", out]) == 0
        outs.append(json.load(open(out)))
    capsys.readouterr()
    a, b = outs
    assert a["status"] == b["status"] == "success"
    assert a["results"] == b["results"]
    assert a["summary"]["total_detections"] == \
        b["summary"]["total_detections"] >= 10


def test_process_video_over_a_mesh(weights, single, tmp_path):
    """``process_video`` with its dispatcher thread over a 2-replica mesh
    equals the one-device pipeline's run."""
    import cv2

    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (320, 240))
    for f in tasks.text_frames(b=12):
        writer.write(f)
    writer.release()
    want = asyncio.run(single.process_video(clip, ""))
    pipe = _mesh_pipeline(weights, 2)
    try:
        got = asyncio.run(pipe.process_video(clip, ""))
    finally:
        pipe.close()
    assert got["status"] == "success", got.get("error")
    assert got["results"] == want["results"]


def test_transformer_engine_over_a_mesh():
    """The TrOCR branch over two replicas: each block's crops stay on its
    replica and are decoded there (in its thread); results equal the
    one-device pipeline's, the recognition confidence within 1e-5 (the
    crops are decoded in other chunks)."""
    from vtd_tpu_torch.core.mesh import make_mesh
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.runtime import VideoTextPipeline

    kw = dict(use_transformer_ocr=True, batch_size=4, max_dets=8,
              max_box_frac=1.0, detector_input_size=160,
              recognizer_kwargs={"transformer_config": small_config(),
                                 "pad_batch": 4})
    frames = tasks.text_frames(b=4, text="AB12")
    valid = np.array([True, True, True, False])
    want = VideoTextPipeline(device="cpu", **kw).process_batch(frames, valid)
    pipe = VideoTextPipeline(mesh=make_mesh(n_data=2, device="cpu"), **kw)
    decoded = []
    for rep in pipe.replicas:
        tr = rep.recognizer.transformer
        tr.generate = lambda crops, _g=tr.generate, _r=rep: (
            decoded.append((_r, crops.shape[0])) or _g(crops))
    try:
        got = pipe.process_batch(frames, valid)
    finally:
        pipe.close()
    assert sorted(n for _, n in decoded) == [1, 2]  # frames 0-1, frame 2
    assert {r for r, _ in decoded} == set(pipe.replicas)
    assert got[3] == [] and sum(map(len, got)) == 3
    for dets, ref in zip(got, want):
        assert len(dets) == len(ref)
        for d, r in zip(dets, ref):
            assert abs(d.pop("recognition_confidence")
                       - r.pop("recognition_confidence")) <= 1e-5
            assert d == r
