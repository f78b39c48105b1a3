"""``get_pipeline`` of the port's worker tasks against ``vtd_tpu``'s.

Checkpoint resolution (the active registry row, then the
``configure_pipeline`` kwargs, then ``settings.model_path``), the CRNN
fallback when no TrOCR checkpoint exists, one pipeline per (engine,
versions), and the ``model_versions`` provenance: both packages build
their pipelines with the same arguments from the same registry rows. A
stub stands in for ``VideoTextPipeline`` on both sides, so the test
reads what each would be built with; the port adds the device, which is
``settings.device`` (``"cuda"``) unless ``configure_pipeline`` names one.
"""
import importlib

import pytest


class Stub:
    def __init__(self, **kwargs):
        self.kwargs = kwargs


@pytest.fixture
def worlds(tmp_path, monkeypatch):
    """(reference, port): one empty model dir, and each its own in-memory
    DB and stubbed pipeline class."""
    out = []
    models = tmp_path / "models"
    models.mkdir()
    for pkg in ("vtd_tpu", "vtd_tpu_torch"):
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        monkeypatch.setattr(mod("core.config").settings, "model_path",
                            str(models))
        dbmod = mod("serve.db.database")
        db = dbmod.Database("sqlite://")
        db.init_db()
        monkeypatch.setattr(dbmod, "_default_db", db)
        monkeypatch.setattr(mod("runtime.pipeline"), "VideoTextPipeline",
                            Stub)
        tasks = mod("serve.tasks")
        tasks.configure_pipeline(batch_size=4)
        out.append((tasks, mod("serve.db"), db, models))
    yield out
    for tasks, *_ in out:
        tasks.configure_pipeline()


def _built(world, use_transformer):
    tasks = world[0]
    pipe = tasks.get_pipeline(use_transformer)
    kw = dict(pipe.kwargs)
    return pipe, kw, pipe.model_versions


def test_get_pipeline_follows_the_registry(worlds, tmp_path):
    det_v2 = tmp_path / "det_v2"
    rec_v2 = tmp_path / "rec_v2"
    det_v2.mkdir()
    rec_v2.mkdir()
    seen = []
    for world in worlds:
        tasks, db_pkg, db, models = world
        (models / "text_detector").mkdir(exist_ok=True)
        (models / "text_recognizer").mkdir(exist_ok=True)
        first, kw0, mv0 = _built(world, False)
        assert tasks.get_pipeline(False) is first  # cached per key
        crud = db_pkg.ModelVersionCRUD
        rows = [
            crud.create(db, db_pkg.ModelVersionCreate(
                name="dbnet", version=v, model_type="detector",
                file_path=str(p)))
            for v, p in (("1", tmp_path / "missing"), ("2", det_v2))
        ]
        rec = crud.create(db, db_pkg.ModelVersionCreate(
            name="crnn", version="7", model_type="recognizer",
            file_path=str(rec_v2)))
        # an active row whose checkpoint is missing falls back
        crud.set_active(db, rows[0]["id"])
        fallback, kw1, mv1 = _built(world, False)
        crud.set_active(db, rows[1]["id"])
        crud.set_active(db, rec["id"])
        second, kw2, mv2 = _built(world, False)
        assert second is not first
        seen.append((kw0, mv0, kw1, mv1, kw2, mv2))
    (ref, port) = seen
    for want, got in zip(ref, port):
        if isinstance(got, dict) and "device" in got:
            assert got.pop("device") == "cuda"
        assert got == want
    assert port[4]["detector_path"] == str(det_v2)
    assert port[4]["recognizer_path"] == str(rec_v2)
    assert port[5] == {
        "detector": {"id": 2, "name": "dbnet", "version": "2"},
        "recognizer": {"id": 3, "name": "crnn", "version": "7"},
    }


def test_get_pipeline_trocr_and_crnn_fallback(worlds, tmp_path):
    trocr = tmp_path / "trocr"
    trocr.mkdir()
    seen = []
    for world in worlds:
        tasks = world[0]
        # no TrOCR checkpoint anywhere: the transformer job gets the CRNN
        _, fallback, _ = _built(world, True)
        extra = {"device": "cpu"} if tasks.__name__.startswith(
            "vtd_tpu_torch") else {}
        tasks.configure_pipeline(transformer_path=str(trocr), **extra)
        _, kw, _ = _built(world, True)
        seen.append((fallback, kw))
    (ref, port) = seen
    assert port[0].pop("device") == "cuda"
    assert port[1].pop("device") == "cpu"
    assert port == ref
    assert port[0]["use_transformer_ocr"] is False
    assert port[1]["use_transformer_ocr"] is True
    assert port[1]["recognizer_path"] == str(trocr)
