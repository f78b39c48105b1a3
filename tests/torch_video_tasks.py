"""The service's own ``process_video_task`` at a size the CPU runs in
seconds, for process-pool children and ``worker`` subprocesses of the
port's fleet tests.

Settings do not cross ``spawn``: a child builds its settings from the
environment it inherits (``DATABASE_URL``, ``TEMP_DIR``, ``OUTPUT_DIR``,
``MODEL_PATH``, ``DEVICE``), and its pipeline's sizes from the
``configure_pipeline`` call this module makes when it is imported.
"""
import os

import torch

from vtd_tpu_torch.serve import tasks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE = dict(
    detector_path=os.path.join(REPO, "demo_models2", "dbnet", "best_bf16"),
    recognizer_path=os.path.join(REPO, "demo_models2", "crnn", "crnn_final"),
    batch_size=4, max_dets=16, detector_input_size=160,
    decode_backend="cv2", device="cpu",
)

tasks.configure_pipeline(**PIPE)
process_video_task = tasks.process_video_task


def add_video_job(db, clip, task_id):
    """A user, a video row for ``clip`` and a job row for ``task_id`` in
    ``db``; returns the video's id."""
    from vtd_tpu_torch.serve.db import (
        ProcessingJobCreate, ProcessingJobCRUD, UserCreate, UserCRUD,
        VideoCreate, VideoCRUD,
    )

    user = UserCRUD.create(db, UserCreate(
        email=f"{task_id}@example.com", username=task_id, password="pw"))
    video = VideoCRUD.create(db, VideoCreate(
        filename="clip.mp4", original_filename="clip.mp4", file_path=clip,
        file_size=os.path.getsize(clip)), owner_id=user["id"])
    ProcessingJobCRUD.create(db, ProcessingJobCreate(
        video_id=video["id"], celery_task_id=task_id))
    return video["id"]


def run_on_thread_worker(clip, config):
    """``process_video_task`` on the thread worker of a fresh in-process
    ``TaskQueue``, over an in-memory database holding ``clip``'s video
    and job rows; returns the task's return and its job row. The caller
    has this module's ``configure_pipeline`` in force."""
    from vtd_tpu_torch.serve.db import Database, ProcessingJobCRUD, database
    from vtd_tpu_torch.serve.queue import TaskQueue

    previous = database._default_db
    db = Database("sqlite://")
    db.init_db()
    database.set_database(db)
    q = TaskQueue(concurrency=1)
    q.task(name="process_video_task")(process_video_task.fn)
    try:
        video_id = add_video_job(db, clip, "thread-job")
        res = q.submit(q.tasks["process_video_task"], (video_id, config), {},
                       task_id="thread-job")
        ret = res.get(timeout=180.0)
        return ret, ProcessingJobCRUD.get_by_task_id(db, "thread-job")
    finally:
        q.shutdown()
        database.set_database(previous)
