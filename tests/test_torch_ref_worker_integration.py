"""The reference's ``tests/test_worker_integration.py``, run against
``vtd_tpu_torch``.

One replacement: the ``small_worker`` fixture configures the worker's
pipeline with ``device="cpu"``. The port's pipelines are built on
``settings.device`` (``"cuda"``) unless ``configure_pipeline`` names
another, and raise without CUDA (a recorded divergence); the
reference's fall back to the CPU by themselves.
"""
from torch_ref_cases import cases, load

globals().update(cases(load("test_worker_integration", replace=[(
    "tasks.configure_pipeline(\n        batch_size=4,",
    'tasks.configure_pipeline(\n        device="cpu",\n        batch_size=4,',
)])))
