"""The reference's ``tests/test_resume.py``, run against ``vtd_tpu_torch``.

One replacement: the module's pipeline fixture builds its
``VideoTextPipeline`` with ``device="cpu"``. The port's pipeline runs on
the card unless the caller names the CPU, and raises without CUDA (a
recorded divergence); the reference's falls back to the CPU by itself.
"""
from torch_ref_cases import cases, load

globals().update(cases(load("test_resume", replace=[(
    "detector_input_size=160, recognizer_kwargs",
    'detector_input_size=160, device="cpu", recognizer_kwargs',
)])))
