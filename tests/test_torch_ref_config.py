"""The reference's ``tests/test_config.py``, run against ``vtd_tpu_torch``."""
from torch_ref_cases import cases, load

globals().update(cases(load("test_config")))
