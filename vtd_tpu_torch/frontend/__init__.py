"""Web UI served by the API at ``/app``, and the API's client (port of
``vtd_tpu/frontend``)."""
from .client import APIClient

__all__ = ["APIClient"]
