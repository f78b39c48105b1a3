"""Web UI served by the API at ``/app`` (port of ``vtd_tpu/frontend``).
The reference's ``client.py`` waits for the next slice of the port."""
