"""Command-line tools of the port, each run as ``python -m
vtd_tpu_torch.tools.<name>``: ``profile_device`` (device and wall time of
each pipeline stage), ``eval_trocr_ckpt`` (a TrOCR checkpoint's held-out
score) and ``diag_tracks`` (every merged text track of the verify clip).
"""
