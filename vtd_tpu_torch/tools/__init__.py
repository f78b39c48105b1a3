"""Command-line tools of the port, each run as ``python -m
vtd_tpu_torch.tools.<name>``: ``profile_device`` (device and wall time of
each pipeline stage), ``eval_trocr_ckpt`` (a TrOCR checkpoint's held-out
score), ``diag_tracks`` (every merged text track of the verify clip),
``update_report`` (a report's end-to-end and TrOCR sections, refreshed)
and ``r5_promote`` (a training run's TrOCR candidates scored, the best
promoted).
"""
