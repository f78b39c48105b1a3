"""End-to-end examples of the port, each run as ``python -m
vtd_tpu_torch.examples.<name>``: ``verify_checkpoints`` (the shipped
checkpoints read the verify clip) and ``train_and_verify`` (train DBNet
and the CRNN from scratch, then read the clip).
"""
