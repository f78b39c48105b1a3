"""vtd_tpu_torch — the PyTorch/CUDA port of ``vtd_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference, with the same module names so
that each counterpart is easy to find. It imports ``torch``, numpy and the
standard library only; ``cv2`` is imported lazily inside the functions
that decode video or convert colour on the host.

Ported so far: the CRNN video path (I420 -> BGR, resize/normalise, DBNet
probability branch, DB postprocess, box crop, CRNN + greedy CTC, host
assembly), the TrOCR engine (``models/trocr.py``,
``runtime/trocr_runtime.py``, the transformer branch of the pipeline) and
temporal dedup (``ops/nms.py``). Both TPU kernels of the reference are
hand-written CUDA kernels with plain PyTorch twins in
``ops/cc_kernels.py``: ``segmented_cc_round`` (``csrc/segmented_cc.cu``,
the labelling rounds of the video paths) and ``neighbor_min_sweeps``
(``csrc/neighbor_min_sweeps.cu``, the dense labelling backends). Since
the fourth slice: training on one card (``train/``: the DB loss and
label maps, ``ModelTrainer``, ``RecognizerTrainer``, ``TrOCRTrainer``)
and the command line (``python -m vtd_tpu_torch process | train-*``).
Since the fifth: the REST service (``serve/``, ``obs/``,
``core/config.py``, ``python -m vtd_tpu_torch serve``) with its
in-process thread worker, and keyframe sampling through the cv2 gate.
Since the sixth: the serving fleet (the file and TCP brokers,
``python -m vtd_tpu_torch brokerd | worker``, the process pool, the API
client) and the ``torch.profiler`` trace behind ``profile_dir``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; they raise when CUDA is absent instead of falling back.
"""

__version__ = "0.1.0"
