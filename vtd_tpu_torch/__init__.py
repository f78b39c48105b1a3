"""vtd_tpu_torch — the PyTorch/CUDA port of ``vtd_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference, with the same module names so
that each counterpart is easy to find. It imports ``torch``, numpy and the
standard library only; ``cv2`` is imported lazily inside the functions
that decode video or convert colour on the host.

Ported so far: the CRNN video path (I420 -> BGR, resize/normalise, DBNet
probability branch, DB postprocess, box crop, CRNN + greedy CTC, host
assembly). The one TPU kernel on that path, ``segmented_cc_round``, is a
hand-written CUDA kernel (``csrc/segmented_cc.cu``) with a plain PyTorch
twin (``ops/cc_kernels.py``).

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; they raise when CUDA is absent instead of falling back.
"""

__version__ = "0.1.0"
