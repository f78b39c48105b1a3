"""The port's models: ResNet50, DBNet (FPN neck, DB head), CRNN and TrOCR."""
from .resnet import ResNet50
from .dbnet import DBNet, DBHead, FPNNeck
from .crnn import CRNN, CRNN_VOCAB, build_vocab

__all__ = [
    "ResNet50",
    "DBNet",
    "DBHead",
    "FPNNeck",
    "CRNN",
    "CRNN_VOCAB",
    "build_vocab",
]
