"""Inference entry points of the port: detector, recognizer, video
pipeline and the multi-stream engine."""
from .detector import TextDetector
from .engine import InferenceEngine
from .pipeline import VideoTextPipeline
from .recognizer import TextRecognizer

__all__ = [
    "InferenceEngine", "TextDetector", "TextRecognizer", "VideoTextPipeline",
]
