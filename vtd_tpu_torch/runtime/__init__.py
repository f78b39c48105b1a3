"""Inference entry points of the port: detector, recognizer, video pipeline."""
from .detector import TextDetector
from .pipeline import VideoTextPipeline
from .recognizer import TextRecognizer

__all__ = ["TextDetector", "TextRecognizer", "VideoTextPipeline"]
