"""Host-side video decode and image helpers of the port."""
from .processor import AnnotationProcessor, ImageProcessor, VideoProcessor

__all__ = ["VideoProcessor", "ImageProcessor", "AnnotationProcessor"]
