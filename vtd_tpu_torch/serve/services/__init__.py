from .video_service import VideoService
from .storage_service import StorageService
from .processing_service import ProcessingService

__all__ = ["VideoService", "StorageService", "ProcessingService"]
