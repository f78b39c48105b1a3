"""Core of the port: settings, result schemas, devices and the mesh.

``Settings`` and ``settings`` are imported on first use, not with the
package: ``settings`` reads the environment when ``core/config.py`` is
imported, and ``serve`` / ``worker`` set ``DEVICE`` for their children
after modules such as ``core.device`` are imported.
"""
from .schemas import (
    Detection,
    FrameResult,
    PipelineSummary,
    RecognizedRegion,
    VideoResult,
)

__all__ = [
    "Settings",
    "settings",
    "Detection",
    "RecognizedRegion",
    "FrameResult",
    "PipelineSummary",
    "VideoResult",
]


def __getattr__(name):
    if name in ("Settings", "settings"):
        from . import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
