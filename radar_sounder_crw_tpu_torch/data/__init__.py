from .patchify import GridGeometry, extract_window, unfold2d, window_geometry
from .synthetic import synthetic_radargram

__all__ = [
    "GridGeometry",
    "extract_window",
    "synthetic_radargram",
    "unfold2d",
    "window_geometry",
]
