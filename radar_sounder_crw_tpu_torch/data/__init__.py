from .device_windows import gather_windows, resident_source, window_index_arrays
from .patchify import GridGeometry, extract_window, unfold2d, window_geometry
from .radargram import ConcatWindows, RGWindows, load_radargram, trim_miguel
from .torch_pt import load_pt, save_pt
from .registry import DATASETS, SubsetWindows, create_dataset, get_reference, load_raw_pair
from .synthetic import synthetic_radargram

__all__ = [
    "DATASETS",
    "ConcatWindows",
    "GridGeometry",
    "RGWindows",
    "SubsetWindows",
    "create_dataset",
    "extract_window",
    "gather_windows",
    "get_reference",
    "load_radargram",
    "load_pt",
    "load_raw_pair",
    "resident_source",
    "save_pt",
    "synthetic_radargram",
    "trim_miguel",
    "unfold2d",
    "window_geometry",
    "window_index_arrays",
]
