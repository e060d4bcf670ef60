"""Dataset registry: the integer ids of the upstream CLI.

  dataset 0 = MCoRDS1, 1 = MCORDS3 / "Miguel" (concatenated, trimmed),
          3 = SHARAD
  reference 0 = MCoRDS1 SG2 (4 cls), 1 = Miguel seg3 (6 cls, trimmed),
            2 = MCoRDS1 SG3 with an uncertain class, 3 = SHARAD sg5 (5 cls)

Real data products are looked up under $RSCRW_DATA_ROOT, then the upstream
default roots; when absent, a deterministic synthetic radargram and
segmentation of the same geometry stand in, with a printed notice.
RSCRW_SYNTH_SCALE=k shrinks the synthetic width by k (not Miguel's, whose
trim offsets are absolute).

A copy of radar_sounder_crw_tpu/data/registry.py.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .radargram import RGWindows, load_radargram, trim_miguel
from .synthetic import synthetic_radargram

_MIGUEL_W = 9984 + 6656 + 9984 + 20000 + 16640 + 32864 + 8992  # = 105120


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    rg_paths: tuple[str, ...]  # candidate radargram files (first hit wins)
    seg_paths: tuple[str, ...]
    nclasses: int
    trim: bool  # apply trim_miguel to both rg and seg
    synth_shape: tuple[int, int]
    synth_seed: int


DATASETS: dict[int, DatasetSpec] = {
    0: DatasetSpec(
        name="MCORDS1",
        rg_paths=("MCoRDS1_2010_DC8/RG2_MCoRDS1_2010_DC8.pt",),
        seg_paths=("MCoRDS1_2010_DC8/SG2_MCoRDS1_2010_DC8.pt",),
        nclasses=4,
        trim=False,
        synth_shape=(410, 27330),
        synth_seed=10,
    ),
    1: DatasetSpec(
        name="MCORDS3",
        rg_paths=("MCORDS1_Miguel/rg2.pt",),
        seg_paths=("MCORDS1_Miguel/seg3.pt",),
        nclasses=6,
        trim=True,
        synth_shape=(410, _MIGUEL_W),
        synth_seed=11,
    ),
    3: DatasetSpec(
        name="SHARAD",
        rg_paths=("SHARAD/sharad_north_rg.pt",),
        seg_paths=("SHARAD/sharad_north_sg5.pt",),
        nclasses=5,
        trim=False,
        synth_shape=(912, 8192),
        synth_seed=13,
    ),
}

_synth_cache: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}


def _data_roots() -> list[str]:
    roots = []
    env = os.environ.get("RSCRW_DATA_ROOT")
    if env:
        roots.append(env)
    roots += ["/datasets", "/data"]
    return roots


def _find(paths: tuple[str, ...]) -> str | None:
    for root in _data_roots():
        for rel in paths:
            p = os.path.join(root, rel)
            if os.path.exists(p):
                return p
    return None


def _synth_pair(dataset_id: int) -> tuple[np.ndarray, np.ndarray]:
    scale = int(os.environ.get("RSCRW_SYNTH_SCALE", "1"))
    key = (dataset_id, scale)
    if key not in _synth_cache:
        spec = DATASETS[dataset_id]
        H, W = spec.synth_shape
        if scale > 1 and not spec.trim:
            W = max(W // scale, 1024)
        _synth_cache[key] = synthetic_radargram(
            H=H, W=W, nclasses=spec.nclasses, seed=spec.synth_seed
        )
    return _synth_cache[key]


def _load_rg(dataset_id: int) -> np.ndarray:
    spec = DATASETS[dataset_id]
    path = _find(spec.rg_paths)
    if path is not None:
        return load_radargram(path)
    print(f"[registry] {spec.name}: real data not found; using synthetic radargram")
    return _synth_pair(dataset_id)[0]


def create_dataset(
    id: int,
    length: int,
    dim: tuple[int, int],
    overlap: tuple[int, int],
    full: bool = False,
    flip: bool = False,
):
    """The windowed dataset for a dataset id; with full=False, the
    stride-`length` non-overlapping subset of its windows."""
    if id not in DATASETS:
        raise ValueError(f"unknown dataset id {id} (valid: {sorted(DATASETS)})")
    spec = DATASETS[id]
    ds = RGWindows(
        _load_rg(id),
        length=length,
        dim=dim,
        overlap=overlap,
        flip=flip,
        trim_miguel_splits=spec.trim,
    )
    if full:
        return ds
    return SubsetWindows(ds, list(range(0, len(ds), length)))


class SubsetWindows:
    """Index-subset view over RGWindows."""

    def __init__(self, dataset: RGWindows, indices: list[int]):
        self.dataset = dataset
        self.indices = indices
        self.geo = dataset.geo

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.dataset[self.indices[i]]

    def get_smaller_item(self, i: int, small_length: int) -> np.ndarray:
        return self.dataset.get_smaller_item(self.indices[i], small_length)

    def batch(self, idxs, length=None) -> np.ndarray:
        return self.dataset.batch([self.indices[i] for i in idxs], length)


def load_raw_pair(dataset_id: int) -> tuple[np.ndarray, np.ndarray]:
    """(radargram, segmentation) for a dataset id: the real files when the
    data root has both, the synthetic pair otherwise."""
    spec = DATASETS[dataset_id]
    rg_path, seg_path = _find(spec.rg_paths), _find(spec.seg_paths)
    _check_ref_pair(dataset_id, seg_path is not None)
    if rg_path is not None and seg_path is not None:
        return (
            np.asarray(load_radargram(rg_path)),
            np.asarray(load_radargram(seg_path)),
        )
    rg, seg = _synth_pair(dataset_id)
    return rg.copy(), seg.copy()


def _check_ref_pair(dataset_id: int, seg_found: bool) -> None:
    """Refuse a half-populated data root (a real radargram without its
    segmentation or the reverse); print the fallback notice when both
    sides are synthetic."""
    spec = DATASETS[dataset_id]
    rg_found = _find(spec.rg_paths) is not None
    if rg_found != seg_found:
        have, miss = (
            ("radargram", "segmentation")
            if rg_found
            else ("segmentation", "radargram")
        )
        raise ValueError(
            f"data root provides the real {spec.name} {have} but not the "
            f"real {miss} — mixing real data with the synthetic fallback "
            f"produces meaningless evaluations; add the missing {miss} file "
            f"or remove the {have}"
        )
    if not seg_found:
        print(
            f"[registry] {spec.name}: real segmentation not found; "
            "using synthetic"
        )


def get_reference(
    id: int,
    h: int,
    w: int,
    flip: bool = False,
    length: int | None = None,
    dim: tuple[int, int] | None = None,
) -> tuple[int, np.ndarray]:
    """(nclasses, segmentation) for a reference id. w == 0 returns all
    columns; id 2 carries an extra 'uncertain' label (4); length and dim feed
    the Miguel trim (id 1) only."""
    if id in (0, 2):
        path = _find(
            DATASETS[0].seg_paths
            if id == 0
            else ("MCoRDS1_2010_DC8/SG3_MCoRDS1_2010_DC8.pt",)
        )
        _check_ref_pair(0, path is not None)
        if path is not None:
            seg = np.asarray(load_radargram(path))
        else:
            seg = _synth_pair(0)[1].copy()
            if id == 2:
                seg = _with_uncertain_band(seg, uncertain_label=4)
        nclasses = 4
    elif id == 1:
        spec = DATASETS[1]
        path = _find(spec.seg_paths)
        _check_ref_pair(1, path is not None)
        seg = (
            np.asarray(load_radargram(path))
            if path is not None
            else _synth_pair(1)[1].copy()
        )
        if length is None or dim is None:
            raise ValueError("reference id 1 needs length and dim for the Miguel trim")
        seg = trim_miguel(seg, length, dim)
        nclasses = 6
    elif id == 3:
        spec = DATASETS[3]
        path = _find(spec.seg_paths)
        _check_ref_pair(3, path is not None)
        seg = (
            np.asarray(load_radargram(path))
            if path is not None
            else _synth_pair(3)[1].copy()
        )
        nclasses = 5
    else:
        raise ValueError(f"unknown reference id {id}")
    seg = seg[:h, :] if w == 0 else seg[:h, :w]
    if flip:
        seg = seg[:, ::-1]
    return nclasses, np.ascontiguousarray(seg)


def _with_uncertain_band(seg: np.ndarray, uncertain_label: int, width: int = 4) -> np.ndarray:
    """Mark pixels near class boundaries as 'uncertain' (synthetic id 2)."""
    out = seg.copy()
    edge = np.zeros_like(seg, dtype=bool)
    edge[:-1, :] |= seg[:-1, :] != seg[1:, :]
    edge[1:, :] |= seg[:-1, :] != seg[1:, :]
    grown = edge.copy()
    for _ in range(width - 1):
        g = np.zeros_like(grown)
        g[:-1, :] |= grown[1:, :]
        g[1:, :] |= grown[:-1, :]
        grown |= g
    out[grown] = uncertain_label
    return out
