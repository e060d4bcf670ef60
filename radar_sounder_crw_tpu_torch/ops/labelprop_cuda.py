"""The hand-written CUDA propagation kernels: build, bind, launch.

  * `prop_step` (csrc/prop_step.cu) replaces the Pallas TPU kernel
    `_prop_step_kernel`: one frame for all N queries, in two steps, a
    (query tile x candidate chunk) grid of block top-k lists and their
    merge with the weighted label sum.
  * `prop_seq` (csrc/prop_seq.cu) replaces `_prop_seq_v2_kernel`: the
    whole (B, T-1) propagation of a batch of radargrams, in two phases,
    every frame's winners at once (`prop_seq_select`) and the label chain
    (`prop_seq_chain`).
  * `prop_all` (csrc/prop_all.cu) replaces `_prop_all_kernel`: the same
    propagation with the resident kernel's weight arithmetic, in the same
    two launches: every frame's selection with an epilogue that writes each
    list's normalised weights in candidate-row order (`prop_all_weights`),
    and a chain of weighted sums alone (`prop_all_chain`).
(all in radar_sounder_crw_tpu/ops/labelprop_pallas.py). All three run the
tile core of csrc/prop_tile.cuh; `prop_seq` and `prop_all` instantiate the
same two kernels, csrc/prop_frames.cuh.

Each source is registered with the port's one build (`ops/cuda_build.py`:
one `nvcc` a source for sm_90a, all at once, at first use, a plain C
interface loaded with ctypes, reused while the sources are unchanged). A
failed build or launch raises: nothing falls back to the plain version on
a CUDA tensor.
What a launch asks of the card (shared-memory limit, occupancy) is asked
once per process, device and shape.

On CPU tensors each wrapper runs its plain PyTorch twin
(`ops/labelprop._prop_step`, `propagate_seq_reference`,
`propagate_all_reference`, and for the phases `_chunk_lists`,
`_winners_all_frames`, `_weights_all_frames`, `_label_chain`); on CUDA
tensors it launches the kernel. `launches[name]` counts the wrapper calls
that launch kernel `name`: one per `prop_step`, `prop_seq` or `prop_all`
call, whatever the number of steps or phases inside it.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .labelprop import (
    _affinity,
    _chunk_lists,
    _label_chain,
    _weights_all_frames,
    _winners_all_frames,
)
from .labelprop import _prop_step as prop_step_reference
from .labelprop import propagate_all_reference, propagate_seq_reference

NAMES = ("prop_step", "prop_seq", "prop_all")
for _name in NAMES:
    cuda_build.register(_name, ("prop_common.cuh", "prop_tile.cuh", "prop_frames.cuh"))

TILE_QUERIES, TILE_ROWS = 64, 128  # csrc/prop_tile.cuh: kQ, kR
MAX_KNN = 256  # csrc/prop_tile.cuh: 32 * kMaxListChunks, for every kernel

launches = {name: 0 for name in NAMES}
_answers: dict[tuple, int] = {}
_pin_arrays: dict[tuple, torch.Tensor] = {}


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SEQ_SIGNATURES = {  # csrc/prop_frames.cuh, bound by prop_seq.cu and prop_all.cu
    "select_launch": ([_P] * 5 + [_I] * 6 + [_F] + [_I] * 3 + [_P], _I),
    "chain_launch": ([_P] * 3 + [_I] * 6 + [_P], _I),
    "select_smem_bytes": ([_I] * 2, _LL),
    "chain_smem_bytes": ([_I] * 5, _LL),
}
_COMMON = {"max_dynamic_smem": ([], _I), "max_classes": ([], _I),
           "error_string": ([_I], ctypes.c_char_p)}
SIGNATURES = {
    "prop_step": {
        "launch": ([_P] * 8 + [_I] * 3 + [_F] + [_I] * 5 + [_P], _I),
        "smem_bytes": ([_I], _LL),
        "wave": ([_I], _I),
        **_COMMON,
    },
    "prop_seq": {**_SEQ_SIGNATURES, **_COMMON},
    "prop_all": {**_SEQ_SIGNATURES, **_COMMON},
}


def _library(name: str) -> ctypes.CDLL:
    return cuda_build.library(name, SIGNATURES[name])


_on = cuda_build.on_device


def _ask(name: str, device: torch.device, fn: str, *args) -> int:
    """The answer of `{name}_{fn}(*args)` (a size, a limit, an occupancy),
    asked once per process, device and arguments."""
    key = (name, device.index, fn, args)
    if key not in _answers:
        with _on(device):
            _answers[key] = getattr(_library(name), f"{name}_{fn}")(*args)
    return _answers[key]


def _check(name, x, shape, device):
    if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous float32 tensor on {device}, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")


def _check_common(name: str, device: torch.device, knn: int, M: int) -> None:
    if knn < 1:
        raise ValueError(f"knn must be >= 1, got {knn}")
    max_classes = _ask(name, device, "max_classes")
    if not 1 <= M <= max_classes:
        raise ValueError(f"{name}: the class count must lie in [1, {max_classes}], got {M}")


def _pins(long_mem: tuple, device: torch.device) -> torch.Tensor:
    """long_mem as an int32 array on the card, uploaded once per process
    (an upload from pageable memory waits for the stream); never empty, so
    the kernel always gets a valid pointer."""
    key = (long_mem, device.index)
    if key not in _pin_arrays:
        _pin_arrays[key] = torch.tensor(list(long_mem) or [0], dtype=torch.int32, device=device)
    return _pin_arrays[key]


def _check_knn(knn: int) -> None:
    if not 1 <= knn <= MAX_KNN:
        raise ValueError(f"knn must lie in [1, {MAX_KNN}], got {knn}")


def _smem_limit(name: str, device: torch.device) -> int:
    limit = _ask(name, device, "max_dynamic_smem")
    if limit < 0:
        raise RuntimeError(f"{name}: cannot query the shared-memory limit")
    return limit


def _check_smem(name: str, device: torch.device, nbytes: int, what: str) -> None:
    if nbytes > _smem_limit(name, device):
        raise ValueError(f"{name}: {what} take {nbytes} bytes of shared memory, above the "
                         f"card's {_smem_limit(name, device)}")


_KERNEL_OF_ROUTE = {"cuda": "prop_step", "cuda_seq": "prop_seq", "cuda_resident": "prop_all"}


def fits(route: str, device: torch.device, T: int, N: int, M: int, knn: int, L: int,
         cxt: int) -> bool:
    """Whether the kernel behind `route` ('cuda', 'cuda_seq' or
    'cuda_resident') takes a propagation of T frames of N nodes and M
    classes with knn winners over L pinned and cxt ring slots on `device`:
    the limits `_check_knn`, `_check_common` and `_check_smem` enforce at
    launch, answered before one. A CPU device answers False without
    building or loading a library."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    name = _KERNEL_OF_ROUTE[route]
    if not 1 <= knn <= MAX_KNN or not 1 <= M <= _ask(name, device, "max_classes"):
        return False
    if T < 2:
        return True
    limit = _smem_limit(name, device)
    if name == "prop_step":
        return _ask(name, device, "smem_bytes", knn) <= limit
    ns_max = L + min(T - 1, cxt)
    return (_ask(name, device, "select_smem_bytes", knn, ns_max) <= limit
            and min(_ask(name, device, "chain_smem_bytes", T, N, M, knn, in_smem)
                    for in_smem in (1, 0)) <= limit)


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _vec4(C: int, *tensors) -> int:
    """1 when every row of C floats starts on 16 bytes (float4 and cp.async loads)."""
    return int(C % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in tensors))


def step_chunk_rows(N: int, knn: int, nslots: int, device) -> int:
    """Candidates per chunk of `prop_step`'s first step: tiles of TILE_ROWS
    rows dealt so that ceil(N / TILE_QUERIES) x chunks CTAs fill the card
    once (SMs x CTAs per SM) at this prefix."""
    wave = _ask("prop_step", torch.device(device), "wave", knn)
    if wave < 1:
        raise RuntimeError("prop_step: cannot size the launch")
    tiles = -(-(nslots * N) // TILE_ROWS)
    per_wave = max(1, wave // -(-N // TILE_QUERIES))
    return TILE_ROWS * -(-tiles // per_wave)


def _step_checks(feats, query, mask, slot_bias, knn: int, nslots: int):
    K, N, C = feats.shape
    dev = feats.device
    _check("feats", feats, (K, N, C), dev)
    _check("query", query, (N, C), dev)
    _check("mask", mask, (N, N), dev)
    _check("slot_bias", slot_bias, (K,), dev)
    if not 1 <= nslots <= K:
        raise ValueError(f"nslots must lie in [1, {K}], got {nslots}")
    _check_knn(knn)
    _check_smem("prop_step", dev, _ask("prop_step", dev, "smem_bytes", knn),
                f"the running lists of knn={knn}")


def _step_launch(feats, query, mask, slot_bias, labels, pred, temperature: float, knn: int,
                 nslots: int, chunk_rows: int):
    """Step 1 into fresh chunk lists, then step 2 into pred unless pred is
    None; returns the lists (values, indices), (N, n_chunks, knn) each."""
    _, N, C = feats.shape
    dev = feats.device
    lib = _library("prop_step")
    n_chunks = -(-(nslots * N) // chunk_rows)
    # one allocation for both lists: values (float32 bits) and indices
    lists = torch.empty((2, N, n_chunks, knn), dtype=torch.int32, device=dev)
    list_v, list_i = lists[0].view(torch.float32), lists[1]
    with _on(dev):
        err = lib.prop_step_launch(
            feats.data_ptr(), query.data_ptr(), mask.data_ptr(), slot_bias.data_ptr(),
            None if labels is None else labels.data_ptr(),
            None if pred is None else pred.data_ptr(), list_v.data_ptr(), list_i.data_ptr(),
            N, C, 0 if labels is None else labels.shape[-1], float(temperature), int(knn),
            int(nslots), int(chunk_rows), _vec4(C, feats, query), int(pred is not None),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, "prop_step", err)
    return list_v, list_i


def prop_step(feats, query, mask, slot_bias, labels, temperature: float, knn: int, nslots: int):
    """One propagation frame: feats (K, N, C), query (N, C), mask (N, N),
    slot_bias (K,), labels (K, N, M) -> pred (N, M), reading the first
    `nslots` slots. CPU tensors take the plain twin; CUDA tensors launch the
    kernel's two steps (block top-k lists, merge), counted as one launch;
    knn <= MAX_KNN."""
    if feats.device.type == "cpu":
        return prop_step_reference(
            feats, query, mask, slot_bias, labels, temperature, knn, nslots
        )
    K, N, C = feats.shape
    M = labels.shape[-1]
    dev = feats.device
    _step_checks(feats, query, mask, slot_bias, knn, nslots)
    _check("labels", labels, (K, N, M), dev)
    _check_common("prop_step", dev, knn, M)
    pred = torch.empty((N, M), dtype=torch.float32, device=dev)
    _step_launch(feats, query, mask, slot_bias, labels, pred, temperature, knn, nslots,
                 step_chunk_rows(N, knn, nslots, dev))
    launches["prop_step"] += 1
    return pred


def prop_step_tiles(feats, query, mask, slot_bias, temperature: float, knn: int, nslots: int,
                    chunk_rows: int):
    """`prop_step`'s first step alone, for tests and timing: each chunk of
    `chunk_rows` candidates' knn best (values, indices), (N, n_chunks, knn)
    each, in winner order, padded with (-inf, 2**31 - 1). CPU tensors take
    the plain twin (`_chunk_lists`); CUDA tensors launch step 1."""
    if feats.device.type == "cpu":
        flat = _affinity(feats[None], query[None], mask, slot_bias, temperature, nslots)
        vals, idx = _chunk_lists(flat, knn, chunk_rows)
        return vals[0], idx[0]
    _step_checks(feats, query, mask, slot_bias, knn, nslots)
    lists = _step_launch(feats, query, mask, slot_bias, None, None, temperature, knn, nslots,
                         chunk_rows)
    launches["prop_step"] += 1
    return lists


def unpack_sources(src, N: int):
    """The sources of `prop_seq_select` and `prop_all_weights` -> (frame f,
    node i); f = -1: no label."""
    return src // N - 1, src % N


# The whole-sequence kernels: name -> (twin of the whole propagation, twin
# of its lists, whether its chain sums weights only).
_WHOLE_SEQUENCE = {
    "prop_seq": (propagate_seq_reference, _winners_all_frames, False),
    "prop_all": (propagate_all_reference, _weights_all_frames, True),
}


def _seq_checks(emb, mask, knn: int, cxt: int):
    B, T, N, C = emb.shape
    dev = emb.device
    _check("emb", emb, (B, T, N, C), dev)
    _check("mask", mask, (N, N), dev)
    _check_knn(knn)
    if cxt < 1:
        raise ValueError(f"cxt must be >= 1, got {cxt}")


def _select_launch(name: str, emb, mask, long_mem: tuple, cxt: int, temperature: float,
                   knn: int):
    """Kernel `name`'s selection on CUDA tensors: (src, values),
    (B, T - 1, N, knn) each."""
    B, T, N, C = emb.shape
    dev = emb.device
    L = len(long_mem)
    ns_max = L + min(T - 1, cxt)
    _check_smem(name, dev, _ask(name, dev, "select_smem_bytes", knn, ns_max),
                f"the running lists of knn={knn}")
    src = torch.empty((B, T - 1, N, knn), dtype=torch.int32, device=dev)
    vals = torch.empty((B, T - 1, N, knn), dtype=torch.float32, device=dev)
    if T == 1 or B == 0:
        return src, vals
    pins = _pins(tuple(long_mem), dev)
    lib = _library(name)
    with _on(dev):
        err = getattr(lib, f"{name}_select_launch")(
            emb.data_ptr(), mask.data_ptr(), pins.data_ptr(), src.data_ptr(), vals.data_ptr(),
            B, T, N, C, L, int(cxt), float(temperature), int(knn), ns_max, _vec4(C, emb),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, name, err)
    return src, vals


def _chain_launch(name: str, src, vals, soft):
    """Kernel `name`'s chain on CUDA tensors: soft (B, T, N, M) frames 1..
    from the lists, frame 0 holding the seeds."""
    B, T, N, M = soft.shape
    knn = src.shape[-1]
    dev = soft.device
    if T == 1 or B == 0:
        return soft
    in_smem = int(_ask(name, dev, "chain_smem_bytes", T, N, M, knn, 1) <= _smem_limit(name, dev))
    if not in_smem:
        _check_smem(name, dev, _ask(name, dev, "chain_smem_bytes", T, N, M, knn, 0),
                    f"one frame's lists of N={N} x knn={knn}")
    lib = _library(name)
    with _on(dev):
        err = getattr(lib, f"{name}_chain_launch")(
            src.data_ptr(), vals.data_ptr(), soft.data_ptr(), B, T, N, M, knn, in_smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, name, err)
    return soft


def _seed_frame(name: str, seeds, B: int, T: int, N: int, knn: int, device: torch.device):
    """soft (B, T, N, M) on `device` with frame 0 the seeds, the rest to be
    written."""
    M = seeds.shape[-1]
    _check("seeds", seeds, (B, N, M), device)
    _check_common(name, device, knn, M)
    soft = torch.empty((B, T, N, M), dtype=torch.float32, device=device)
    soft[:, 0] = seeds
    return soft


def _whole_sequence(name: str, emb, seeds, mask, long_mem: tuple, cxt: int, temperature: float,
                    knn: int):
    """`prop_seq` or `prop_all`: the twin on CPU tensors, else the selection
    and the chain of kernel `name`, one count."""
    if emb.device.type == "cpu":
        return _WHOLE_SEQUENCE[name][0](emb, seeds, mask, long_mem, cxt, temperature, knn)
    B, T, N, _ = emb.shape
    _seq_checks(emb, mask, knn, cxt)
    soft = _seed_frame(name, seeds, B, T, N, knn, emb.device)
    if T == 1 or B == 0:
        return soft
    src, vals = _select_launch(name, emb, mask, tuple(long_mem), cxt, temperature, knn)
    _chain_launch(name, src, vals, soft)
    launches[name] += 1
    return soft


def _select(name: str, emb, mask, long_mem: tuple, cxt: int, temperature: float, knn: int):
    """Kernel `name`'s selection alone: (src, values); the lists' twin on
    CPU tensors."""
    N = emb.shape[2]
    if emb.device.type == "cpu":
        f, i, vals = _WHOLE_SEQUENCE[name][1](emb, mask, tuple(long_mem), cxt, temperature, knn)
        return ((f + 1) * N + i).to(torch.int32), vals
    _seq_checks(emb, mask, knn, cxt)
    lists = _select_launch(name, emb, mask, tuple(long_mem), cxt, temperature, knn)
    if emb.shape[1] > 1 and emb.shape[0] > 0:
        launches[name] += 1
    return lists


def _chain(name: str, src, vals, seeds):
    """Kernel `name`'s chain alone from its selection's lists; `_label_chain`
    on CPU tensors."""
    B, T1, N, knn = src.shape
    if src.device.type == "cpu":
        f, i = unpack_sources(src.long(), N)
        return _label_chain((f, i, vals), seeds, weights_only=_WHOLE_SEQUENCE[name][2])
    for what, x, dtype in (("src", src, torch.int32), ("values", vals, torch.float32)):
        if x.device != src.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{what}: need a contiguous {dtype} tensor on {src.device}")
    if vals.shape != src.shape:
        raise ValueError(f"values: expected shape {tuple(src.shape)}, got {tuple(vals.shape)}")
    soft = _seed_frame(name, seeds, B, T1 + 1, N, knn, src.device)
    _chain_launch(name, src, vals, soft)
    if T1 > 0 and B > 0:
        launches[name] += 1
    return soft


def prop_seq(emb, seeds, mask, long_mem: tuple, cxt: int, temperature: float, knn: int):
    """The whole propagation of a batch of radargrams: emb (B, T, N, C)
    L2-normalized, seeds (B, N, M), mask (N, N) -> soft (B, T, N, M), frame 0
    the seeds. CPU tensors take the plain twin; CUDA tensors launch the
    kernel's two phases (every frame's winners, then the label chain),
    counted as one launch (none when T == 1); knn <= MAX_KNN."""
    return _whole_sequence("prop_seq", emb, seeds, mask, long_mem, cxt, temperature, knn)


def prop_seq_select(emb, mask, long_mem: tuple, cxt: int, temperature: float, knn: int):
    """`prop_seq`'s phase A alone: every frame's winner lists (src, e),
    (B, T - 1, N, knn) each, in winner order, src = (f + 1) * N + i for node
    i of frame f (`unpack_sources`; f = -1 reads no label). CPU tensors take
    the plain twin (`_winners_all_frames`); CUDA tensors launch phase A (one
    count of `prop_seq`)."""
    return _select("prop_seq", emb, mask, long_mem, cxt, temperature, knn)


def prop_seq_chain(src, e, seeds):
    """`prop_seq`'s phase B alone: the label chain from `prop_seq_select`'s
    lists and seeds (B, N, M) -> soft (B, T, N, M). CPU tensors take the
    plain twin (`_label_chain`); CUDA tensors launch phase B (one count of
    `prop_seq`)."""
    return _chain("prop_seq", src, e, seeds)


def prop_all(emb, seeds, mask, long_mem: tuple, cxt: int, temperature: float, knn: int):
    """`prop_seq` with the weight arithmetic of the TPU resident kernel
    (ops/labelprop._prop_all_step_batched): same arguments and result.
    CPU tensors take the plain twin `propagate_all_reference`; CUDA tensors
    launch the kernel's steps (every frame's selection with its weights in
    row order, then the weights-only chain), counted as one launch (none
    when T == 1); knn <= MAX_KNN."""
    return _whole_sequence("prop_all", emb, seeds, mask, long_mem, cxt, temperature, knn)


def prop_all_weights(emb, mask, long_mem: tuple, cxt: int, temperature: float, knn: int):
    """`prop_all`'s steps 1 and 2 alone: every frame's lists (src, w),
    (B, T - 1, N, knn) each, src as `prop_seq_select`'s, w_j = e_j / den with
    den summed in winner order, the entries in ascending candidate row and
    the padding last. CPU tensors take the plain twin
    (`_weights_all_frames`); CUDA tensors launch the selection (one count of
    `prop_all`)."""
    return _select("prop_all", emb, mask, long_mem, cxt, temperature, knn)


def prop_all_chain(src, w, seeds):
    """`prop_all`'s step 3 alone: the weights-only label chain from
    `prop_all_weights`' lists and seeds (B, N, M) -> soft (B, T, N, M). CPU
    tensors take the plain twin (`_label_chain(..., weights_only=True)`);
    CUDA tensors launch the chain (one count of `prop_all`)."""
    return _chain("prop_all", src, w, seeds)
