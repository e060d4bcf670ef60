"""The yardstick's arithmetic: operations and bytes of the work the cells
drive, computed from shapes, and the published peaks of the chip.

Operations are multiply-adds counted twice, as torch.utils.flop_counter
counts matrix products and convolutions; elementwise work is not counted.
The propagation counts are frozen copies of the program's smoke-run
arithmetic (one step: the affinity products, mask, bias and temperature
over every candidate, and the weighted label sum; the selection's compares
are not counted; bytes are each input read once and the output written
once).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 off)
PEAK_BYTES = 3.35e12  # HBM3


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def resnet10_layers(h: int = 16, w: int = 16, in_ch: int = 1, embed_dim: int = 128):
    """[(name, c_in, c_out, k, out_h, out_w)] of the ResNet-10 encoder's
    convolutions and its head (k = 1, 1 x 1 output) on an h x w patch."""
    layers = []
    H, W = h + 2, w + 2  # the 1 x 1 stem with padding 1
    layers.append(("fc0", in_ch, 3, 1, H, W))
    H, W = _conv_out(H, 7, 2, 3), _conv_out(W, 7, 2, 3)
    layers.append(("conv1", 3, 64, 7, H, W))
    H, W = _conv_out(H, 3, 2, 1), _conv_out(W, 3, 2, 1)
    inplanes = 64
    for s, planes in enumerate((64, 128, 256, 512)):
        stride = 1 if s == 0 else 2
        H, W = _conv_out(H, 3, stride, 1), _conv_out(W, 3, stride, 1)
        layers.append((f"layer{s + 1}.conv1", inplanes, planes, 3, H, W))
        layers.append((f"layer{s + 1}.conv2", planes, planes, 3, H, W))
        if s > 0:
            layers.append((f"layer{s + 1}.downsample", inplanes, planes, 1, H, W))
        inplanes = planes
    layers.append(("fc", inplanes, embed_dim, 1, 1, 1))
    return layers


def encoder_flops(h: int = 16, w: int = 16, backward: bool = False) -> int:
    """Operations of one patch through the encoder; with backward, the
    forward plus the weight and input gradients of every layer but the
    stem's input gradient (the patches need none)."""
    per = [2 * ci * co * k * k * oh * ow for _, ci, co, k, oh, ow in resnet10_layers(h, w)]
    fwd = sum(per)
    return 3 * fwd - per[0] if backward else fwd


def crw_loss_flops(B: int, T: int, N: int, C: int = 128) -> int:
    """Operations of the CRW loss forward and backward as the program
    computes it: the affinity products and the O(T) palindrome walk (two
    batched N x N products at depth 2, three at each deeper one); each
    product's backward is two products."""
    aff = 2 * B * (T - 1) * N * N * C
    n_bmm = 2 + 3 * (T - 4) if T >= 4 else 0
    return 3 * (aff + n_bmm * 2 * B * N ** 3)


def train_step_flops(B: int, T: int, N: int, h: int = 16, w: int = 16) -> int:
    return B * T * N * encoder_flops(h, w, backward=True) + crw_loss_flops(B, T, N)


def xent_flops(B: int, T: int, N: int, C: int = 128) -> int:
    """The horizontality metric's affinity products."""
    return 2 * B * (T - 1) * N * N * C


def step_flops_bytes(K, N, C, M, knn, nslots):
    """float32 operations and bytes of one propagation step over `nslots`
    valid context slots."""
    ops = 2 * nslots * N * N * C + 3 * nslots * N * N + 2 * N * knn * M
    nbytes = 4 * (nslots * N * C + N * C + N * N + K + nslots * N * M + N * M)
    return ops, nbytes


def seq_flops_bytes(B, T, N, C, M, knn, L, cxt):
    """float32 operations and bytes of one whole-sequence launch: the steps
    summed over every radargram's frames, each over its valid prefix
    L + min(t, cxt); bytes are the embeddings, seeds and mask read once and
    the soft labels written once."""
    ops = B * sum(step_flops_bytes(L + cxt, N, C, M, knn, L + min(t, cxt))[0]
                  for t in range(1, T))
    nbytes = 4 * (B * T * N * C + B * N * M + N * N + B * T * N * M)
    return ops, nbytes


def frames_flops_bytes(T, N, C, M, knn, L, cxt):
    """The per-frame route over one radargram of T frames: (ops, bytes)
    summed over its T - 1 step launches."""
    ops = nbytes = 0
    for t in range(1, T):
        o, b = step_flops_bytes(L + cxt, N, C, M, knn, L + min(t, cxt))
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the float32 peak
    or bytes at the memory peak, whichever is longer."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
