"""K7 and K10: per-root counts of active pixels (`csrc/histogram.cu`).

Replace `rt_depth_map_tpu/ops/pallas/histogram.py` `label_histogram_banded`
(K7, the speckle filter's size decision) and `label_histogram_pallas` (K10,
exact component sizes). The TPU counts with one-hot matmuls on the MXU, K7
only inside a band around each root; Hopper has atomics, so one kernel adds
each active pixel to its root's counter (warp-aggregated over lanes with the
same label). The counts are exact, which satisfies K7's contract (exact for
the decision count <= max_size) as well as K10's. The two entry points share
the source and count their launches apart. The kernel is bound by device
memory bytes.

`label_histogram_banded` and `label_histogram` launch the kernel for CUDA
tensors and run `label_histogram_plain` for CPU tensors; any other device
raises.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build


def label_histogram_plain(labels: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 A with A[y, x] = #{active p : labels[p] == y * W + x}."""
    H, W = labels.shape
    flat = labels.reshape(-1).long()
    ones = active.reshape(-1).to(torch.int32)
    target = torch.where(active.reshape(-1), flat, H * W)  # inactive: a spare bin
    counts = torch.zeros(H * W + 1, dtype=torch.int32, device=labels.device)
    counts.scatter_add_(0, target, ones)
    return counts[: H * W].reshape(H, W)


def _fn():
    lib = _build.load("histogram")
    fn = lib.rtdm_label_histogram
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, I, P, P]
        fn.restype = I
    return lib, fn


def _launch(labels: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    H, W = labels.shape
    _build.require(labels, "labels", torch.int32)
    _build.require(active, "active", torch.bool, (H, W))
    counts = torch.empty((H, W), dtype=torch.int32, device=labels.device)
    lib, fn = _fn()
    with torch.cuda.device(labels.device):
        err = fn(labels.data_ptr(), active.data_ptr(), H * W,
                 counts.data_ptr(), _build.stream_of(labels))
    _build.check(lib, err, "label_histogram")
    return counts


def label_histogram_banded(labels: torch.Tensor, active: torch.Tensor,
                           max_size: int) -> torch.Tensor:
    """K7: (H, W) int32 per-root counts, addressed at the root, exact for the
    decision count <= max_size (here: exact). labels: (H, W) int32
    min-linear-index labels, in [0, H * W) where active."""
    del max_size  # the counts are exact for every size
    if labels.device.type == "cpu":
        return label_histogram_plain(labels, active)
    if labels.device.type != "cuda":
        raise ValueError(f"label_histogram_banded: unsupported device {labels.device}")
    out = _launch(labels, active)
    label_histogram_banded.launches += 1
    return out


def label_histogram(labels: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """K10: (H, W) int32 exact per-root sizes, addressed at the root."""
    if labels.device.type == "cpu":
        return label_histogram_plain(labels, active)
    if labels.device.type != "cuda":
        raise ValueError(f"label_histogram: unsupported device {labels.device}")
    out = _launch(labels, active)
    label_histogram.launches += 1
    return out


label_histogram_banded.launches = 0
label_histogram.launches = 0
