"""K7 and K10: per-root counts of active pixels, and the speckle filter's
size decision and apply around them (`csrc/histogram.cu`).

Replace `rt_depth_map_tpu/ops/pallas/histogram.py` `label_histogram_banded`
(K7, the speckle filter's size decision) and `label_histogram_pallas` (K10,
exact component sizes). The TPU counts with one-hot matmuls on the MXU, K7
only inside a band around each root; Hopper has atomics. A block of the
counting kernel owns a tile of `HIST_TILE` consecutive pixels: a warp merges
its lanes' runs of one label, the block adds them to a small hash table in
shared memory, and flushes one global atomic per distinct root. The counts
are exact, which satisfies K7's contract (exact for the decision
count <= max_size) as well as K10's. At 1280x720 the speckle entry's memset,
count and decision take about 0.008 ms of device time against a 0.0025 ms
byte bound: each operation's start and drain, more than its bytes, sets its
time (`tools/time_torch_lr_speckle.py --ablate`, `PERF.md` §6).

Entry points, each launching for CUDA tensors and running its plain version
for CPU tensors (any other device raises):

- `label_histogram_banded` (K7's contract) and `label_histogram` (K10's):
  the counts, one memset and one launch, counted apart;
- `speckle_decision`: the int32 field that K2 broadcasts in the speckle
  filter (`ops/cc.py` `component_small_field`): at a root, whether its count
  exceeds max_size (1) or not (0); BIG elsewhere. A memset, the count, and
  the decision in place over the counts;
- `speckle_apply`: the filter's last step, new_val where the pixel is
  active (disp != new_val) and its broadcast decision is 0; one launch.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import BIG

#: pixels of a counting block's tile: one step of its 256 threads, 4
#: pixels each (a multiple of 4)
HIST_TILE = 1024


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


def speckle_decision_plain(labels: torch.Tensor, active: torch.Tensor,
                           max_size: int) -> torch.Tensor:
    """(H, W) int32: at a root (active, labels[p] == p) 1 if its count is
    above max_size, else 0; BIG elsewhere."""
    H, W = labels.shape
    counts = label_histogram_plain(labels, active)
    idx = torch.arange(H * W, dtype=torch.int32, device=labels.device).reshape(H, W)
    is_root = active & (labels == idx)
    field = torch.where(is_root, (counts > max_size).to(torch.int32), BIG)
    return field.to(torch.int32).contiguous()


def speckle_apply_plain(disp: torch.Tensor, field: torch.Tensor,
                        new_val: int) -> torch.Tensor:
    """(H, W) int16: new_val where disp != new_val and field == 0, else disp."""
    small = (disp != new_val) & (field == 0)
    return torch.where(small, torch.full_like(disp, new_val), disp)


def _fn(entry: str, argtypes):
    lib = _build.load("histogram")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _build.I
    return lib, fn


def _count(entry: str, labels: torch.Tensor, active: torch.Tensor,
           *extra) -> torch.Tensor:
    """Launch `entry` (rtdm_label_histogram or rtdm_speckle_decision) into a
    new (H, W) int32 tensor."""
    H, W = labels.shape
    _build.require(labels, "labels", torch.int32)
    _build.require(active, "active", torch.bool, (H, W))
    out = torch.empty((H, W), dtype=torch.int32, device=labels.device)
    P, I = _build.P, _build.I
    lib, fn = _fn(entry, [P, P, I, I] + [I] * len(extra) + [P, P])
    with torch.cuda.device(labels.device):
        err = fn(labels.data_ptr(), active.data_ptr(), H * W, HIST_TILE,
                 *extra, out.data_ptr(), _build.stream_of(labels))
    _build.check(lib, err, entry)
    return out


def label_histogram_banded(labels: torch.Tensor, active: torch.Tensor,
                           max_size: int) -> torch.Tensor:
    """K7: (H, W) int32 per-root counts, addressed at the root, exact for the
    decision count <= max_size (here: exact). labels: (H, W) int32
    min-linear-index labels, in [0, H * W) where active."""
    del max_size  # the counts are exact for every size
    if not _build.on_card(labels, "label_histogram_banded"):
        return label_histogram_plain(labels, active)
    out = _count("rtdm_label_histogram", labels, active)
    label_histogram_banded.launches += 1
    return out


def label_histogram(labels: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """K10: (H, W) int32 exact per-root sizes, addressed at the root."""
    if not _build.on_card(labels, "label_histogram"):
        return label_histogram_plain(labels, active)
    out = _count("rtdm_label_histogram", labels, active)
    label_histogram.launches += 1
    return out


def speckle_decision(labels: torch.Tensor, active: torch.Tensor,
                     max_size: int) -> torch.Tensor:
    """K7 with the speckle filter's decision: `speckle_decision_plain`."""
    if not _build.on_card(labels, "speckle_decision"):
        return speckle_decision_plain(labels, active, max_size)
    out = _count("rtdm_speckle_decision", labels, active, max_size)
    speckle_decision.launches += 1
    return out


def speckle_apply(disp: torch.Tensor, field: torch.Tensor,
                  new_val: int) -> torch.Tensor:
    """The speckle filter's last step: `speckle_apply_plain`."""
    if not _build.on_card(disp, "speckle_apply"):
        return speckle_apply_plain(disp, field, new_val)
    H, W = disp.shape
    _build.require(disp, "disp", torch.int16)
    _build.require(field, "field", torch.int32, (H, W))
    out = torch.empty_like(disp)
    P, I = _build.P, _build.I
    lib, fn = _fn("rtdm_speckle_apply", [P, P, I, I, P, P])
    with torch.cuda.device(disp.device):
        err = fn(disp.data_ptr(), field.data_ptr(), H * W, new_val,
                 out.data_ptr(), _build.stream_of(disp))
    _build.check(lib, err, "speckle_apply")
    speckle_apply.launches += 1
    return out


label_histogram_banded.launches = 0
label_histogram.launches = 0
speckle_decision.launches = 0
speckle_apply.launches = 0
