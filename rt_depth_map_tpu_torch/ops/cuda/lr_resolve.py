"""K6: left-right consistency resolution (`csrc/lr_resolve.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/lr_resolve.py` `lr_resolve_pallas`,
with its general signature (n_w, r_lo, n_r, Dpow, c0, invalid) so that the
SGM LR check can reuse it. The TPU kernel runs both steps as shift-reduces
over every candidate disparity; on the H100 the winner step is a scatter with
shared-memory `atomicMin` on one row per block (min is order-independent, so
the result is deterministic) and the read-back a gather, O(1) work per pixel.
It is bounded by device memory bytes.

`lr_resolve` launches the kernel for CUDA tensors and runs
`lr_resolve_plain` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build

BIGKEY = 2**31 - 1


def lr_resolve_plain(d_match: torch.Tensor, key: torch.Tensor, rms: tuple, *,
                     n_w: int, r_lo: int, n_r: int, Dpow: int, c0: int,
                     invalid: int):
    """Read-back planes (one per rm in `rms`), with torch scatter/gather."""
    H, W = d_match.shape
    dev = d_match.device
    xs = torch.arange(W, dtype=torch.int64, device=dev)
    ys = torch.arange(H, dtype=torch.int64, device=dev)[:, None]
    dm = d_match.long()
    x2 = xs - dm
    cand = (dm >= 0) & (dm < n_w) & (x2 >= 0)
    target = torch.where(cand, ys * W + x2, H * W).reshape(-1)
    best = torch.full((H * W + 1,), BIGKEY, dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, target, key.reshape(-1).to(torch.int32),
                               "amin", include_self=True)[: H * W].reshape(H, W)
    disp2 = torch.where(best != BIGKEY, (best & (Dpow - 1)) + c0, invalid)
    outs = []
    for rm in rms:
        r = rm.long()
        src = xs - r
        ok = (r >= r_lo) & (r < r_lo + n_r) & (src >= 0) & (src < W)
        vals = torch.gather(disp2, 1, src.clamp(0, W - 1))
        outs.append(torch.where(ok, vals, invalid).to(torch.int32))
    return tuple(outs)


def _fn():
    lib = _build.load("lr_resolve")
    fn = lib.rtdm_lr_resolve
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, P, I, I, I, I, I, I, I, I, I, P, P]
        fn.restype = I
    return lib, fn


def lr_resolve(d_match: torch.Tensor, key: torch.Tensor, rms: tuple, *,
               n_w: int, r_lo: int, n_r: int, Dpow: int, c0: int,
               invalid: int):
    """Read-back planes, one (H, W) int32 per rm in `rms`.

    d_match/key: (H, W) int32 candidate-disparity and packed-key planes (key
    already 2^31-1 at non-candidates). The winner search runs over dd in
    [0, n_w); the read-back over dd in [r_lo, r_lo + n_r), and pixels whose
    rm lies outside that range, or whose x - rm leaves the row, get
    `invalid`. Dpow must be a power of two."""
    if Dpow <= 0 or Dpow & (Dpow - 1):
        raise ValueError("Dpow must be a power of two")
    if d_match.device.type == "cpu":
        return lr_resolve_plain(d_match, key, rms, n_w=n_w, r_lo=r_lo,
                                n_r=n_r, Dpow=Dpow, c0=c0, invalid=invalid)
    if d_match.device.type != "cuda":
        raise ValueError(f"lr_resolve: unsupported device {d_match.device}")
    H, W = d_match.shape
    _build.require(d_match, "d_match", torch.int32)
    _build.require(key, "key", torch.int32, (H, W))
    for i, rm in enumerate(rms):
        _build.require(rm, f"rms[{i}]", torch.int32, (H, W))
    stacked = torch.stack(list(rms)) if len(rms) > 1 else rms[0][None]
    out = torch.empty((len(rms), H, W), dtype=torch.int32, device=d_match.device)
    lib, fn = _fn()
    with torch.cuda.device(d_match.device):
        err = fn(d_match.data_ptr(), key.data_ptr(), stacked.data_ptr(),
                 len(rms), H, W, n_w, r_lo, n_r, Dpow, c0, invalid,
                 out.data_ptr(), _build.stream_of(d_match))
    lr_resolve.launches += 1
    _build.check(lib, err, "lr_resolve")
    return tuple(out.unbind(0))


lr_resolve.launches = 0
