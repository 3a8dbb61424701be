"""K2: min-propagation of int32 fields along allowed edges (`csrc/cc_sweep.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/cc_sweep.py` `seg_min_propagate_pallas`,
with the round structure of the XLA loop in `rt_depth_map_tpu/ops/cc.py`
(hop for 8-connectivity, row run-min, column run-min per sweep; two sweeps
per trip; stop when a trip changes nothing or the sweep count reaches the
cap), so that the result matches the reference bit for bit even where the
cap stops propagation short of the fixed point.

On the H100 the work per sweep is small (a few passes over 4 fields of
1280x720 int32); what bounds it is the number of launches and the one
device-to-host flag read per trip. The kernel does every sweep of a trip
without the host and reads the "changed" flag once per trip.

`seg_min_propagate` launches the kernel for CUDA tensors and runs
`seg_min_propagate_plain` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build

BIG = 2**30
#: propagation sweeps when no cap is given (the fixed point is reached long
#: before on any image this port handles)
UNCAPPED = 2**30


def _run_min(f: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """Min over each run of `allowed` edges along the last axis.

    f: (N, H, L) int32; allowed: (H, L-1) bool, edge i ~ i+1."""
    N, H, L = f.shape
    starts = torch.ones((H, L), dtype=torch.bool, device=f.device)
    starts[:, 1:] = ~allowed
    seg = torch.cumsum(starts.expand(N, H, L).reshape(-1), 0) - 1
    flat = f.reshape(-1)
    mins = torch.full((int(N * H * L),), BIG, dtype=f.dtype, device=f.device)
    mins = mins.scatter_reduce(0, seg, flat, "amin", include_self=True)
    return mins[seg].reshape(N, H, L)


def _hop(f, active, allowed_h, allowed_v, allowed_se, allowed_sw):
    """Neighbour min across allowed edges, all read before the hop."""
    lab = torch.where(active, f, BIG)
    out = lab.clone()

    def take(dst, src_vals, mask):
        return torch.minimum(dst, torch.where(mask, src_vals, BIG))

    out[:, :, 1:] = take(out[:, :, 1:], lab[:, :, :-1], allowed_h)
    out[:, :, :-1] = take(out[:, :, :-1], lab[:, :, 1:], allowed_h)
    out[:, 1:] = take(out[:, 1:], lab[:, :-1], allowed_v)
    out[:, :-1] = take(out[:, :-1], lab[:, 1:], allowed_v)
    if allowed_se is not None:
        out[:, 1:, 1:] = take(out[:, 1:, 1:], lab[:, :-1, :-1], allowed_se)
        out[:, :-1, :-1] = take(out[:, :-1, :-1], lab[:, 1:, 1:], allowed_se)
        out[:, 1:, :-1] = take(out[:, 1:, :-1], lab[:, :-1, 1:], allowed_sw)
        out[:, :-1, 1:] = take(out[:, :-1, 1:], lab[:, 1:, :-1], allowed_sw)
    return torch.where(active, out, f)


def seg_min_propagate_plain(field: torch.Tensor, active: torch.Tensor,
                            allowed_h: torch.Tensor, allowed_v: torch.Tensor,
                            allowed_se: Optional[torch.Tensor] = None,
                            allowed_sw: Optional[torch.Tensor] = None,
                            max_rounds: Optional[int] = None) -> torch.Tensor:
    """The XLA while-loop of ops/cc.py written with torch ops."""
    squeeze = field.dim() == 2
    f = field[None] if squeeze else field
    f = f.to(torch.int32)
    cap = UNCAPPED if max_rounds is None else max_rounds

    def sweep(x):
        if allowed_se is not None:
            x = _hop(x, active, allowed_h, allowed_v, allowed_se, allowed_sw)
        x = _run_min(x, allowed_h)
        x = _run_min(x.transpose(1, 2).contiguous(),
                     allowed_v.t().contiguous()).transpose(1, 2).contiguous()
        return x

    rounds, changed = 0, True
    while changed and rounds < cap:
        new = sweep(sweep(f))
        changed = bool((new != f).any())
        f = new
        rounds += 2
    return f[0] if squeeze else f


def pack_edges(allowed_h, allowed_v, allowed_se=None, allowed_sw=None):
    """One uint8 per pixel: bit 0 (y,x)~(y,x+1), bit 1 (y,x)~(y+1,x),
    bit 2 (y,x)~(y+1,x+1), bit 3 (y,x+1)~(y+1,x)."""
    H = allowed_h.shape[0]
    W = allowed_v.shape[1]
    e = torch.zeros((H, W), dtype=torch.uint8, device=allowed_h.device)
    e[:, :-1] |= allowed_h.to(torch.uint8)
    e[:-1, :] |= allowed_v.to(torch.uint8) << 1
    if allowed_se is not None:
        e[:-1, :-1] |= allowed_se.to(torch.uint8) << 2
        e[:-1, :-1] |= allowed_sw.to(torch.uint8) << 3
    return e


def _fn():
    lib = _build.load("cc_sweep")
    fn = lib.rtdm_cc_propagate
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, P, P, I, I, I, I, I, P, P, P]
        fn.restype = I
    return lib, fn


def seg_min_propagate(field: torch.Tensor, active: torch.Tensor,
                      allowed_h: torch.Tensor, allowed_v: torch.Tensor,
                      allowed_se: Optional[torch.Tensor] = None,
                      allowed_sw: Optional[torch.Tensor] = None,
                      max_rounds: Optional[int] = None) -> torch.Tensor:
    """Min-propagate `field` ((H, W) or (N, H, W) int32) along the allowed
    edges of `active` pixels. allowed_h: (H, W-1) edges (y,x)~(y,x+1);
    allowed_v: (H-1, W) edges (y,x)~(y+1,x); for 8-connectivity also
    allowed_se / allowed_sw, (H-1, W-1) edges (y,x)~(y+1,x+1) and
    (y,x+1)~(y+1,x). Every edge must join two active pixels. max_rounds caps
    the sweeps (None: to the fixed point)."""
    if field.device.type == "cpu":
        return seg_min_propagate_plain(field, active, allowed_h, allowed_v,
                                       allowed_se, allowed_sw, max_rounds)
    if field.device.type != "cuda":
        raise ValueError(f"seg_min_propagate: unsupported device {field.device}")
    if (allowed_se is None) != (allowed_sw is None):
        raise ValueError("pass both diagonal edge masks or neither")
    squeeze = field.dim() == 2
    f = field[None] if squeeze else field
    N, H, W = f.shape
    _build.require(f, "field", torch.int32)
    _build.require(active, "active", torch.bool, (H, W))
    for name, t, shape in (("allowed_h", allowed_h, (H, W - 1)),
                           ("allowed_v", allowed_v, (H - 1, W)),
                           ("allowed_se", allowed_se, (H - 1, W - 1)),
                           ("allowed_sw", allowed_sw, (H - 1, W - 1))):
        if t is not None:
            _build.require(t, name, torch.bool, shape)
    out = f.clone()
    scratch = torch.empty_like(out)
    edges = pack_edges(allowed_h, allowed_v, allowed_se, allowed_sw)
    changed = torch.zeros(1, dtype=torch.int32, device=f.device)
    rounds = ctypes.c_int(0)
    cap = UNCAPPED if max_rounds is None else int(max_rounds)
    lib, fn = _fn()
    with torch.cuda.device(f.device):
        err = fn(out.data_ptr(), scratch.data_ptr(), active.data_ptr(),
                 edges.data_ptr(), N, H, W, int(allowed_se is not None), cap,
                 changed.data_ptr(), ctypes.addressof(rounds),
                 _build.stream_of(f))
    seg_min_propagate.launches += 1
    _build.check(lib, err, "seg_min_propagate")
    seg_min_propagate.last_rounds = rounds.value
    return out[0] if squeeze else out


seg_min_propagate.launches = 0
seg_min_propagate.last_rounds = 0
