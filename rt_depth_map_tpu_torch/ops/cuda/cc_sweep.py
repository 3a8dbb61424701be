"""K2: min-propagation of int32 fields along allowed edges (`csrc/cc_sweep.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/cc_sweep.py` `seg_min_propagate_pallas`,
with the round structure of the XLA loop in `rt_depth_map_tpu/ops/cc.py`
(hop for 8-connectivity, row run-min, column run-min per sweep; two sweeps
per trip; stop when a trip changes nothing or the sweep count reaches the
cap), so that the result matches the reference bit for bit even where the
cap stops propagation short of the fixed point.

On the H100 the whole propagation is one cooperative launch that loops over
the trips on the device, with grid barriers between its phases (a hop and
row run-min phase, then a column run-min phase, per sweep; each recomputes
only the rows or column tiles whose inputs the sweep before changed), and
stops there when a trip changed nothing (`csrc/cc_sweep.cu`). A row or a
column tile too long for a block's shared memory is scanned in chunks
(`cc_chunks`), with each chunk's carries from both sides, so any frame size
runs and gives the same labels after every sweep. Nothing in a call
waits for the device: the sweep count is left in
`seg_min_propagate.last_rounds`, a 1-element int32 tensor on the device,
which a caller reads after its own synchronise.

`seg_min_propagate` launches the kernel for CUDA tensors and runs
`seg_min_propagate_plain` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build

BIG = 2**30
#: warps of a K2 block, and most chunks of a row or a column (CC_WARPS and
#: CC_MAX_CHUNKS in `csrc/cc_sweep.cu`)
CC_WARPS = 16
CC_MAX_CHUNKS = 32
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


def cc_row_bytes(wc: int) -> int:
    """Shared memory of the row phase for chunks of wc pixels: a buffer of
    wc + 32 int32 and wc edge bytes a warp (`cc_row_words`)."""
    return CC_WARPS * 4 * (wc + 32 + (wc + 3) // 4)


def cc_col_bytes(hc: int, chunked: bool) -> int:
    """Shared memory of the column phase for chunks of hc rows: the 32-column
    tile, the warps' aggregates, the chunk carries when the column has
    several chunks, and the edge bytes."""
    words = hc * 32 + 2 * CC_WARPS * 32 + (CC_MAX_CHUNKS * 32 if chunked else 0)
    return 4 * words + 32 * hc


def cc_chunks(H: int, W: int, smem_limit: int):
    """(wc, hc): the chunk width of the row phase and height of the column
    phase. The whole row (column) where it fits a block's shared memory,
    else the longest chunk that does (a multiple of 32 pixels in a row).
    Raises where a row or column would need more than CC_MAX_CHUNKS."""
    wc = W
    if cc_row_bytes(W) > smem_limit:
        wc = 0
        while cc_row_bytes(wc + 32) <= smem_limit:
            wc += 32
    hc = H
    if cc_col_bytes(H, False) > smem_limit:
        hc = (smem_limit - 4 * (2 * CC_WARPS * 32 + CC_MAX_CHUNKS * 32)) // 160
    if wc < 32 and wc < W or hc < 1:
        raise ValueError(f"cc_chunks: {smem_limit} bytes hold no chunk")
    if -(-W // wc) > CC_MAX_CHUNKS or -(-H // hc) > CC_MAX_CHUNKS:
        raise ValueError(f"cc_chunks: a {H}x{W} field needs more than "
                         f"{CC_MAX_CHUNKS} chunks a row or column")
    return wc, hc


def _fn():
    lib = _build.load("cc_sweep")
    fn = lib.rtdm_cc_propagate
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P, P]
        fn.restype = I
        lib.rtdm_cc_smem_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.rtdm_cc_smem_limit.restype = I
    return lib, fn


@functools.lru_cache(maxsize=None)
def smem_limit(device) -> int:
    """Shared memory a block may opt into on `device`."""
    lib, _ = _fn()
    limit = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.rtdm_cc_smem_limit(ctypes.byref(limit))
    _build.check(lib, err, "seg_min_propagate")
    return limit.value


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
    # grid barrier arrivals and generation, the change stamp, the sweep
    # count, then the marks of the rows and 32-column tiles each sweep changed
    state = torch.zeros(4 + 2 * N * H + N * -(-W // 32), dtype=torch.int32,
                        device=f.device)
    cap = UNCAPPED if max_rounds is None else int(max_rounds)
    lib, fn = _fn()
    with torch.cuda.device(f.device):
        wc, hc = cc_chunks(H, W, smem_limit(f.device))
        err = fn(out.data_ptr(), scratch.data_ptr(), active.data_ptr(),
                 edges.data_ptr(), N, H, W, int(allowed_se is not None), cap,
                 wc, hc, state.data_ptr(), _build.stream_of(f))
    seg_min_propagate.launches += 1
    _build.check(lib, err, "seg_min_propagate")
    seg_min_propagate.last_rounds = state[3:4]
    return out[0] if squeeze else out


seg_min_propagate.launches = 0
#: sweeps of the last CUDA call: a 1-element int32 device tensor (None
#: before the first); read it after a synchronise
seg_min_propagate.last_rounds = None
