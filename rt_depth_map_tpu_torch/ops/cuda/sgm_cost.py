"""K3: SGBM cost volume, BT cost + block window sum (`csrc/sgm_cost.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/sgm_cost.py` `sgm_cost_volume_pallas`,
whose contract is the XLA formulation `rt_depth_map_tpu/ops/sgbm.py`
`sgbm_cost_volume` at any min_disparity minD: the Birchfield-Tomasi cost of
the clipped x-Sobel planes plus a quarter of the raw planes' BT cost, left
column minX1 + j against right column minX1 + j - minD - i for disparity
index i, summed over a block_size x block_size window that replicates at
the edges of the cropped column range [minX1, minX1 + W1) and of the rows
(`cost_geometry`: minX1 = max(minD + D, 0), W1 = W + min(minD, 0) - minX1;
every right column of that range lies inside the image). The volume is
(H, W1, D), D contiguous, int16 when `5 * bs^2 * pix_max` fits (the JAX
rule of `stereo_sgbm`), else int32.

The preprocessing (`sgbm_preprocess`, `halfpix`) is elementwise torch, as
the reference leaves it to XLA: `plane_stack` packs each image's six planes
into one (H, W, 8) uint8 stack, so the kernel reads a pixel's planes as one
8-byte load. The kernel takes the two stacks. On the H100 it is bound by
integer operations (two BT costs per pixel, disparity and window column):
it unpacks each staged column once for the block, computes both planes'
BT costs in the two 16-bit halves of one word, and computes each pixel cost
about once an output; see the source for the design.

`cols=(x_begin, width)` asks for the columns [x_begin, x_begin + width)
of that volume only, replicate border of the whole range included: the
tile of the exact width tiling (`parallel/exact_sgbm.py`), one launch over
the tile's columns.

`sgm_cost_volume_batch` takes B frames' (B, H, W, 8) stacks and returns
the (B, H, W1, D) volumes in one launch, the frame a grid dimension of the
same kernel (each frame's window rows clamp to its own rows): the port of
the TPU kernel's batched form (`sgm_cost.py:314-333`, `:404-424`: grid
B x stripes, the lane-stacked volume).

`sgm_cost_volume` and `sgm_cost_volume_batch` launch the kernel for CUDA
tensors and run their plain versions for CPU tensors; any other device
raises.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build


def ftzero_of(pre_filter_cap: int) -> int:
    return max(pre_filter_cap, 15) | 1


def volume_dtype(block_size: int, pre_filter_cap: int) -> torch.dtype:
    """int16 when every volume of the SGM path provably fits it
    (`rt_depth_map_tpu/ops/sgbm.py:517-523`), else int32."""
    pix_max = 2 * ftzero_of(pre_filter_cap) + (255 >> 2)
    fits = 5 * block_size * block_size * pix_max <= 32767
    return torch.int16 if fits else torch.int32


def _clamp_shift(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """x shifted by n along dim (out[i] = x[i - n]), replicating the edge."""
    L = x.shape[dim]
    idx = (torch.arange(L, device=x.device) - n).clamp(0, L - 1)
    return x.index_select(dim, idx)


def sgbm_preprocess(img: torch.Tensor, ftzero: int):
    """(sobel-clipped, raw) int32 planes (ops/sgbm.py `sgbm_preprocess`) of
    an (..., H, W) image: each (H, W) frame with its own borders."""
    x = img.to(torch.int32)
    up = _clamp_shift(x, 1, -2)
    down = _clamp_shift(x, -1, -2)

    def dx(row):
        return _clamp_shift(row, -1, -1) - _clamp_shift(row, 1, -1)

    sob = (2 * dx(x) + dx(up) + dx(down)).clamp(-ftzero, ftzero) + ftzero
    sob[..., 0] = 0
    sob[..., -1] = 0
    raw = x.clone()
    raw[..., 0] = 0
    raw[..., -1] = 0
    return sob, raw


def halfpix(p: torch.Tensor):
    """(min, max) of an (..., H, W) plane and its half-pixel interpolants
    along the rows (ops/sgbm.py `_halfpix`)."""
    left = _clamp_shift(p, 1, -1)
    right = _clamp_shift(p, -1, -1)
    al = torch.div(p + left, 2, rounding_mode="floor")
    ar = torch.div(p + right, 2, rounding_mode="floor")
    al[..., 0] = p[..., 0]
    ar[..., -1] = p[..., -1]
    return (torch.minimum(p, torch.minimum(al, ar)),
            torch.maximum(p, torch.maximum(al, ar)))


def _planes(img: torch.Tensor, ftzero: int):
    """[sobel, its halfpix min, max, raw, its halfpix min, max], int32."""
    sob, raw = sgbm_preprocess(img, ftzero)
    return (sob, *halfpix(sob), raw, *halfpix(raw))


def plane_stack(img: torch.Tensor, pre_filter_cap: int) -> torch.Tensor:
    """(..., H, W, 8) uint8 for an (..., H, W) uint8 image (one frame or a
    batch of B, each with its own borders): the clipped x-Sobel response,
    its half-pixel min and max, the raw image, its half-pixel min and max
    (every value fits 8 bits while ftzero <= 127), and two zeros."""
    ftzero = ftzero_of(pre_filter_cap)
    if ftzero > 127:
        raise ValueError(f"pre_filter_cap={pre_filter_cap}: the planes need "
                         "ftzero <= 127")
    planes = [p.to(torch.uint8) for p in _planes(img, ftzero)]
    zero = torch.zeros_like(planes[0])
    return torch.stack(planes + [zero, zero], dim=-1)


def cost_geometry(W: int, D: int, min_disp: int = 0):
    """(minX1, W1): the first column and the width of the range the cost
    volume covers (rt_depth_map_tpu/ops/sgbm.py:133-135)."""
    minX1 = max(min_disp + D, 0)
    return minX1, W + min(min_disp, 0) - minX1


def _bt(u, u0, u1, v, v0, v1):
    c0 = torch.maximum(u - v1, v0 - u).clamp(min=0)
    c1 = torch.maximum(v - u1, u0 - v).clamp(min=0)
    return torch.minimum(c0, c1)


def _window_sum_replicate(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """out[i] = sum over |o| <= size // 2 of x[clamp(i + o)] along dim."""
    w2 = size // 2
    acc = x.clone()
    for o in range(1, w2 + 1):
        acc += _clamp_shift(x, o, dim) + _clamp_shift(x, -o, dim)
    return acc


def _column_window(W1: int, cols):
    """(x_begin, width) of the output columns `cols` of [0, W1); None is the
    whole range."""
    x_begin, width = (0, W1) if cols is None else (int(cols[0]), int(cols[1]))
    if not (0 <= x_begin and 1 <= width and x_begin + width <= W1):
        raise ValueError(f"sgm_cost_volume: columns {cols} outside [0, {W1})")
    return x_begin, width


def sgm_cost_volume_plain(lpl: torch.Tensor, rpl: torch.Tensor,
                          num_disp: int, block_size: int,
                          dtype: torch.dtype = torch.int32, min_disp: int = 0,
                          cols=None):
    """(C, minX1, W1) from the two `plane_stack`s: the XLA formulation of
    ops/sgbm.py `sgbm_cost_volume` at min_disparity `min_disp`, C (H, W1, D)
    in `dtype`; with cols=(x_begin, width), its columns [x_begin, x_begin +
    width) only, (H, width, D), computed from the window columns they
    reach (clamped into [0, W1): the replicate border)."""
    D = num_disp
    W = lpl.shape[1]
    minX1, W1 = cost_geometry(W, D, min_disp)
    x_begin, width = _column_window(W1, cols)
    w2 = block_size // 2
    # the W1-space columns of the horizontal windows, replicated at its edges
    js = torch.arange(x_begin - w2, x_begin + width + w2,
                      device=lpl.device).clamp(0, W1 - 1)
    lp = lpl[:, minX1 + js].to(torch.int32).unbind(-1)
    rp = rpl.to(torch.int32).unbind(-1)
    # the right column of left column minX1 + j at disparity index i; the
    # cropped range keeps every one inside the image, where the reference's
    # "0 outside the image" never applies
    xr = ((minX1 + js)[:, None] - min_disp
          - torch.arange(D, device=lpl.device)[None, :])  # (columns, D)
    if int(xr.min()) < 0 or int(xr.max()) >= W:
        raise AssertionError("sgm_cost_volume_plain: right column outside the image")

    def bt(l3, r3):
        u, u0, u1 = (a[..., None] for a in l3)
        v, v0, v1 = (a[:, xr] for a in r3)
        return _bt(u, u0, u1, v, v0, v1)

    pix = bt(lp[0:3], rp[0:3]) + (bt(lp[3:6], rp[3:6]) >> 2)  # (H, width + 2 w2, D)
    hsum = pix[:, :width].clone()
    for o in range(1, 2 * w2 + 1):
        hsum += pix[:, o: o + width]
    C = _window_sum_replicate(hsum, block_size, 0)
    return C.to(dtype), minX1, W1


def _fn(name: str = "rtdm_sgm_cost"):
    lib = _build.load("sgm_cost")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = ([P, P] + [I] * (11 if name.endswith("batch") else 10)
                       + [P, P])
        fn.restype = I
    return lib, fn


def _check_geometry(what: str, W: int, D: int, bs: int, minD: int,
                    dtype: torch.dtype):
    """(minX1, W1) of a launch, or raise for what the kernel does not take."""
    minX1, W1 = cost_geometry(W, D, minD)
    if not (1 <= D <= 1024 and W1 >= 1) or bs % 2 == 0 or bs > 11:
        raise ValueError(f"{what}: unsupported D={D}, min_disp={minD}, "
                         f"block_size={bs} at width {W}")
    if dtype not in (torch.int16, torch.int32):
        raise ValueError(f"{what}: dtype must be int16 or int32, got {dtype}")
    return minX1, W1


def sgm_cost_volume(lpl: torch.Tensor, rpl: torch.Tensor, num_disp: int,
                    block_size: int, dtype: torch.dtype = torch.int32,
                    min_disp: int = 0, cols=None):
    """(C, minX1, W1) from the (H, W, 8) uint8 `plane_stack`s of the left
    and right rectified images at min_disparity `min_disp`: C is (H, W1, D)
    in `dtype` (int16 or int32; the caller picks `volume_dtype`), (minX1,
    W1) = `cost_geometry(W, D, min_disp)` (D and W - D at min_disp 0). With
    cols=(x_begin, width), C is (H, width, D): the columns [x_begin, x_begin
    + width) of that volume, in one launch over those columns."""
    if lpl.device.type == "cpu":
        return sgm_cost_volume_plain(lpl, rpl, num_disp, block_size, dtype,
                                     min_disp, cols)
    if lpl.device.type != "cuda":
        raise ValueError(f"sgm_cost_volume: unsupported device {lpl.device}")
    H, W = lpl.shape[:2]
    D, bs, minD = int(num_disp), int(block_size), int(min_disp)
    minX1, W1 = _check_geometry("sgm_cost_volume", W, D, bs, minD, dtype)
    x_begin, width = _column_window(W1, cols)
    _build.require(lpl, "lpl", torch.uint8, (H, W, 8))
    _build.require(rpl, "rpl", torch.uint8, (H, W, 8))
    out = torch.empty((H, width, D), dtype=dtype, device=lpl.device)
    lib, fn = _fn()
    with torch.cuda.device(lpl.device):
        err = fn(lpl.data_ptr(), rpl.data_ptr(), H, W, D, bs, minD, minX1, W1,
                 x_begin, width, out.element_size(), out.data_ptr(),
                 _build.stream_of(lpl))
    sgm_cost_volume.launches += 1
    _build.check(lib, err, "sgm_cost_volume")
    return out, minX1, W1


sgm_cost_volume.launches = 0


def sgm_cost_volume_batch_plain(lpl: torch.Tensor, rpl: torch.Tensor,
                                num_disp: int, block_size: int,
                                dtype: torch.dtype = torch.int32,
                                min_disp: int = 0):
    """`sgm_cost_volume_plain` over the frames: (C (B, H, W1, D), minX1,
    W1)."""
    vols = [sgm_cost_volume_plain(lp, rp, num_disp, block_size, dtype,
                                  min_disp) for lp, rp in zip(lpl, rpl)]
    return torch.stack([v[0] for v in vols]), vols[0][1], vols[0][2]


def sgm_cost_volume_batch(lpl: torch.Tensor, rpl: torch.Tensor, num_disp: int,
                          block_size: int, dtype: torch.dtype = torch.int32,
                          min_disp: int = 0):
    """(C, minX1, W1) of B frames from their (B, H, W, 8) uint8
    `plane_stack`s in one launch: C is (B, H, W1, D) in `dtype`, frame b
    equal to `sgm_cost_volume(lpl[b], rpl[b], ...)`."""
    if not _build.on_card(lpl, "sgm_cost_volume_batch"):
        return sgm_cost_volume_batch_plain(lpl, rpl, num_disp, block_size,
                                           dtype, min_disp)
    B, H, W = lpl.shape[:3]
    D, bs, minD = int(num_disp), int(block_size), int(min_disp)
    minX1, W1 = _check_geometry("sgm_cost_volume_batch", W, D, bs, minD, dtype)
    _build.require(lpl, "lpl", torch.uint8, (B, H, W, 8))
    _build.require(rpl, "rpl", torch.uint8, (B, H, W, 8))
    out = torch.empty((B, H, W1, D), dtype=dtype, device=lpl.device)
    lib, fn = _fn("rtdm_sgm_cost_batch")
    with torch.cuda.device(lpl.device):
        err = fn(lpl.data_ptr(), rpl.data_ptr(), B, H, W, D, bs, minD, minX1,
                 W1, 0, W1, out.element_size(), out.data_ptr(),
                 _build.stream_of(lpl))
    sgm_cost_volume_batch.launches += 1
    _build.check(lib, err, "sgm_cost_volume_batch")
    return out, minX1, W1


sgm_cost_volume_batch.launches = 0
