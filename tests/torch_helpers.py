"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


def cuda_or_skip() -> torch.device:
    """The CUDA device, or skip: kernel tests need the card (the CPU runs
    only the kernels' plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels on the card")
    return torch.device("cuda")


def profiled_spans(fn):
    """(fn(), the `rtdm.` ranges the port opened while fn ran under a CPU
    torch.profiler: its FunctionEvents in the order they start)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted((e for e in prof.events() if e.name.startswith("rtdm.")),
                       key=lambda e: e.time_range.start)


def t(a, device="cpu"):
    """numpy -> torch tensor (a private copy) on `device`."""
    return torch.from_numpy(np.array(a)).to(device)


def blob_mask(seed, H, W, n_blobs=6, noise=0.0):
    """uint8 0/255 mask of random rectangles and ellipses, plus optional
    salt noise."""
    rng = np.random.default_rng(seed)
    m = np.zeros((H, W), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n_blobs):
        y, x = rng.integers(0, H), rng.integers(0, W)
        h, w = rng.integers(2, max(3, H // 3)), rng.integers(2, max(3, W // 3))
        if i % 2:
            m[y: y + h, x: x + w] = 255
        else:
            m[((yy - y) / h) ** 2 + ((xx - x) / w) ** 2 <= 1.0] = 255
    if noise:
        m[rng.random((H, W)) < noise] = 255
    return m


def snake(H, W, arms):
    """Serpentine one-component path (tests/test_speckle_cap.py _snake): each
    turn costs propagation a sweep, so many arms defeat a round cap."""
    m = np.zeros((H, W), np.uint8)
    step = H // arms
    for a in range(arms):
        y = a * step
        m[y, :] = 255
        if a + 1 < arms:
            col = W - 1 if a % 2 == 0 else 0
            m[y: y + step + 1, col] = 255
    return m


def stereo_pair(seed, H, W, shift):
    """Blurred random texture and its copy shifted by `shift` columns."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64)).astype(np.float64)
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift: shift + W].copy()


def row_blur_pair(seed, H, W, shift):
    """tests/test_parallel.py's pair: row-blurred random texture and its
    copy shifted by `shift` columns."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8).astype(np.float32)
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift: shift + W].copy()


def remap_grid(case, Ho=40, Wo=56, H=40, W=56):
    """(Ho, Wo, 2) float32 [x, y] map over an H x W source for the K1 tests:
    identity, shear (a fractional shift and a vertical stretch past the
    border), random (anywhere, including fully outside the image), ties
    (exact 1/64-px offsets: round half to even) or rotation."""
    oy, ox = np.mgrid[0:Ho, 0:Wo].astype(np.float32)
    rng = np.random.default_rng(3)
    if case == "identity":
        mx, my = ox, oy
    elif case == "shear":
        mx = ox + 0.3 + 0.05 * oy
        my = oy * (H + 8.0) / H - 4.0
    elif case == "random":
        mx = rng.uniform(-4, W + 4, (Ho, Wo))
        my = rng.uniform(-4, H + 4, (Ho, Wo))
    elif case == "ties":
        mx = ox + (2 * rng.integers(0, 32, (Ho, Wo)) + 1) / 64.0
        my = oy - (2 * rng.integers(0, 32, (Ho, Wo)) + 1) / 64.0
    elif case == "rotation":
        a = 0.05
        cx, cy = Wo / 2, Ho / 2
        mx = np.cos(a) * (ox - cx) - np.sin(a) * (oy - cy) + cx
        my = np.sin(a) * (ox - cx) + np.cos(a) * (oy - cy) + cy
    return np.stack([mx, my], axis=-1).astype(np.float32)



def write_calibration(directory, w, h):
    """intrinsics.yml / extrinsics.yml of a non-identity w x h rig, written
    with the port's write_filestorage by chip_smoke.py's
    `_write_calibration` (distortion on both cameras, a small relative
    rotation, a 4.8-unit baseline along x; ROI (8, 12, w - 16, h - 16)).
    Returns the two paths."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from chip_smoke import _write_calibration

    return _write_calibration(str(directory), w, h)
