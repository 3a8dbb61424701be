"""The port's calibration copies against the JAX package's: the hand-written
FileStorage reader against the PyYAML one (files from write_filestorage and
one written as OpenCV writes them), and compute_rectification bit for bit:
maps, ROI, Q, image size and the stereoRectify outputs."""

import numpy as np
import pytest

from rt_depth_map_tpu.calib import compute_rectification as jcompute
from rt_depth_map_tpu.calib import read_filestorage as jread
from rt_depth_map_tpu_torch.calib import (
    RectificationResult,
    compute_rectification,
    read_filestorage,
    write_filestorage,
)
from torch_helpers import write_calibration

#: as OpenCV's FileStorage writes it: the directive, the document marker,
#: %.16e data over several lines, float and int matrices, a block sequence
OPENCV_STYLE = """%YAML:1.0
---
M1: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 7.0190420843542263e+02, 0., 6.4184034468906580e+02, 0.,
       7.0190420843542263e+02, 3.5757934566447449e+02, 0., 0., 1. ]
D1: !!opencv-matrix
   rows: 1
   cols: 14
   dt: d
   data: [ -1.7292633098770393e-01, 2.7296386468410530e-02,
       -1.2493640802305427e-04, 4.8734612099658713e-04, 0., 0., 0.,
       -1.1005766633542101e-02, 0., 0., 0., 0., 0., 0. ]
P: !!opencv-matrix
   rows: 2
   cols: 2
   dt: f
   data: [ 1.5, -2.25e-01,
       3., 4.5e+02 ]
N: !!opencv-matrix
   rows: 1
   cols: 3
   dt: i
   data: [ 3, -4, 5 ]
ROI1: [ 49, 43, 233,
    156 ]
ROI2:
   - 40
   - 41
Width: 1280
rms: 3.5e-01
camera: "left eye"
"""


def _same_entries(got, ref):
    assert list(got) == list(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v and type(got[k]) is type(v), k


@pytest.mark.parametrize("which", ["intrinsics", "extrinsics", "opencv", "written"])
def test_read_filestorage_matches_pyyaml(tmp_path, which):
    intr, extr = write_calibration(tmp_path, 256, 96)
    path = {"intrinsics": intr, "extrinsics": extr}.get(which)
    if which == "opencv":
        path = str(tmp_path / "opencv.yml")
        with open(path, "w") as f:
            f.write(OPENCV_STYLE)
    elif which == "written":
        path = str(tmp_path / "written.yml")
        write_filestorage(path, {
            "A": np.arange(6, dtype=np.float64).reshape(2, 3) / 7.0,
            "B": np.arange(4, dtype=np.int32).reshape(4, 1) - 2,
            "C": np.array([[1, 2], [3, 4]], np.uint8),
            "L": [1, 2, 3], "F": 0.1, "I": 7, "S": "text"})
    ref, got = jread(path), read_filestorage(path)
    _same_entries(got, ref)
    if which == "opencv":
        assert got["D1"].shape == (1, 14) and got["P"].dtype == np.float32
        assert got["ROI1"] == [49, 43, 233, 156] and got["ROI2"] == [40, 41]


@pytest.mark.parametrize("text,match", [
    ("M: !!opencv-matrix\n   rows: 2\n   cols: 2\n   data: [ 1, 2, 3 ]\n",
     "3 values for a 2x2"),
    ("ROI: [ 1, 2,\n", "unterminated"),
    ("   indented: 1\n", "unexpected indented"),
])
def test_read_filestorage_refuses_malformed(tmp_path, text, match):
    path = tmp_path / "bad.yml"
    path.write_text("%YAML:1.0\n" + text)
    with pytest.raises(ValueError, match=match):
        read_filestorage(str(path))


@pytest.mark.parametrize("size", [(256, 96), (1280, 720)])
def test_compute_rectification_matches_jax(tmp_path, size):
    """The files' resolution overrides the size asked for (main.cpp:87-90);
    everything equals the JAX package's bit for bit."""
    intr, extr = write_calibration(tmp_path, *size)
    ref = jcompute(intr, extr, (640, 480))
    got = compute_rectification(intr, extr, (640, 480))
    assert isinstance(got, RectificationResult)
    assert got.image_size == ref.image_size == size
    assert got.roi == ref.roi == (8, 12, size[0] - 16, size[1] - 16)
    for name in ("map_left", "map_right", "Q"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("R1", "R2", "P1", "P2", "Q"):
        np.testing.assert_array_equal(getattr(got.rectify, name),
                                      getattr(ref.rectify, name), err_msg=name)
    assert got.rectify.roi1 == ref.rectify.roi1
    # a real warp: the maps are not the identity
    gx = np.arange(size[0], dtype=np.float32)[None, :]
    assert np.abs(got.map_left[..., 0] - gx).max() > 0.5
