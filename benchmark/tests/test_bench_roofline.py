"""The roofline yardstick's work counts against hand counts."""

import pytest

from benchmark.harness import roofline


def test_sgm_work_by_hand():
    # H=2, W=8, D=4: W1 = 4 matched columns, 2 * 4 * 4 = 32 (pixel, d)
    nbytes, lane_ops = roofline.sgm_work(2, 8, 4, 8)
    assert nbytes == 2 * 2 * 8 + 6 * 2 * 4
    # cost 21 ops and 8 paths of 8 on 16-bit pairs, the winner's 8 on 32 bits
    assert lane_ops == 21 * 32 / 2 + 8 * 8 * 32 / 2 + 8 * 32
    assert roofline.sgm_work(2, 8, 4, 5)[1] == 21 * 32 / 2 + 8 * 5 * 32 / 2 + 8 * 32


def test_sgm_work_at_the_cells_shape():
    # 720 x 1088 x 192 (pixel, d) at 50.5 lane instructions each
    assert roofline.sgm_work(720, 1280, 192, 8)[1] == pytest.approx(720 * 1088 * 192 * 50.5)


def test_bm_region_and_work_by_hand():
    # block 5 (w2 = 2), D = 4: rows [2, 18), columns [max(3, 0) + 2, 30 - 2)
    assert roofline.bm_region(20, 30, 4, 5, None) == (2, 18, 5, 28)
    # ROI (10, 4, 8, 6): columns [max(10, 3) + 2, min(18, 30) - 2), rows [6, 8)
    assert roofline.bm_region(20, 30, 4, 5, (10, 4, 8, 6)) == (6, 8, 12, 16)
    nbytes, lane_ops = roofline.bm_work(20, 30, 4, 5, (10, 4, 8, 6))
    n = 2 * 4
    assert lane_ops == n * 4 * (0.25 + 1 + 1 + 1)
    assert nbytes == (2 + 4) * (2 * (4 + 4) + 3) + 6 * n
    # an empty ROI matches nothing; none matches the whole frame
    assert roofline.bm_work(20, 30, 4, 5, (10, 4, 2, 6)) == (0, 0)
    assert roofline.bm_work(20, 30, 4, 5, None)[1] == 16 * 23 * 4 * 3.25


def test_bm_lanes_widen_past_16_bits():
    assert roofline.bm_lanes_per_pd(13) == 3.25  # 13 * 13 * 255 < 2^16
    assert roofline.bm_lanes_per_pd(17) == 4.25


def test_least_time_takes_the_larger_bound():
    card = "NVIDIA H100 80GB HBM3"
    bps, lps = roofline.peak(card)
    assert lps == pytest.approx(132 * 128 * 1.98e9)
    assert roofline.least_s(bps, 0, card) == pytest.approx(1.0)
    assert roofline.least_s(0, lps * 2, card) == pytest.approx(2.0)
    assert roofline.least_s(1, 1, "another card") is None
