"""Connected components to their fixed point, as OpenCV finds them: on a
serpentine that needs more than the JAX package's 16 sweeps, the port's
speckle filter and detection equal the benchmark's plain reference
(`benchmark/reference/stages.py`, which propagates to a fixed point), and
capped at 16 sweeps they differ from it. On the card, K2 uncapped equals its
plain version on the snake, eagerly and replayed from a CUDA graph, with its
sweep count in a `SweepCounter`. The file imports no JAX, so it also runs
on a machine with the card:

    python -m pytest --noconftest tests/test_torch_cc_convergence.py -q -p no:randomly
"""

import functools

import pytest
import torch

from benchmark.reference import stages
from rt_depth_map_tpu_torch.ops import detect, speckle
from rt_depth_map_tpu_torch.ops.cc import CC_MAX_ROUNDS, connected_components_bbox
from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import SweepCounter
from torch_helpers import cuda_or_skip, snake, t

INVALID = -16


def _capped(monkeypatch, module, *names):
    """The module's propagations capped at the JAX package's 16 sweeps."""
    for name in names:
        monkeypatch.setattr(module, name, functools.partial(getattr(module, name),
                                                            max_rounds=CC_MAX_ROUNDS))


def _snake_disp(H, W, arms):
    return torch.where(t(snake(H, W, arms)) != 0, 32, INVALID).to(torch.int16)


def _sweeps(fn, device="cpu"):
    """(fn(), the sweeps of each K2 call it made on `device`)."""
    counter = SweepCounter(device)
    with counter.recording():
        out = fn()
    return out, counter.words[:counter.calls].tolist()


def test_speckle_filter_converges_like_the_reference(monkeypatch):
    """A snake of 3141 pixels: its components take more than 16 sweeps, and
    the fragment holding its root counts 2097 pixels under the cap, so with
    max_size 2500 the capped filter drops pixels that the reference keeps."""
    disp = _snake_disp(96, 128, 24)
    assert int((disp != INVALID).sum()) == 3141
    ref = stages.filter_speckles(disp[None], INVALID, 2500, 16)[0]
    got, sweeps = _sweeps(lambda: speckle.filter_speckles(disp, INVALID, 2500, 16))
    assert torch.equal(got, ref) and torch.equal(ref, disp)
    assert len(sweeps) == 2 and max(sweeps) > CC_MAX_ROUNDS
    _capped(monkeypatch, speckle, "connected_components_scan", "component_small_field")
    capped = speckle.filter_speckles(disp, INVALID, 2500, 16)
    assert not torch.equal(capped, ref)


def test_detection_converges_like_the_reference(monkeypatch):
    """One 8-connected snake: the reference's one box covers the frame; the
    capped propagation splits it into several roots with smaller boxes."""
    mask = t(snake(96, 48, 24))
    ref = stages.detect(mask[None], 1, 8)[0]
    got, sweeps = _sweeps(lambda: detect.detect_objects(mask, 1, 8))
    assert torch.equal(got, ref)
    assert int(ref[:, 4].sum()) == 1 and ref[0].tolist() == [0, 0, 48, 93, 1]
    assert sweeps[0] > CC_MAX_ROUNDS
    _capped(monkeypatch, detect, "connected_components_bbox")
    assert not torch.equal(detect.detect_objects(mask, 1, 8), ref)


@pytest.mark.cuda
def test_k2_uncapped_on_the_snake_eager_and_replayed():
    """K2 to the fixed point on the snake equals the plain loop, eagerly and
    replayed from a CUDA graph captured on another snake; the counter the
    capture recorded into holds each run's sweeps, the plain loop's."""
    dev = cuda_or_skip()
    first, second = (t(snake(240, 320, arms) != 0, dev) for arms in (40, 24))
    for active in (first, second):
        got, sweeps = _sweeps(lambda a=active: connected_components_bbox(a, 8), dev)
        ref, ref_sweeps = _sweeps(lambda a=active: connected_components_bbox(a.cpu(), 8))
        assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
        assert sweeps == ref_sweeps and sweeps[0] > CC_MAX_ROUNDS
    static = first.clone()
    counter = SweepCounter(dev)
    connected_components_bbox(static, 8)  # warm: attributes, allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with counter.recording(), torch.cuda.graph(graph):
        out = connected_components_bbox(static, 8)
    for active in (second, first):
        static.copy_(active)
        graph.replay()
        ref, ref_sweeps = _sweeps(lambda a=active: connected_components_bbox(a.cpu(), 8))
        assert all(torch.equal(g.cpu(), r) for g, r in zip(out, ref))
        assert counter.calls == 1 and counter.words[:1].tolist() == ref_sweeps
