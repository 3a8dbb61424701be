"""The port's CLI against the JAX package's: the same options, defaults and
choices (the port adds --device), the same EngineConfig from the same
arguments, and the same per-frame label lines from `main` on the same
calibration files at a small size (the intrinsics file's resolution
overriding the default 1280x720)."""

import dataclasses
import os

import pytest

from rt_depth_map_tpu import cli as jcli
from rt_depth_map_tpu_torch import cli
from torch_helpers import write_calibration

ARGV = [
    [],
    ["-H", "96", "-W", "256", "-a", "-nd", "64", "-mos", "30", "-cu", "10",
     "--object-color", "blue", "--matcher", "sgm", "--paths", "5",
     "--backend", "xla", "--seed", "3", "--post-filter",
     "--show-disparity-value", "--source", "files", "--source-path", "x"],
    ["-lcd", "/dev/video4", "-rcd", "/dev/video5", "-i", "a.yml", "-e", "b.yml",
     "--frames", "9", "--preload", "4", "--mjpeg", "--synthetic-ring", "0",
     "--no-prefetch", "--stats", "--view", "--print-depth", "--save-frames", "d",
     "--paths", "4", "--backend", "pallas"],
]


def _actions(parser):
    return {tuple(a.option_strings): a for a in parser._actions}


def test_parser_matches_jax():
    ref, got = _actions(jcli.build_parser()), _actions(cli.build_parser())
    assert set(got) - set(ref) == {("--device",)}
    assert set(ref) <= set(got)
    for opts, a in ref.items():
        b = got[opts]
        for field in ("dest", "default", "choices", "type", "nargs", "const",
                      "required"):
            assert getattr(b, field) == getattr(a, field), (opts, field)
        assert type(b) is type(a), opts
    dev = got[("--device",)]
    assert dev.default == "cuda" and list(dev.choices) == ["cuda", "cpu"]


@pytest.mark.parametrize("argv", ARGV, ids=["defaults", "sgm", "io"])
def test_config_from_args_matches_jax(argv):
    ref = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _labels(out):
    return [ln for ln in out.splitlines() if ln.startswith("frame ")]


def test_main_prints_the_jax_labels(tmp_path, capsys, monkeypatch):
    """-i/-e files of a 256x96 rig under the default 1280x720 configuration
    (D scales to 32), the default BM matcher, --show-disparity-value."""
    intr, extr = write_calibration(tmp_path, 256, 96)
    argv = ["-i", intr, "-e", extr, "--frames", "2", "--print-depth",
            "--show-disparity-value", "--no-prefetch"]
    monkeypatch.setenv("RTDM_COMPILE_CACHE", "0")  # no cache outside the tree
    saved = dict(os.environ)
    try:
        assert jcli.main(argv) == 0
    finally:  # the JAX CLI writes TUNED.env's knobs into the environment
        os.environ.clear()
        os.environ.update(saved)
    ref = capsys.readouterr()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert _labels(got.out) == _labels(ref.out)
    assert len(_labels(got.out)) == 2 and "disparity = " in got.out
    override = "intrinsics resolution override: 1280x720 -> 256x96"
    assert override in got.err and override in ref.err
    assert "processed 2 frames" in got.err and "D=32" in got.err


def test_preload_runs_and_needs_frames(tmp_path, capsys):
    base = ["--device", "cpu", "-W", "128", "-H", "64", "-nd", "16"]
    assert cli.main(base + ["--preload", "2"]) == 2
    assert "--preload requires --frames" in capsys.readouterr().err
    assert cli.main(base + ["--preload", "2", "--frames", "3", "--stats"]) == 0
    err = capsys.readouterr().err
    assert "processed 3 frames" in err and "preload (grab+decode+h2d)" in err


def test_device_cuda_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-W", "128", "-H", "64", "--frames", "1"])
