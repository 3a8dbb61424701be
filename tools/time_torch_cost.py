#!/usr/bin/env python3
"""Time the single-frame cost volume (K3, `sgm_cost_volume`) in one or more
checkouts on one card, each checkout in its own process, in the order given.

    python3 tools/time_torch_cost.py ROOT [ROOT ...]

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that drift of
the card over the call shows). A process imports the package of its ROOT
only, builds that checkout's kernels into its own `build/`, and times K3 on
the plane stacks of chip_smoke.py's first synthetic frame pair (gray, with
chip_smoke.py's SGM matcher: its block size, pre-filter cap and volume
type) at 1280x720 D=128 (the SGM-8 frame program's call) and 1920x1080
D=256: 20 calls issued back to back between two CUDA events (`ms_b2b`,
the best of three) and chip_smoke.py's CUDA-event median of 51 single
calls (`ms`). One JSON line a process: the card's name and power limit,
the checkout, the numbers.
"""

from __future__ import annotations

import sys

import torch_timing as tt

#: (W, H, D) of the timed calls
SHAPES = ((1280, 720, 128), (1920, 1080, 256))


def _child(root: str) -> dict:
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
        plane_stack,
        sgm_cost_volume,
        volume_dtype,
    )

    out = {"card": cs._card(), "root": root, "ms_b2b": {}, "ms": {}}
    for w, h, d in SHAPES:
        m = cs._config("sgm", w, h, d=d).matcher
        lnp, rnp, _, _ = cs._source(w, h).render(0)
        lpl, rpl = (plane_stack(rgb_to_gray(torch.from_numpy(x).to("cuda")),
                                m.pre_filter_cap) for x in (lnp, rnp))
        dtype = volume_dtype(m.block_size, m.pre_filter_cap)

        def call(lpl=lpl, rpl=rpl, d=d, bs=m.block_size, dtype=dtype):
            return sgm_cost_volume(lpl, rpl, d, bs, dtype)

        name = f"K3 sgm_cost_volume {w}x{h} D={d} {str(dtype)[6:]}"
        out["ms_b2b"][name] = min(tt.b2b_ms(torch, call) for _ in range(3))
        out["ms"][name] = cs._time_ms(call, reps=51)
        del lpl, rpl
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": _child}))
