"""Ranks of the port's multi-rank tests (tests/test_torch_parallel*.py).

Each rank is a `torch.multiprocessing` worker (spawned, so it starts from a
fresh import) on gloo at device "cpu", where the port's kernels run their
plain versions. A worker imports torch, numpy and the port, never JAX: it
checks `sys.modules` before it exits. It brings the world up through the
RTDM_* environment variables (`parallel/launch.py`), runs the cases it was
given, one after another, and saves their results for the test process,
which holds them against the JAX package.

`run_ranks` starts the world and joins it under a deadline: a rank that
hangs (a collective one rank never posts) is killed and the test fails.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

#: seconds a spawned world may take, start-up included
DEADLINE_S = 150


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


# -- cases: case(mesh_by_name, **kwargs) -> dict of numpy arrays ------------

def case_tiled_bm(meshes, mesh, left, right, cfg):
    from rt_depth_map_tpu_torch.config import MatcherConfig
    from rt_depth_map_tpu_torch.parallel import tiled_stereo_bm

    return {"disp": _np(tiled_stereo_bm(torch.from_numpy(left), torch.from_numpy(right),
                                        MatcherConfig(**cfg), meshes[mesh]))}


def case_tiled_sgbm(meshes, mesh, left, right, cfg, margin):
    from rt_depth_map_tpu_torch.config import MatcherConfig
    from rt_depth_map_tpu_torch.parallel.tiled_sgbm import tiled_stereo_sgbm

    return {"disp": _np(tiled_stereo_sgbm(torch.from_numpy(left), torch.from_numpy(right),
                                          MatcherConfig(**cfg), meshes[mesh],
                                          margin=margin))}


def case_exact(meshes, mesh, left, right, cfg, row_block):
    from rt_depth_map_tpu_torch.config import MatcherConfig
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import sgm_tile_scan
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import exact_tiled_stereo_sgbm

    n0 = sgm_tile_scan.launches
    disp = exact_tiled_stereo_sgbm(torch.from_numpy(left), torch.from_numpy(right),
                                   MatcherConfig(**cfg), meshes[mesh],
                                   row_block=row_block)
    return {"disp": _np(disp), "card_launches": sgm_tile_scan.launches - n0}


def case_halo_guard(meshes, mesh, kind, left, right, cfg):
    from rt_depth_map_tpu_torch.config import MatcherConfig
    from rt_depth_map_tpu_torch.parallel.tiled_bm import tiled_stereo_bm
    from rt_depth_map_tpu_torch.parallel.tiled_sgbm import tiled_stereo_sgbm

    fn = tiled_stereo_bm if kind == "bm" else tiled_stereo_sgbm
    try:
        fn(torch.from_numpy(left), torch.from_numpy(right), MatcherConfig(**cfg),
           meshes[mesh])
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": ""}


def case_sharded_step(meshes, mesh, lefts, rights, engine_cfg, Q):
    from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig
    from rt_depth_map_tpu_torch.parallel.pipeline_sharded import make_sharded_step

    d = dict(engine_cfg)
    cfg = EngineConfig(**{k: v for k, v in d.items() if k != "matcher"}).replace(
        matcher=MatcherConfig(**d["matcher"]))
    H, W = lefts.shape[1:3]
    step, shard = make_sharded_step(meshes[mesh], cfg, (W, H), Q=Q, device="cpu")
    out = step(torch.from_numpy(shard(lefts)), torch.from_numpy(shard(rights)))
    frames = np.arange(len(lefts))
    return {"frames": shard(frames), **{k: _np(v) for k, v in out.items()}}


def case_world(meshes, mesh):
    """What the rank sees of the world and its mesh."""
    import torch.distributed as dist

    m = meshes[mesh]
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(),
            "index": (m.axis_index("data"), m.axis_index("space")),
            "shape": (m.shape["data"], m.shape["space"])}


CASES = {f.__name__[5:]: f for f in (case_tiled_bm, case_tiled_sgbm, case_exact,
                                    case_halo_guard, case_sharded_step, case_world)}


def _worker(rank: int, world: int, port: int, meshes, cases, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        os.environ.update(RTDM_COORDINATOR=f"127.0.0.1:{port}",
                          RTDM_NUM_PROCESSES=str(world), RTDM_PROCESS_ID=str(rank))
        from rt_depth_map_tpu_torch.parallel import make_mesh
        from rt_depth_map_tpu_torch.parallel.launch import distributed_init
        import torch.distributed as dist

        if not distributed_init(device="cpu", timeout=DEADLINE_S):
            raise AssertionError("distributed_init returned False for a world of "
                                 f"{world}")
        built = {name: make_mesh(tuple(shape)) for name, shape in meshes}
        results = [CASES[name](built, **kw) for name, kw in cases]
        jax_loaded = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "rt_depth_map_tpu"))
        dist.destroy_process_group()
        torch.save({"results": results, "jax_loaded": jax_loaded},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, meshes, cases, deadline: float = DEADLINE_S):
    """Run `cases` ([(name, kwargs)]) on a spawned gloo world of `world`
    CPU ranks with `meshes` ([(name, (data, space))], made in that order
    on every rank); returns each rank's list of case results. Fails if a
    rank fails, imports JAX, or the world outlasts `deadline` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        port = _free_port()
        procs = [ctx.Process(target=_worker,
                             args=(r, world, port, meshes, cases, out_dir), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errs = {r: open(os.path.join(out_dir, f"rank{r}.err")).read()
                for r in range(world)
                if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))}
        if hung:
            raise AssertionError(f"ranks {hung} still running after {deadline} s "
                                 f"(killed); errors: {errs}")
        if errs or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"ranks failed (exit codes "
                                 f"{[p.exitcode for p in procs]}): {errs}")
        out = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]
    for r, o in enumerate(out):
        if o["jax_loaded"]:
            raise AssertionError(f"rank {r} imported {o['jax_loaded'][:5]}")
    return [o["results"] for o in out]
