"""Gloo ranks for the port's distribution tests.

``spawn(program, world, inputs, tmp)`` starts ``world`` processes of this
file, each one rank of a gloo process group over a ``FileStore`` under
``tmp`` (so concurrent test workers never share a port or a store), runs
``PROGRAMS[program](rank, world, inputs)`` in each and returns the ranks'
results, in rank order. ``inputs`` and the results are pickled numpy trees.
The ranks import the port alone, never JAX: the tests hold what they
return against the JAX package in the test process.

    python tests/torch_ranks.py <program> <rank> <world> <dir>

runs one rank by hand.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"


class RanksFailed(RuntimeError):
    pass


def spawn(program: str, world: int, inputs, tmp, timeout: float = 120.0
          ) -> list:
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    path = [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in path if p),
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, program, str(r), str(world),
                 str(tmp)], env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise RanksFailed(f"{program}: {world} ranks not done in {timeout} s"
                          f"\n{_logs(tmp, world)}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RanksFailed(f"{program}: exit codes "
                          f"{[p.returncode for p in procs]}\n"
                          f"{_logs(tmp, world)}")
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _logs(tmp: pathlib.Path, world: int) -> str:
    return "\n".join(f"--- rank {r}\n"
                     + (tmp / f"rank{r}.log").read_text()[-3000:]
                     for r in range(world))


def _np(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _torch(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


# ---------------------------------------------------------------------------
# The collectives and the toy pipelines (tests/test_torch_dist.py)
# ---------------------------------------------------------------------------

def toy_stage_fn(w, x):
    import torch
    return torch.tanh(x @ w["w"] + w["b"])


def toy_loss_fn(top, y, aux):
    import torch
    return torch.mean((y @ top["head"] - aux["tgt"]) ** 2)


def dist_checks(rank: int, world: int, inputs: dict) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as coll
    from repro_torch.dist import pipeline as pipe
    from repro_torch.launch import mesh as launch_mesh
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    out = {}
    small = launch_mesh.make_test_mesh(device="cpu")
    fallback = launch_mesh.make_test_mesh(world, 2, device="cpu")
    out["meshes"] = {"test": (small.mesh_dim_names, tuple(small.shape),
                              small.get_coordinate()),
                     "fallback": (tuple(fallback.shape),
                                  fallback.get_coordinate())}
    try:
        launch_mesh.make_production_mesh(device="cpu")
    except RuntimeError as e:           # 256 ranks asked of a smaller world
        out["meshes"]["production"] = str(e)
    ar = inputs["allreduce"]
    out["allreduce"] = {k: coll.quantized_allreduce_mean(
        torch.from_numpy(v[rank]), mesh, "stage") for k, v in ar.items()}
    out["tree_allreduce"] = coll.tree_quantized_allreduce(
        {k: torch.from_numpy(v[rank]) for k, v in ar.items()}, mesh, "stage")
    shift = [(i, i + 1) for i in range(world - 1)]
    out["permute"] = {
        wire: coll.permute_quantized(torch.from_numpy(x[rank]), mesh,
                                     "stage", shift, wire=wire)
        for wire, x in inputs["permute"].items()}
    toy = _torch(inputs["toy"])
    m = toy["x"].shape[0]
    out["gpipe"] = {wire: pipe.gpipe(toy_stage_fn, mesh=mesh, axis="stage",
                                     num_micro=m, act_wire=wire)(
        toy["ws"], toy["x"]) for wire in ("fp32", "int8")}
    out["train"] = {}
    for sched in ("1f1b", "gpipe"):
        for wire in ("fp32", "int8", "b1"):
            t = _torch(inputs["toy_sat" if wire == "b1" else "toy"])
            step = pipe.pipeline_train_step(
                toy_stage_fn, toy_loss_fn, mesh=mesh, axis="stage",
                num_micro=t["x"].shape[0], schedule=sched, act_wire=wire)
            out["train"][f"{sched}-{wire}"] = step(
                t["ws"], t["x"], aux=t["aux"], top=t["top"])
    mesh2 = init_device_mesh("cpu", (2, world // 2),
                             mesh_dim_names=("stage", "data"))
    t = _torch(inputs["toy_dp"])
    out["dp"] = {}
    for wire in ("fp32", "int8"):
        step = pipe.pipeline_train_step(
            toy_stage_fn, toy_loss_fn, mesh=mesh2, axis="stage",
            num_micro=t["x"].shape[0], dp_axis="data", grad_wire=wire)
        out["dp"][wire] = step(t["ws"], t["x"], aux=t["aux"], top=t["top"])
    return _np(out)


# ---------------------------------------------------------------------------
# The pipelined LM step (tests/test_torch_pipeline_lm.py)
# ---------------------------------------------------------------------------

def forced_inputs(recorded: list, *, num_layers: int, stages: int,
                  stage: int, shard: int, shards: int, num_micro: int,
                  schedule: str) -> list:
    """The one-device step's recorded quantizer inputs (microbatch-major,
    then layer, then call; one microbatch = one data shard's slice of
    ``num_micro``) in the order this rank's pipeline calls the quantizer."""
    from repro_torch.dist.pipeline import stage_calls
    calls = len(recorded) // (shards * num_micro * num_layers)
    lps = num_layers // stages
    out = []
    for m in stage_calls(stages, num_micro, schedule, stage):
        g = shard * num_micro + m
        for layer in range(stage * lps, (stage + 1) * lps):
            base = (g * num_layers + layer) * calls
            out += recorded[base:base + calls]
    return out


def lm_pipeline(rank: int, world: int, inputs: dict) -> dict:
    import torch

    from repro_torch import configs, convert
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.models import layers
    from repro_torch.optim import sgdm
    from repro_torch.optim.optimizers import sum_of_squares
    from repro_torch.train import ties
    from repro_torch.train.step import make_pipeline_train_step
    cfg = configs.get_reduced(inputs["arch"])
    stages, micro = inputs["stages"], inputs["num_micro"]
    mesh = make_pipeline_mesh(stages, device="cpu")
    stage, shard = mesh.get_local_rank("stage"), mesh.get_local_rank("data")
    params = convert.lm_params_from_numpy(inputs["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    opt = sgdm(inputs["lr"])
    out = {"stage": stage, "shard": shard}
    for name, run in inputs["runs"].items():
        p = sharding.stage_slice(params, mesh, cfg.num_layers)
        s = sharding.stage_slice(opt[0](params), mesh, cfg.num_layers)
        step = make_pipeline_train_step(
            cfg, opt, mesh=mesh, num_micro=micro, schedule=run["schedule"],
            grad_wire=run["grad_wire"], max_grad_norm=inputs["max_norm"])
        recorded = [torch.from_numpy(a) for a in forced_inputs(
            inputs["recorded"], num_layers=cfg.num_layers, stages=stages,
            stage=stage, shard=shard, shards=world // stages,
            num_micro=micro, schedule=run["schedule"])]
        with ties.forced(recorded, "lsq_fake_quant",
                         module=layers) as counts:
            p, s, metrics = step(p, s, batch)
        out[name] = {
            "loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
            "forced": sum(counts), "calls": len(counts),
            "planned": len(recorded),
            # this rank's share of the clipped gradients, the SGD-M moment
            "m": s["m"], "params": p,
            "local_sq": sum_of_squares(s["m"]["slots"])}
    return _np(out)


PROGRAMS = {"dist_checks": dist_checks, "lm_pipeline": lm_pipeline}


def main(argv) -> None:
    program, rank, world, tmp = argv[0], int(argv[1]), int(argv[2]), \
        pathlib.Path(argv[3])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(tmp / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = PROGRAMS[program](rank, world, inputs)
    finally:
        dist.destroy_process_group()
    with open(tmp / f"rank{rank}.pkl.tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp / f"rank{rank}.pkl.tmp", tmp / f"rank{rank}.pkl")


if __name__ == "__main__":
    main(sys.argv[1:])
