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
        if tree.dtype == np.uint32:          # sign words: same bits, int32
            tree = tree.view(np.int32)
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


# ---------------------------------------------------------------------------
# The sharded model (tests/test_torch_moe_ep.py, test_torch_sp.py,
# test_torch_sharded_step.py), on a (data 2, model 2) mesh
# ---------------------------------------------------------------------------

def forced_rows(recorded: list, tp: int):
    """The port's two W1A8 activation quantizers (`layers.quantize_act`:
    projections, packed experts, the uint8 wire; `moe.lsq_fake_quant`:
    the QAT experts) with each input row forced to the codes of its
    nearest row among ``recorded`` (`train.ties.forced_by_rows`; a
    tensor-parallel rank's hidden slice among the recorded rows' ``tp``
    column blocks). Yields one list of counts a quantizer."""
    import contextlib

    from repro_torch.models import layers, moe
    from repro_torch.train import ties
    import torch
    rec = [torch.from_numpy(a) for a in recorded]
    stack = contextlib.ExitStack()
    counts = [stack.enter_context(ties.forced_by_rows(
        rec, q, module=mod, splits=(1, tp)))
        for q, mod in (("quantize_act", layers), ("lsq_fake_quant", moe),
                       ("lsq_fake_quant", layers))]
    return stack, counts


def moe_ep(rank: int, world: int, inputs: dict) -> dict:
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import (ShardCtx, _apply_moe,
                                                init_lm_params)
    from repro_torch.serve.engine import generate
    from repro_torch.serve.packed import deploy_lm
    mesh = make_test_mesh(2, 2, device="cpu")
    shard = mesh.get_local_rank("data")
    out = {"coords": (shard, mesh.get_local_rank("model"))}
    for name, case in inputs["cases"].items():
        cfg = dataclasses.replace(configs.get_reduced(case["arch"]),
                                  **case["over"])
        ctx = ShardCtx(mesh, ("data",), "model", "data",
                       a2a_quant=case["a2a"])
        held = sharding.shard_tree({"moe": _torch(case["params"])}, cfg,
                                   mesh)["moe"]
        x = torch.from_numpy(case["x"])
        rows = x.shape[0] // 2
        stack, counts = forced_rows(case["recorded"], 2)
        with torch.no_grad(), stack:
            y = _apply_moe(held, cfg, x[shard * rows:(shard + 1) * rows],
                           case["mode"], ctx)
        out[name] = {"y": y, "forced": sum(map(sum, counts))}
    # served whole: the rank's rows through greedy generate, whose ticks
    # run decode_tick under the ctx, against the eager steps' tokens
    case = inputs["generate"]
    cfg = configs.get_reduced(case["arch"])
    held = sharding.shard_tree(deploy_lm(init_lm_params(
        cfg, torch.Generator().manual_seed(case["seed"]), device="cpu")),
        cfg, mesh)
    rows = case["prompts"].shape[0] // 2
    mine = torch.from_numpy(case["prompts"][shard * rows:(shard + 1) * rows])
    for wire in (False, True):
        ctx = ShardCtx(mesh, ("data",), "model", "data", a2a_quant=wire)
        with torch.no_grad():
            got = generate(cfg, held, mine, max_new=case["max_new"],
                           max_len=case["max_len"], mode="w1a8_eval",
                           ctx=ctx)
        _, eager = _greedy(cfg, held, mine, ctx, case["max_new"] - 1,
                           case["max_len"])
        out[f"generate-{wire}"] = {"generate": got, "eager": eager.T}
    return _np(out)


def sp_ranks(rank: int, world: int, inputs: dict) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serve import sp
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    a = _torch(inputs)
    t = a["k"].shape[1] // world
    part = slice(rank * t, (rank + 1) * t)
    out = {}
    for name, cur in a["cur_pos"].items():
        out[name] = sp.sp_decode_attention(
            mesh, "data", a["q"], a["k"][:, part], a["v"][:, part],
            a["pos"][:, part], cur)
        out[name + "_partial"] = sp.sp_attention_local(
            a["q"], a["k"][:, part], a["v"][:, part], a["pos"][:, part], cur)
    return _np(out)


def sharded_step(rank: int, world: int, inputs: dict) -> dict:
    """The sharded SGD-M step of each arch (no clip, so the moment is the
    gradient), tie codes forced to the reference's by rows; the
    launcher's --production-mesh branch on this mesh; elastic restores."""
    import torch

    from repro_torch import configs, convert
    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.dist import sharding
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import ShardCtx, init_lm_params
    from repro_torch.optim import sgdm
    from repro_torch.train.step import make_train_step
    mesh = make_test_mesh(2, 2, device="cpu")
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    for name, case in inputs["steps"].items():
        cfg = configs.get_reduced(name)
        ctx = ShardCtx(mesh, ("data",), "model",
                       "data" if cfg.num_experts else None)
        params = convert.lm_params_from_numpy(case["params"], device="cpu")
        opt = sgdm(inputs["lr"])
        p = sharding.shard_tree(params, cfg, mesh)
        s = sharding.shard_tree(opt[0](params), cfg, mesh)
        step = make_train_step(cfg, opt, ctx=ctx, remat=False,
                               max_grad_norm=inputs["max_norm"])
        stack, counts = forced_rows(case["recorded"], 2)
        with stack:
            p, s, metrics = step(p, s, _torch(case["batch"]))
        out[name] = {"loss": metrics["loss"],
                     "grad_norm": metrics["grad_norm"],
                     "forced": sum(map(sum, counts)), "m": s["m"],
                     "params": p,
                     "grads": sharding.gather_tree(s["m"], params, cfg,
                                                   mesh)}
    # the launcher's sharded branch, on this mesh
    args = launch_train.parse_args(inputs["launch"])
    out["launch"] = launch_train.train(args, torch.device("cpu"), mesh)
    # elastic restores: a one-device checkpoint onto this mesh, and the
    # launcher's onto (data 4, model 1)
    cfg = configs.get_reduced(inputs["elastic_arch"])
    for key, mesh_of, ckpt in (("onto_2x2", mesh, inputs["one_device_ckpt"]),
                               ("onto_4x1", make_test_mesh(4, 1, "cpu"),
                                args.ckpt_dir)):
        params = init_lm_params(cfg, None, device="meta")
        template = {"params": params,
                    "opt_state": sgdm(0.1)[0](params) if key == "onto_2x2"
                    else launch_train.OPTIMIZERS[args.optimizer](0.1)[0](
                        params)}
        last = latest_step(ckpt)
        held, _ = restore_checkpoint(
            ckpt, last, template, device="cpu",
            shardings=sharding.tree_shardings(template, cfg, mesh_of),
            mesh=mesh_of)
        out[key] = {"coords": {a: mesh_of.get_local_rank(a)
                               for a in ("data", "model")},
                    "held": held,
                    "whole": sharding.gather_tree(held, template, cfg,
                                                  mesh_of)}
    return _np(out)


# ---------------------------------------------------------------------------
# Tensor parallelism (tests/test_torch_tp.py): meshes (1, 2), (1, 4), (2, 2)
# ---------------------------------------------------------------------------

def _greedy(cfg, params, prompts, ctx, steps: int, max_len: int):
    """A packed prefill and ``steps`` greedy decode steps: (the logits of
    each, stacked; the tokens)."""
    import torch

    from repro_torch.serve.engine import decode_step, prefill
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, max_len=max_len,
                                mode="w1a8_eval", ctx=ctx)
        out = [logits]
        for _ in range(steps):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, cache = decode_step(cfg, params, cache, nxt,
                                        mode="w1a8_eval", ctx=ctx)
            out.append(logits)
    logits = torch.stack(out)
    return logits, torch.argmax(logits, -1)


def tp_ranks(rank: int, world: int, inputs: dict) -> dict:
    """Each case on its mesh: the forward's logits (gathered over the
    vocabulary), the sharded SGD-M step (no clip; codes forced by rows)
    with its gradients gathered, and for served archs the packed prefill
    and greedy decode steps. Every all-gather records the storage it
    reads: ``*_leaf_gathers`` name the non-MoE param leaves the step, the
    serve and (as a check of the probe) `dist.sharding.gather_tree`
    gathered."""
    import dataclasses

    import torch

    from repro_torch import configs, convert
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import ShardCtx, lm_forward, tp_of
    from repro_torch.optim import sgdm
    from repro_torch.serve.engine import generate
    from repro_torch.serve.packed import deploy_lm
    from repro_torch.train.step import make_train_step
    from repro_torch.models.transformer import tree_items
    meshes = {shape: make_test_mesh(*shape, device="cpu")
              for shape in inputs["meshes"]}
    gathered: set = set()
    real = collectives.all_gather_rows

    def recording(x, group):
        gathered.add(x.untyped_storage().data_ptr())
        return real(x, group)
    collectives.all_gather_rows = sharding.all_gather_rows = recording

    def leaf_gathers(tree) -> list:
        """The non-MoE leaves of ``tree`` an all-gather read since the
        record was cleared."""
        return [p for p, leaf in tree_items(tree) if "['moe']" not in p
                and leaf.untyped_storage().data_ptr() in gathered]
    out = {}
    for name, case in inputs["cases"].items():
        mesh = meshes[tuple(case["mesh"])]
        if mesh.get_coordinate() is None:
            continue
        data = mesh.get_local_rank("data")
        cfg = dataclasses.replace(configs.get_reduced(case["arch"]),
                                  **case["over"])
        sp = case.get("sp", False)
        ctx = ShardCtx(mesh, () if sp else ("data",), "model",
                       "data" if cfg.num_experts else None)
        tp = tp_of(ctx, cfg)
        params = convert.lm_params_from_numpy(case["params"], device="cpu")
        held = sharding.shard_tree(params, cfg, mesh)
        res = {"coords": mesh.get_coordinate()}
        if "batch" in case:
            batch = _torch(case["batch"])
            rows = batch["tokens"].shape[0] // mesh.size(0)
            mine = {k: v[data * rows:(data + 1) * rows]
                    for k, v in batch.items()}
            kw = {k: mine[k] for k in ("encoder_embeds", "prefix_embeds")
                  if k in mine}
            stack, _ = forced_rows(case["recorded"], mesh.size(1))
            with torch.no_grad(), stack:
                logits = lm_forward(cfg, held, mine["tokens"],
                                    mode="w1a8_train", ctx=ctx, **kw)
            if tp.vocab() is not None:
                logits = collectives.gather_cols(logits, tp.group)
            res["logits"] = logits
            opt = sgdm(inputs["lr"])
            step = make_train_step(cfg, opt, ctx=ctx, remat=False,
                                   max_grad_norm=inputs["max_norm"])
            stack, counts = forced_rows(case["recorded"], mesh.size(1))
            gathered.clear()
            with stack:
                _, s, metrics = step(held,
                                     sharding.shard_tree(opt[0](params), cfg,
                                                         mesh), batch)
            res["step_leaf_gathers"] = leaf_gathers(held)
            gathered.clear()
            res.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                       forced=sum(map(sum, counts)),
                       grads=sharding.gather_tree(s["m"], params, cfg, mesh))
            sharding.gather_tree(held, params, cfg, mesh)
            res["probe_leaf_gathers"] = leaf_gathers(held)
        if "prompts" in case:
            prompts = torch.from_numpy(case["prompts"])
            rows = prompts.shape[0] // (1 if sp else mesh.size(0))
            mine = prompts if sp else prompts[data * rows:(data + 1) * rows]
            packed = sharding.shard_tree(deploy_lm(params), cfg, mesh)
            gathered.clear()
            res["serve"] = _greedy(cfg, packed, mine, ctx,
                                   inputs["decode_steps"], inputs["max_len"])
            res["serve_leaf_gathers"] = leaf_gathers(packed)
            with torch.no_grad():
                res["generate"] = generate(
                    cfg, packed, mine, max_new=inputs["decode_steps"] + 1,
                    max_len=inputs["max_len"], mode="w1a8_eval", ctx=ctx)
        out[name] = res
    collectives.all_gather_rows = sharding.all_gather_rows = real
    return _np(out)


PROGRAMS = {"dist_checks": dist_checks, "lm_pipeline": lm_pipeline,
            "moe_ep": moe_ep, "sp": sp_ranks, "sharded_step": sharded_step,
            "tp": tp_ranks}


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
