"""Dry run: rank 0 of every (arch × shape × mesh) cell traced on the host
(counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both-meshes] [--out PATH]
        [--save-hlo] [--bubble-table]

The reference lowers and compiles each cell for 256 or 512 virtual XLA
devices and reads XLA's cost analysis, memory analysis and HLO text. The
port runs its own program instead, for rank 0 of the real world:

* `fake_world` starts torch's ``fake`` process-group backend (every
  collective returns at once and moves nothing) for 256 or 512 ranks, and
  the mesh is `launch.mesh.make_production_mesh` over it (its groups are
  built for the ``cpu`` device type, which needs no card);
* every tensor lives on the ``meta`` device: it has a shape and a dtype
  and holds no memory, and every kernel wrapper takes its shape-only path
  (`kernels._build.shape_only`), so a cell needs neither a card nor
  memory. `trace` also runs a cell under ``FakeTensorMode`` instead
  (``fake=True``: `FakeTensor` s on the card's device where the host has
  one, else the CPU's, as a CPU-only torch cannot index a fake CUDA
  tensor); the counts are the same (the tests hold them so), and meta
  tensors dispatch some 4× faster, which the Mamba cells' thousands of
  chunk and scan steps a layer need;
* a `Counter` (a ``TorchDispatchMode``) watches the run: FLOPs by dtype,
  unfused bytes, collectives by kind and group, live memory by category.

The cells run the port's own entry points under a `ShardCtx` (the
reference's: ``dp_axes`` empty where the global batch is smaller than the
dp size, and then the KV sequence over 'data' in decode,
`serve.cache.sp_axis`; ``tp_axis='model'``, ``ep_axis='data'`` for MoE
archs): train is `train.step.make_train_step` (8 microbatches, remat) on
the rank's `dist.sharding.shard_tree` of the params (bf16 with Adafactor
for the `BIG` archs, f32 with AdamW otherwise) and optimizer state;
prefill is
`models.transformer.lm_forward` and decode `serve.engine.decode_step` on
the rank's `shard_tree` of `serve.packed.deploy_lm`'s tree, with the
rank's rows of the batch and its block of the cache
(`serve.cache.init_cache` under the ctx). Every layer runs on the rank's
blocks, tensor-parallel (`models.layers`).

A record holds, beside the reference's ``arch``, ``shape``, ``mesh``,
``chips``, ``status`` and ``pipeline_bubble``:

* ``trace_s`` (in place of ``lower_s`` and ``compile_s``);
* ``cost``: ``flops`` and ``flops_by_dtype`` (``f32``, ``bf16`` and
  ``int8``, the last the popcount and int8 tensor-core kernels: 2·M·N·K
  each), ``bytes_accessed`` (each op's inputs plus outputs, unfused: an
  upper bound, as XLA's CPU figure is);
* ``collectives``: bytes of output shape and ``counts`` under the
  reference's five kinds, and ``groups``: each kind's bytes and calls by
  group size and by whether the group's ranks lie in one node of
  ``HW["gpus_per_node"]``;
* ``memory``: the peak of live bytes (storages rounded up to the caching
  allocator's 512 B) and its split by category at that moment:
  ``parameters``, ``optimizer_state``, ``inputs`` (the rank's batch rows;
  in decode its cache), ``activations`` (made in a forward under autograd),
  ``gradients`` (made in a backward: gradients and the backward's
  temporaries), ``temporaries`` (made with autograd off: the update, a
  serving step's work);
* ``fits``: the peak within ``HW["hbm_bytes"]``;
* ``reference_layout_bytes``: what a device would hold under the
  reference's layout (`dist.sharding.param_spec` for params and optimizer
  state, `dist.sharding.cache_spec` for the cache), beside the port's peak;
* ``roofline``: ``t_compute_s`` (each dtype's FLOPs over its own peak),
  ``t_memory_s`` (`launch.costs.analytic_bytes` over ``hbm_bw``),
  ``t_collective_s`` (each collective's ring bytes over NVLink or the NIC,
  by its group), ``t_memory_upper_s`` and ``bottleneck``;
* ``model_flops`` and ``useful_flops_ratio`` (both per device);
* ``hw``: the constants' source.

The records hold counts and bounds from specs, never a measured time but
``trace_s``. ``--save-hlo`` (the reference's flag, which saves the
compiled module's HLO text) writes the eager port's counterpart, rank 0's
program as the `Counter` saw it, to
``results/ops_{arch}_{shape}_{mesh}.txt`` and records the path under
``ops_text``: one line a counted op in dispatch order (`Counter`'s
``lines``). The lines are kept only when asked, so a cell without the
flag costs and records what it did.
Importing this module starts no process group and reads no environment
variable.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, skip_reason
from repro_torch.dist import sharding
from repro_torch.dist.pipeline import bubble_fraction, bubble_fraction_1f1b
from repro_torch.kernels import _build
from repro_torch.launch.mesh import HW, axis_sizes, link_bw, \
    make_production_mesh
from repro_torch.models.transformer import (ShardCtx, allocate,
                                            init_lm_params, keep_all,
                                            lm_param_specs, tree_items,
                                            tree_leaves)
from repro_torch.train.loop import block_cutter

RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "results")

# archs whose optimizer state must be factored (≥398B params)
BIG = {"kimi-k2-1t-a32b", "jamba-1.5-large-398b", "internvl2-76b"}

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
# c10d / functional-collective op names (leading '_' dropped) → kind
_COLL_PREFIX = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
                ("allgather", "all-gather"), ("all_gather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                ("send", "collective-permute"),
                ("recv", "collective-permute"))
BLOCK = 512          # the caching allocator's rounding of a block


# ---------------------------------------------------------------------------
# input_specs — meta stand-ins for every model input
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape_name: str) -> dict:
    """The global batch's inputs as tensors on ``meta`` (shapes and dtypes
    only), the reference's ``ShapeDtypeStruct`` stand-ins."""
    return batch_specs(configs.get_config(arch), SHAPES[shape_name])


def batch_specs(cfg, spec) -> dict:
    """`input_specs` of a config and a `ShapeSpec`."""
    b, s = spec.global_batch, spec.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = {}
    if spec.kind in ("train", "prefill"):
        toks = s - (cfg.prefix_len if cfg.frontend == "vision" else 0)
        out["tokens"] = meta((b, toks), torch.int32)
        if spec.kind == "train":
            out["labels"] = meta((b, toks), torch.int32)
        if cfg.family == "encdec":
            out["encoder_embeds"] = meta((b, s, cfg.d_model), torch.float32)
        if cfg.frontend == "vision":
            out["prefix_embeds"] = meta((b, cfg.prefix_len, cfg.d_model),
                                        torch.float32)
    else:                                   # decode: one new token + cache
        out["tokens"] = meta((b, 1), torch.int32)
    return out


def shape_spec(shape):
    """A `ShapeSpec` from its name, or the spec itself."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _axsize(mesh, axes) -> int:
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def cache_shardings(cache, cfg, mesh, *, dp, long_ctx: bool,
                    seq_shard_fallback: bool = False) -> dict:
    """{cache leaf path: `dist.sharding.cache_spec`} of a cache tree."""
    return {p: sharding.cache_spec(p, tuple(leaf.shape), cfg, mesh, dp=dp,
                                   long_ctx=long_ctx,
                                   seq_shard_fallback=seq_shard_fallback)
            for p, leaf in tree_items(cache)}


# ---------------------------------------------------------------------------
# Wire bytes, roofline terms, MODEL_FLOPS (pure arithmetic, the reference's)
# ---------------------------------------------------------------------------

def wire_bytes(coll: dict, n_chips: int) -> float:
    """Effective per-chip traffic (ring formulas).

    all-reduce ≈ 2·size·(n−1)/n; ag/rs ≈ size·(n−1)/n (size = full tensor);
    a2a ≈ size·(n−1)/n; permute = size."""
    f = (n_chips - 1) / max(n_chips, 1)
    return (2 * coll["all-reduce"] * f + coll["all-gather"] * f +
            coll["reduce-scatter"] * f + coll["all-to-all"] * f +
            coll["collective-permute"])


def collective_seconds(groups: list) -> float:
    """Σ over a rank's collectives of their ring bytes (`wire_bytes` at the
    group's own size) over NVLink inside a node, else the NIC."""
    t = 0.0
    for g in groups:
        coll = dict.fromkeys(KINDS, 0)
        coll[g["kind"]] = g["bytes"]
        t += wire_bytes(coll, g["group"]) / link_bw(g["intra_node"])
    return t


PEAK = {"f32": "peak_flops_f32", "bf16": "peak_flops_bf16",
        "int8": "peak_ops_int8"}


def roofline_terms(flops_by_dtype: dict, bytes_acc: float,
                   t_collective: float, bytes_upper: float = 0.0) -> dict:
    """The three roofline terms of one device, in seconds: each dtype's
    FLOPs over its own dense peak (any other dtype at the f32 peak), bytes
    over the HBM rate, and the collectives' time (`collective_seconds`)."""
    t_comp = sum(f / HW[PEAK.get(k, "peak_flops_f32")]
                 for k, f in flops_by_dtype.items())
    t_mem = bytes_acc / HW["hbm_bw"]
    dom = max(("compute", t_comp), ("memory", t_mem),
              ("collective", t_collective), key=lambda kv: kv[1])
    return {"t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_memory_upper_s": bytes_upper / HW["hbm_bw"],
            "t_collective_s": t_collective, "bottleneck": dom[0]}


def param_shapes(cfg, dtype=torch.bfloat16) -> dict:
    """The param tree on ``meta``: shapes and dtypes, no memory."""
    return init_lm_params(cfg, None, device="meta", dtype=dtype)


def model_flops(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference)
    + attention score/value FLOPs (standard MFU accounting; causal ⇒ S²/2,
    SWA ⇒ window-bounded, SSM mixers ⇒ no quadratic term)."""
    cfg = configs.get_config(arch)
    active = 0
    for name, leaf in tree_items(param_shapes(cfg)):
        n = int(math.prod(leaf.shape))
        if "_packed" in name:
            n *= 32                              # 1-bit storage, real MACs
        if "['moe']" in name and re.search(
                r"\['(up|gate|down)(_packed)?'\]", name):
            active += n * cfg.top_k // max(cfg.num_experts, 1)
        else:
            active += n
    spec = SHAPES[shape_name]
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
    mult = 6 if spec.kind == "train" else 2
    flops = mult * active * tokens

    # attention term: 4·H·hd FLOPs per (query, key) pair (QKᵀ + PV)
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.mixer_kind(i).startswith("attn"))
    n_local = sum(1 for i in range(cfg.num_layers)
                  if cfg.mixer_kind(i) == "attn_local" or
                  (cfg.sliding_window and not cfg.local_global and
                   cfg.mixer_kind(i) == "attn"))
    s = spec.seq_len
    per_pair = 4 * cfg.num_heads * cfg.hd
    if spec.kind == "decode":
        ctx_w = min(s, cfg.sliding_window or s)
        flops += spec.global_batch * per_pair * (
            (n_attn - n_local) * s + n_local * ctx_w)
    else:
        pairs_full = s * s / 2
        pairs_win = min(s * s / 2, s * (cfg.sliding_window or s))
        attn = spec.global_batch * per_pair * (
            (n_attn - n_local) * pairs_full + n_local * pairs_win)
        flops += attn * (3 if spec.kind == "train" else 1)
    return flops


# ---------------------------------------------------------------------------
# Pipeline bubble accounting (dist/pipeline helpers)
# ---------------------------------------------------------------------------

def pipeline_bubble_record(cfg, *, microbatches: int = 8) -> dict:
    """Schedule idle fractions if this arch's stage stack were pipelined:
    n = the natural stage partition (num_layers / period), M = the train
    cell's microbatch count."""
    n = cfg.num_layers // cfg.period
    return {"stages": n, "num_micro": microbatches,
            "gpipe_bubble": round(bubble_fraction(n, microbatches), 4),
            "1f1b_bubble": round(bubble_fraction_1f1b(n, microbatches), 4)}


def bubble_table(stages=(4,), micro=(4, 8, 16)) -> list:
    """gpipe-vs-1f1b idle fractions over (n, M)."""
    rows = []
    for n in stages:
        for m in micro:
            rows.append({"stages": n, "num_micro": m,
                         "gpipe_bubble": round(bubble_fraction(n, m), 4),
                         "1f1b_bubble": round(bubble_fraction_1f1b(n, m), 4)})
    return rows


def write_bubble_table(out_path: Optional[str] = None) -> str:
    out_path = out_path or os.path.join(RESULTS_DIR,
                                        "BENCH_bubble_fraction.json")
    rows = bubble_table()
    out_dir = os.path.dirname(out_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    print("| n | M | gpipe | 1f1b |")
    print("|---|---|-------|------|")
    for r in rows:
        print(f"| {r['stages']} | {r['num_micro']} | {r['gpipe_bubble']:.3f}"
              f" | {r['1f1b_bubble']:.3f} |")
    return out_path


# ---------------------------------------------------------------------------
# The fake world and the counter
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a ``world_size``-rank job on torch's ``fake`` backend:
    started here where no process group exists (and destroyed on exit); a
    fake group of the same size is used as it is. Refuses to run inside
    a real group."""
    if dist.is_initialized():
        if "fake" not in dist.get_backend() or \
                dist.get_world_size() != world_size:
            raise RuntimeError(
                f"fake_world({world_size}) inside a "
                f"{dist.get_backend()} group of {dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    # meta tensors need a backend of their own device type
    dist.init_process_group("cpu:fake,cuda:fake,meta:fake",
                            store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dtype_class(dtype: torch.dtype) -> str:
    """FLOP class of an operand dtype: ``f32``, ``bf16``, ``int8`` (every
    integer type) or the dtype's own name."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    if not dtype.is_floating_point and dtype != torch.bool:
        return "int8"
    return str(dtype).replace("torch.", "")


def collective_kind(name: str) -> Optional[str]:
    """The reference's kind of a c10d op name, or None."""
    name = name.lstrip("_")
    for prefix, kind in _COLL_PREFIX:
        if name.startswith(prefix):
            return kind
    return None


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _group_ranks(args) -> list:
    """The global ranks of the process group among a c10d op's args."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue                 # a ReduceOp, not a group
            return dist.get_process_group_ranks(pg)
    return [dist.get_rank()]


def _shapes(ts: list) -> str:
    """``f32[4, 8], i32[4]``: each tensor's dtype and shape."""
    return ", ".join(f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
                     for t in ts)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


class Counter(TorchDispatchMode):
    """Counts what a program does, op by op, real or fake.

    * ``flops``: by `dtype_class` of the first operand, from torch's own
      FLOP formulas (`torch.utils.flop_counter`) for the aten ops, and
      from the kernel wrappers' reports (`kernels._build.work`; their plain
      versions' ops are not counted), so a fake trace, a CPU run and a
      card run of one step count alike;
    * ``bytes``: each op's tensor inputs plus outputs (views skipped);
    * ``collectives``: one entry per c10d call: kind, bytes of its output
      (a list's summed), group size and whether its ranks lie in one node;
    * ``memory``: live storages by category (see the module's docstring),
      each rounded up to 512 B, and the peak with its split. Only storages
      made inside, or handed to `hold`, are seen;
    * ``lines`` (with ``lines=True``; else None): the program's text, one
      line a counted op, in dispatch order. ``op``: an aten (or other
      non-collective) op, the FLOPs it added and their class (``-``: none),
      its operands' and results' dtypes and shapes; ``kernel``: a
      wrapper's report, its 2·M·N·K, their class and its bytes; ``c10d``:
      a collective, its kind, group size, bytes and whether the group lies
      in one node. ``op`` and ``c10d`` lines add up to ``ops``.
    """

    def __init__(self, lines: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops: dict = {}
        self.bytes = 0
        self.kernels: dict = {}
        self.collectives: list = []
        self.ops = 0
        self.lines: Optional[list] = [] if lines else None
        self.live: dict = {}
        self.current: dict = {}
        self.peak = 0
        self.peak_by: dict = {}

    def __enter__(self):
        _build.WATCHERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.WATCHERS.remove(self)
        return super().__exit__(*exc)

    # -- memory ---------------------------------------------------------
    def _bump(self, category: str, size: int) -> None:
        self.current[category] = self.current.get(category, 0) + size
        total = sum(self.current.values())
        if total > self.peak:
            self.peak, self.peak_by = total, dict(self.current)

    def _add(self, st, category: str) -> None:
        key = st._cdata
        if key in self.live:
            return
        size = -(-st.nbytes() // BLOCK) * BLOCK
        self.live[key] = (size, category)
        weakref.finalize(st, self._free, key)
        self._bump(category, size)

    def _free(self, key) -> None:
        size, category = self.live.pop(key, (0, None))
        if category is not None:
            self.current[category] -= size

    def hold(self, tree, category: str) -> None:
        """Counts the storages of a tree's tensors made outside (the
        inputs) under ``category``."""
        for _, t in tree_items(tree):
            st = _storage(t) if isinstance(t, torch.Tensor) else None
            if st is not None:
                self._add(st, category)

    def add_bytes(self, category: str, nbytes: int) -> None:
        """Counts ``nbytes`` held for the whole run under ``category``."""
        self._bump(category, nbytes)

    @staticmethod
    def category() -> str:
        if torch._C._current_graph_task_id() != -1:
            return "gradients"
        return "activations" if torch.is_grad_enabled() else "temporaries"

    # -- work -----------------------------------------------------------
    def kernel(self, name: str, flops: int, kind: str, nbytes: int) -> None:
        if kind != "none":
            self.flops[kind] = self.flops.get(kind, 0) + flops
        self.bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1
        if self.lines is not None:
            self.lines.append(f"kernel {name} flops={flops} class={kind} "
                              f"bytes={nbytes}")

    def _collective(self, kind: str, args) -> None:
        nbytes = sum(t.numel() * t.element_size()
                     for t in _tensors(args[0] if args else []))
        ranks = _group_ranks(args)
        node = HW["gpus_per_node"]
        if kind == "collective-permute":
            me, peer = dist.get_rank(), ranks[min(args[2], len(ranks) - 1)]
            group, intra = 2, me // node == peer // node
        else:
            group = len(ranks)
            intra = len({r // node for r in ranks}) == 1
        self.collectives.append({"kind": kind, "bytes": nbytes,
                                 "group": group, "intra_node": intra})
        if self.lines is not None:
            self.lines.append(f"c10d {kind} group={group} bytes={nbytes} "
                              f"intra_node={intra}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        category = self.category()
        for t in _tensors(out):
            st = _storage(t)
            if st is not None:
                self._add(st, category)
        if _build.hidden():
            return out
        self.ops += 1
        k, flops = None, 0
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = collective_kind(func._opname)
            if kind is not None:
                self._collective(kind, args)
                return out
        elif not func.is_view:
            ins = _tensors(list(args) + list(kwargs.values()))
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + _tensors(out))
            formula = self._formulas.get(func._overloadpacket)
            if formula is not None and ins:
                k = dtype_class(ins[0].dtype)
                flops = int(formula(*args, **kwargs, out_val=out))
                self.flops[k] = self.flops.get(k, 0) + flops
        if self.lines is not None:
            ins = _tensors(list(args) + list(kwargs.values()))
            self.lines.append(f"op {func} flops={flops} class={k or '-'} "
                              f"({_shapes(ins)}) -> "
                              f"({_shapes(_tensors(out))})")
        return out

    # -- summary ----------------------------------------------------------
    def collective_summary(self) -> dict:
        """The reference's ``collectives`` block (bytes and ``counts`` by
        kind) plus ``groups``: by (kind, group size, one node)."""
        out = dict.fromkeys(KINDS, 0)
        counts = dict.fromkeys(KINDS, 0)
        groups: dict = {}
        for c in self.collectives:
            out[c["kind"]] += c["bytes"]
            counts[c["kind"]] += 1
            key = (c["kind"], c["group"], c["intra_node"])
            g = groups.setdefault(key, {"kind": c["kind"],
                                        "group": c["group"],
                                        "intra_node": c["intra_node"],
                                        "bytes": 0, "count": 0})
            g["bytes"] += c["bytes"]
            g["count"] += 1
        out["counts"] = counts
        out["groups"] = list(groups.values())
        return out

    def memory(self) -> dict:
        return {"peak_bytes": self.peak,
                "peak_by_category": dict(sorted(self.peak_by.items()))}


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One cell's program for rank 0: ``run()`` on the device it was built
    for (under the fake mode it was built in, for a fake one); ``held`` the
    (tree, category) pairs it holds before the run; ``input_bytes`` the
    rank's rows of the batch; ``layout_bytes`` the reference layout's
    bytes a device (params, optimizer state, cache); ``params`` the tree
    `launch.costs.analytic_bytes` reads."""
    cfg: Any
    run: Callable
    held: list
    input_bytes: int
    layout_bytes: int
    params: Any


def make_ctx(cfg, mesh, dp: tuple, a2a_quant: bool = False):
    """The reference's `ShardCtx` on ``mesh`` (None: the local path)."""
    if mesh is None:
        return None
    return ShardCtx(mesh=mesh, dp_axes=tuple(dp), tp_axis="model",
                    ep_axis="data" if cfg.num_experts else None,
                    a2a_quant=a2a_quant)


def layout_bytes(tree, cfg, mesh) -> int:
    """A device's bytes of ``tree`` under `dist.sharding.param_spec` (the
    whole tree without a mesh)."""
    if mesh is None:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    return sum(sharding.spec_block_bytes(
        sharding.param_spec(p, tuple(leaf.shape), cfg, mesh),
        tuple(leaf.shape), leaf.element_size(), mesh)
        for p, leaf in tree_items(tree))


def rank_tree(tree, cfg, mesh):
    """The tree a rank holds: its `dist.sharding.shard_tree` (the whole
    tree without a mesh)."""
    return tree if mesh is None else sharding.shard_tree(tree, cfg, mesh)


META = torch.device("meta")


def fake_device() -> torch.device:
    """A `FakeTensor`'s device: the card's where torch sees one, else the
    CPU's."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _params(cfg, dtype, packed: bool, device=None,
            generator: Optional[torch.Generator] = None, cut=keep_all):
    """The param tree, or the part ``cut`` keeps of each leaf
    (`models.transformer.materialize`): drawn from ``generator`` on a
    real device, left empty (constants filled) on a fake one; packed by
    `serve.packed.deploy_lm` where asked and the body is W1A8."""
    from repro_torch.serve.packed import deploy_lm
    device = device or META
    if generator is None:
        params = allocate(lm_param_specs(cfg), (), dtype,
                          torch.device(device), cut)
    else:
        params = init_lm_params(cfg, generator, device=device, dtype=dtype,
                                cut=cut)
    return deploy_lm(params) if packed and cfg.w1a8_body else params


def _batch(cfg, spec, rows: int, device) -> dict:
    """The rank's ``rows`` of each input (`batch_specs`), zeros on the
    device."""
    return {k: torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=device)
            for k, v in batch_specs(cfg, spec).items()}


def _nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def build_train_cell(arch: str, shape, mesh, *, microbatches: int = 8,
                     mode: str = "w1a8_train", cfg=None,
                     a2a_quant: bool = False, optimizer: str = "",
                     device=None, generator=None) -> Cell:
    """`make_train_step` on the rank's shard of the params and optimizer
    state (the local step without a mesh)."""
    from repro_torch.optim import adafactor, adamw
    from repro_torch.train.step import make_train_step
    cfg = cfg or configs.get_config(arch)
    spec = shape_spec(shape)
    device = device or META
    dp = sharding.dp_axes(mesh) if mesh is not None else ()
    big = arch in BIG
    dtype = torch.bfloat16 if big else torch.float32
    opt = {"adafactor": adafactor, "adamw": adamw}[
        optimizer or ("adafactor" if big else "adamw")](1e-3)
    ctx = make_ctx(cfg, mesh, dp if spec.global_batch >= _axsize(mesh, dp)
                   else (), a2a_quant)
    meta = init_lm_params(cfg, None, device="meta", dtype=dtype)
    layout = layout_bytes(meta, cfg, mesh) + \
        layout_bytes(opt[0](meta), cfg, mesh)
    # the rank's blocks, drawn a leaf at a time: the whole tree is never
    # held
    params = _params(cfg, dtype, False, device, generator,
                     keep_all if mesh is None else block_cutter(
                         sharding.tree_shardings(meta, cfg, mesh), mesh))
    opt_state = opt[0](params)
    step = make_train_step(cfg, opt, mode=mode, microbatches=microbatches,
                           ctx=ctx, remat=True)
    glob = _batch(cfg, spec, spec.global_batch, device)
    rows = spec.global_batch // _axsize(mesh, ctx.dp_axes if ctx else ())

    def run():
        with torch.no_grad():
            return step(params, opt_state, glob)
    held = [(params, "parameters"), (opt_state, "optimizer_state")]
    if mesh is None:
        held.append((glob, "inputs"))
    return Cell(cfg, run, held,
                0 if mesh is None else
                _nbytes(glob) * rows // spec.global_batch, layout, meta)


def build_prefill_cell(arch: str, shape, mesh, *, mode: str = "w1a8_eval",
                       packed: bool = True, cfg=None,
                       a2a_quant: bool = False, device=None,
                       generator=None, dtype=torch.bfloat16) -> Cell:
    """`lm_forward` on the serving rank's tree and rows of the batch."""
    from repro_torch.models.transformer import lm_forward
    cfg = cfg or configs.get_config(arch)
    spec = shape_spec(shape)
    device = device or META
    dp = sharding.dp_axes(mesh) if mesh is not None else ()
    whole = _params(cfg, dtype, packed, device, generator)
    params = rank_tree(whole, cfg, mesh)
    layout = layout_bytes(whole, cfg, mesh)
    long_ctx = spec.global_batch < _axsize(mesh, dp)
    ctx = make_ctx(cfg, mesh, () if long_ctx else dp, a2a_quant)
    rows = spec.global_batch // _axsize(mesh, ctx.dp_axes if ctx else ())
    batch = _batch(cfg, spec, rows, device)

    def run():
        kw = {k: v for k, v in batch.items() if k != "tokens"}
        with torch.no_grad():
            return lm_forward(cfg, params, batch["tokens"], mode=mode,
                              ctx=ctx, remat=True, **kw)
    return Cell(cfg, run, [(params, "parameters"), (batch, "inputs")], 0,
                layout, whole)


def build_decode_cell(arch: str, shape, mesh, *, mode: str = "w1a8_eval",
                      packed: bool = True, cfg=None, a2a_quant: bool = False,
                      cache_seq_shard: bool = False, device=None,
                      generator=None, dtype=torch.bfloat16) -> Cell:
    """`decode_step` on the serving rank's tree, rows and cache."""
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.engine import decode_step
    cfg = cfg or configs.get_config(arch)
    spec = shape_spec(shape)
    device = device or META
    dp = sharding.dp_axes(mesh) if mesh is not None else ()
    long_ctx = spec.global_batch < _axsize(mesh, dp)
    whole = _params(cfg, dtype, packed, device, generator)
    params = rank_tree(whole, cfg, mesh)
    ctx = make_ctx(cfg, mesh, () if long_ctx else dp, a2a_quant)
    rows = spec.global_batch // _axsize(mesh, ctx.dp_axes if ctx else ())
    cache = init_cache(cfg, rows, spec.seq_len, dtype=dtype, device=device,
                       ctx=ctx)
    layout = layout_bytes(whole, cfg, mesh)
    if mesh is None:
        layout += layout_bytes(cache, cfg, None)
    else:
        meta_cache = init_cache(cfg, spec.global_batch, spec.seq_len,
                                dtype=dtype, device="meta")
        specs = cache_shardings(meta_cache, cfg, mesh, dp=dp,
                                long_ctx=long_ctx,
                                seq_shard_fallback=cache_seq_shard)
        layout += sum(sharding.spec_block_bytes(
            specs[p], tuple(leaf.shape), leaf.element_size(), mesh)
            for p, leaf in tree_items(meta_cache))
    tokens = torch.zeros((rows, 1), dtype=torch.int32, device=device)

    def run():
        with torch.no_grad():
            return decode_step(cfg, params, cache, tokens, mode=mode,
                               ctx=ctx)
    return Cell(cfg, run, [(params, "parameters"), (cache, "inputs"),
                           ((tokens,), "inputs")], 0, layout, whole)


def build_cell(arch: str, shape, mesh, **kw) -> Cell:
    kind = shape_spec(shape).kind
    if kind == "train":
        kw.pop("packed", None)
        kw.pop("cache_seq_shard", None)
        return build_train_cell(arch, shape, mesh, **kw)
    kw.pop("microbatches", None)
    kw.pop("optimizer", None)
    if kind == "prefill":
        kw.pop("cache_seq_shard", None)
        return build_prefill_cell(arch, shape, mesh, **kw)
    return build_decode_cell(arch, shape, mesh, **kw)


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def count(cell: Cell, lines: bool = False) -> tuple:
    """(counter, seconds) of one run of ``cell`` under a `Counter` that
    holds the cell's inputs (and keeps its ``lines`` where asked)."""
    counter = Counter(lines)
    for tree, category in cell.held:
        counter.hold(tree, category)
    counter.add_bytes("inputs", cell.input_bytes)
    t0 = time.perf_counter()
    with counter:
        cell.run()
    return counter, time.perf_counter() - t0


def trace(build: Callable, *, fake: bool = False,
          lines: bool = False) -> tuple:
    """(cell, counter, seconds) of ``build(device)``'s cell run once under
    a `Counter` (keeping its ``lines`` where asked): on ``meta``, or with
    ``fake`` under a fresh ``FakeTensorMode`` on `fake_device`."""
    if not fake:
        cell = build(META)
        return (cell,) + count(cell, lines)
    with fake_mode():
        cell = build(fake_device())
        return (cell,) + count(cell, lines)


def write_ops(path: str, counter: Counter, title: str) -> str:
    """Writes ``counter``'s lines to ``path`` under a ``#`` line of
    ``title``; returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# {title}\n")
        f.writelines(line + "\n" for line in counter.lines)
    return path


def counted_record(counter: Counter) -> dict:
    """The ``cost`` and ``collectives`` blocks of a counter."""
    flops = dict(sorted(counter.flops.items()))
    return {"cost": {"flops": float(sum(flops.values())),
                     "flops_by_dtype": flops,
                     "bytes_accessed": float(counter.bytes),
                     "kernel_calls": dict(sorted(counter.kernels.items())),
                     "ops": counter.ops},
            "collectives": counter.collective_summary()}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             microbatches: int = 8, save_hlo: bool = False, **kw) -> dict:
    n_chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
           "chips": n_chips, "hw": HW["name"]}
    skip = skip_reason(arch, shape_name)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        rec["pipeline_bubble"] = pipeline_bubble_record(
            configs.get_config(arch), microbatches=microbatches)
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        cell, counter, secs = trace(lambda dev: build_cell(
            arch, shape_name, mesh, microbatches=microbatches, device=dev,
            **kw), lines=save_hlo)
    rec["trace_s"] = round(secs, 1)
    if save_hlo:
        rec["ops_text"] = write_ops(
            os.path.join(RESULTS_DIR, f"ops_{arch}_{shape_name}_"
                                      f"{rec['mesh']}.txt"), counter,
            f"rank 0 of {arch} x {shape_name} x {rec['mesh']}: "
            f"{counter.ops} ops, {len(counter.collectives)} c10d")
    rec.update(counted_record(counter))
    rec["memory"] = counter.memory()
    rec["fits"] = counter.peak <= HW["hbm_bytes"]
    rec["reference_layout_bytes"] = cell.layout_bytes
    rec["reference_layout_fits"] = cell.layout_bytes <= HW["hbm_bytes"]
    from repro_torch.launch.costs import analytic_bytes
    ana = analytic_bytes(cell.cfg, spec, cell.params, n_chips,
                         microbatches=microbatches,
                         cache_seq_shard=kw.get("cache_seq_shard", False))
    rec["bytes_analytic"] = ana
    coll = rec["collectives"]
    rec["collective_wire_bytes_per_chip"] = wire_bytes(coll, n_chips)
    rec["roofline"] = roofline_terms(
        rec["cost"]["flops_by_dtype"], ana,
        collective_seconds(coll["groups"]), rec["cost"]["bytes_accessed"])
    mf = model_flops(arch, shape_name) / n_chips
    rec["model_flops"] = mf
    flops = rec["cost"]["flops"]
    rec["useful_flops_ratio"] = mf / flops if flops else None
    rec["status"] = "ok"
    return rec


def run_matrix(run: Callable, archs, shapes, meshes, out_path: str,
               label: str) -> list:
    """Runs ``run(arch, shape, multi_pod=)`` over the matrix, appending to
    ``out_path`` (cells already ``ok`` or ``skipped`` there are kept and
    not rerun) and writing it after every cell."""
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = [r for r in json.load(f)
                       if r.get("status") in ("ok", "skipped")]
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name(mp)) in done:
                    continue
                print(f"=== {label}{arch} × {shape} × {mesh_name(mp)}",
                      flush=True)
                t0 = time.perf_counter()
                try:
                    rec = run(arch, shape, multi_pod=mp)
                except Exception as e:                     # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(mp), "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                wall = round(time.perf_counter() - t0, 1)
                results.append(rec)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
                stat = rec.get("status")
                extra = ""
                if stat == "ok":
                    r = rec["roofline"]
                    extra = (f" comp={r['t_compute_s']:.4g}s "
                             f"mem={r['t_memory_s']:.4g}s "
                             f"coll={r['t_collective_s']:.4g}s "
                             f"→ {r['bottleneck']}")
                    if "memory" in rec:
                        extra += (f" peak={rec['memory']['peak_bytes'] / 2**30:.1f}"
                                  f" GiB fits={rec['fits']}")
                elif stat == "error":
                    extra = " " + rec["error"][:200]
                print(f"    {stat}{extra} ({wall} s)", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write rank 0's traced program, one line an "
                         "op, kernel call and collective in dispatch "
                         "order, to results/ops_{arch}_{shape}_{mesh}.txt")
    ap.add_argument("--bubble-table", action="store_true",
                    help="write results/BENCH_bubble_fraction.json (gpipe "
                         "vs 1f1b idle fractions) and exit")
    args = ap.parse_args(argv)
    if args.bubble_table:
        print(f"wrote {write_bubble_table(args.out)}")
        return 0
    archs = list(configs.ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out = args.out or os.path.join(RESULTS_DIR, "dryrun.json")
    results = run_matrix(lambda arch, shape, multi_pod: run_cell(
        arch, shape, multi_pod=multi_pod, save_hlo=args.save_hlo),
        archs, shapes, meshes, out, "")
    return 1 if any(r.get("status") == "error" for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
