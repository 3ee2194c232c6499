"""Port parity, the sharded MoE: `models.transformer._apply_moe` under a
`ShardCtx` (expert-parallel all-to-all, tensor-parallel expert hidden dim,
the uint8 dispatch wire) against `repro.models.transformer._apply_moe`
under the reference's ``ShardCtx`` on the CPU.

Two layouts. (1, 1): the port on a one-rank gloo group in this process,
JAX's ``shard_map`` on one CPU device. (data 2, model 2): four gloo ranks
(`torch_ranks.spawn`, once for the module), each with its row of the
batch and its block of the layer's leaves (`dist.sharding.shard_tree`),
against JAX's ``shard_map`` on four of the sixteen host devices
`conftest.py` forces, and against JAX's local `moe_ffn`. Reduced mixtral
at d_ff 64 (F and its packed words split over the model ranks) and 96 (3
packed words do not split: the packed layer runs F whole, its held
``up_packed`` gathered), reduced kimi-k2 (8 experts, a shared expert).
Every config has capacity_factor = num_experts, so nothing drops and EP
equals the local path. The four ranks also serve reduced mixtral whole
through greedy `generate(ctx=)`, held to their eager steps' tokens.

The quantizer inputs whose codes round across a tie are forced to the
reference's (`train.ties.forced_by_rows`: rows matched by content, since
a rank's buffer is laid out by expert shard).

Tolerances, and why:

* float and QAT: within 2e-5·max|y| of the reference's, as its own
  ``tests/dist_main.py::check_moe_ep`` (the TP sum adds the down
  projection's partial sums in another order).
* packed: within 1e-4·max|y| (tests/test_torch_moe.py's packed contract:
  the port sums code·sign exactly and scales once).
* the port's (1, 1) sharded path against its own local path: bit for bit
  with the wire off (the all-to-all and the sums over one rank are
  copies); with the wire on, bit for bit against the local path whose
  expert outputs are rounded through bf16 (the wire's codes · step
  re-quantize to the same codes, and the return leg is bf16).
* the model ranks of one data row: bit for bit (one all-reduce).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import packed as jpacked  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402

WORLD = 4
MODES = ("float", "w1a8_train", "packed")
# name: (arch, config overrides)
CASES = {"mixtral-ff64": ("mixtral-8x7b", {"d_ff": 64}),
         "mixtral-ff96": ("mixtral-8x7b", {}),
         "kimi-shared": ("kimi-k2-1t-a32b", {})}
B, S = 2, 6


def _case(name: str, mode: str):
    """(cfg, jcfg, numpy params, x (B, S, D) numpy, the mode to run)."""
    arch, over = CASES[name]
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **over)
    assert cfg.capacity_factor >= cfg.num_experts        # nothing drops
    jp = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    if mode == "packed":
        jp = jpacked._pack_moe(jp)
    p = {k: np.array(v) for k, v in jp.items()}
    x = np.random.default_rng(40).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, x, "w1a8_eval" if mode == "packed" else mode


def _jax_run(fn):
    """``fn()`` with every activation quantizer input of the reference
    recorded (any order: the port matches rows by content); the experts'
    LSQ replaced by its forward value."""
    recorded, real = [], jquant.quantize_act

    def recording(x, step):
        jax.debug.callback(lambda v: recorded.append(np.array(v)), x)
        return real(x, step)
    saved = jlayers.quantize_act, jmoe.lsq_fake_quant
    jlayers.quantize_act = jquant.quantize_act = recording
    jmoe.lsq_fake_quant = lambda x, step, gs: recording(x, step) * step
    try:
        out = np.asarray(fn())
        jax.effects_barrier()
    finally:
        jquant.quantize_act = real
        jlayers.quantize_act, jmoe.lsq_fake_quant = saved
    return out, recorded


def _jax_sharded(jcfg, p, x, mode, a2a: bool, n: int):
    mesh = jax.make_mesh((n // 2 or 1, min(n, 2)), ("data", "model"),
                         devices=jax.devices()[:n])
    ctx = jtransformer.ShardCtx(mesh, ("data",), "model", "data",
                                a2a_quant=a2a)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    fn = jax.jit(lambda jp, x: jtransformer._apply_moe(jp, jcfg, x, mode,
                                                       ctx))
    return _jax_run(lambda: fn(jp, jnp.asarray(x)))


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _tol(mode: str) -> float:
    return 1e-4 if mode == "packed" else 2e-5


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def one_rank():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_one_rank_against_reference(case, mode, one_rank):
    """(1, 1): the port's sharded layer against JAX's shard_map, wire off
    and on, and against the port's own local path."""
    cfg, jcfg, p, x, run = _case(case, mode)
    tp = _t(p)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        local = transformer._apply_moe(tp, cfg, xt, run, None)
    for a2a in (False, True):
        want, recorded = _jax_sharded(jcfg, p, x, run, a2a, 1)
        ctx = transformer.ShardCtx(one_rank, ("data",), "model", "data",
                                   a2a_quant=a2a)
        stack, counts = torch_ranks.forced_rows(recorded, 1)
        with torch.no_grad(), stack:
            got = transformer._apply_moe(tp, cfg, xt, run, ctx)
        _close(got, want, _tol(mode),
               f"{case} {mode} a2a={a2a} ({sum(map(sum, counts))} forced)")
        if not a2a:
            assert torch.equal(got, local), (case, mode)
        elif mode != "float":
            assert torch.equal(got, _local_bf16_return(tp, cfg, xt, run)), \
                (case, mode)


def _local_bf16_return(p, cfg, x, mode):
    """The local path with the experts' outputs rounded through bf16."""
    real = moe._expert_mm

    def rounded(p_, name, *args, **kw):
        y = real(p_, name, *args, **kw)
        return y.to(torch.bfloat16).to(y.dtype) if name == "down" else y
    moe._expert_mm = rounded
    try:
        with torch.no_grad():
            return transformer._apply_moe(p, cfg, x, mode, None)
    finally:
        moe._expert_mm = real


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every case, mode and wire on four ranks, with JAX's 2 × 2 shard_map
    and local moe_ffn results beside it."""
    cases, want = {}, {}
    for name in CASES:
        for mode in MODES:
            cfg, jcfg, p, x, run = _case(name, mode)
            local, rec_local = _jax_run(lambda: jmoe.moe_ffn(
                {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                jnp.asarray(x.reshape(B * S, -1)), mode=run))
            for a2a in (False, True):
                key = f"{name}-{mode}-{a2a}"
                sharded, rec = _jax_sharded(jcfg, p, x, run, a2a, WORLD)
                want[key] = {"local": local.reshape(x.shape),
                             "sharded": sharded}
                cases[key] = {"arch": CASES[name][0], "over": CASES[name][1],
                              "mode": run, "a2a": a2a, "params": p, "x": x,
                              "recorded": rec + rec_local}
    gen = {"arch": "mixtral-8x7b", "seed": 7, "max_new": 5, "max_len": 16,
           "prompts": np.random.default_rng(41).integers(
               0, configs.get_reduced("mixtral-8x7b").vocab_size,
               (4, 3)).astype(np.int32)}
    got = torch_ranks.spawn("moe_ep", WORLD, {"cases": cases,
                                              "generate": gen},
                            tmp_path_factory.mktemp("moe_ep_ranks"))
    return got, want


def _gathered(got: list, key: str) -> np.ndarray:
    """The data ranks' rows in order (model rank 0), after checking each
    data row's model ranks agree bit for bit."""
    rows = {}
    for r in got:
        d, _ = r["coords"]
        y = r[key]["y"]
        if d in rows:
            assert np.array_equal(rows[d], y), key
        rows[d] = y
    return np.concatenate([rows[d] for d in sorted(rows)])


@pytest.mark.parametrize("case", list(CASES))
def test_ep_moe_on_four_ranks_against_reference(case, four_ranks):
    """(data 2, model 2): every mode with the wire off and on against
    JAX's shard_map at the same layout; float and QAT with the wire off
    against JAX's local moe_ffn within 2e-5 (check_moe_ep's contract)."""
    got, want = four_ranks
    for mode in MODES:
        for a2a in (False, True):
            key = f"{case}-{mode}-{a2a}"
            y = _gathered(got, key)
            _close(y, want[key]["sharded"], _tol(mode), key)
            if mode != "packed" and not a2a:
                err = float(np.abs(y - want[key]["local"]).max())
                assert err < 2e-5, f"{key} against local: {err}"


@pytest.mark.parametrize("wire", [False, True])
def test_generate_on_four_ranks_equals_eager_steps(wire, four_ranks):
    """(data 2, model 2), reduced mixtral packed and served whole: each
    rank's greedy `generate(ctx=)` tokens, its ticks `decode_tick` under
    the ctx, equal the eager `decode_step(ctx=)` loop's bit for bit, with
    the uint8 dispatch wire off and on (on the card each tick is one CUDA
    graph replay of that tick, `chip_smoke.py` phase 15a)."""
    got, _ = four_ranks
    for r in got:
        rec = r[f"generate-{wire}"]
        assert rec["generate"].shape == (2, 5)
        assert np.array_equal(rec["generate"], rec["eager"]), r["coords"]


def test_plan_dispatch_carries_ep():
    cfg = configs.get_reduced("mixtral-8x7b")
    jcfg = jconfigs.get_reduced("mixtral-8x7b")
    for t in (1, 6, 12, 100):
        for ep in (1, 2, 4):
            assert dataclasses.astuple(moe.plan_dispatch(cfg, t, ep)) == \
                dataclasses.astuple(jmoe.plan_dispatch(jcfg, t, ep))


def test_moe_axes_follow_the_reference():
    """EP where the experts split, F split only where every F-indexed leaf
    splits (packed words too), the shared experts' F likewise: reduced
    mixtral at d_ff 96 packed on |model| 2 runs F whole."""
    class Mesh:                       # the axis sizes are all moe_axes reads
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}
    ctx = transformer.ShardCtx(Mesh(), ("data",), "model", "data")
    for name, (arch, over) in CASES.items():
        cfg = dataclasses.replace(configs.get_reduced(arch), **over)
        for packed in (False, True):
            slot = {"up_packed": None} if packed else {}
            ep, tp, tp_sh = transformer.moe_axes(cfg, slot, ctx)
            assert ep == "data"
            assert (tp == "model") == (
                cfg.d_ff % 2 == 0 and (not packed or (cfg.d_ff // 32) % 2
                                       == 0)), (name, packed)
            assert (tp_sh == "model") == bool(cfg.shared_experts)


def test_reference_sharded_act_step_gradient_scale():
    """What the port does not copy (ROADMAP.md, Queue 3): under the
    reference's shard_map the MoE act step's gradient takes LSQ's scale
    1/sqrt(rows · 255) from the shard's own buffer rows, E·cap of its 6
    tokens (cap 16), where the one-device step has E·cap of all 12 (cap
    24): sqrt(96 / 64) times the one-device gradient at data 2. Every
    other leaf's gradient, and the model axis's, equal the local ones.
    The port's sharded step scales to the one-device rows
    (tests/test_torch_sharded_step.py holds every leaf)."""
    cfg, jcfg, p, x, _ = _case("mixtral-ff96", "w1a8_train")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    g = np.random.default_rng(41).standard_normal(x.shape).astype(np.float32)
    grads = {}
    for shape in ((1, 1), (2, 2)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]])
        ctx = jtransformer.ShardCtx(mesh, ("data",), "model", "data")
        grads[shape] = jax.jit(jax.grad(lambda jp: jnp.sum(
            jtransformer._apply_moe(jp, jcfg, jnp.asarray(x), "w1a8_train",
                                    ctx) * g)))(jp)
    one, two = grads[(1, 1)], grads[(2, 2)]
    local = moe.plan_dispatch(cfg, S).capacity * cfg.num_experts
    whole = moe.plan_dispatch(cfg, B * S).capacity * cfg.num_experts
    assert (local, whole) == (64, 96)
    np.testing.assert_allclose(np.asarray(two["act_step"]),
                               np.asarray(one["act_step"])
                               * np.sqrt(whole / local), rtol=1e-5)
    for k in ("router", "up", "gate", "down"):
        _close(np.asarray(two[k]), np.asarray(one[k]), 2e-5, k)
