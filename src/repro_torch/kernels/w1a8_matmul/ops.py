"""Public wrappers for the W1A8 packed matmul kernels.

`w1a8_matmul` runs the kernel of ``config.accum``: ``csrc/w1a8_matmul.cu``
(dot: bf16(a·Mul_prev) against ±1, f32 sum) or
``csrc/w1a8_matmul_popcount.cu`` (popcount: exact int32 sum over the codes'
bit-planes, after folding a per-channel Mul_prev into the codes and the
uniform step m̄ into Div; ``mul_prev=None`` means the caller has done so).
Where `geometry.decodes` (M ≤ DECODE_MAX_M rows over K ≥ DECODE_MIN_K)
the popcount route launches the library's decode entry
(`geometry.decode_launch`; its launches counted on `DECODE_KERNEL` as a
share of `POPCOUNT_KERNEL`'s), elsewhere the PR-15 tile
(`geometry.matmul_launch`).
`w1a8_matmul_grouped` launches the popcount kernel's grouped entry once
for a stack of experts (the MoE FFN's packed experts), the decode tile at
cap ≤ DECODE_MAX_M (`geometry.grouped_launch`).
`w1a8_matmul_int` runs ``csrc/w1a8_matmul_int.cu``, the exact int32 sum
Σ_k sign·a (the reference forms it as (a − 128)·(±1) plus 128·colsum).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``; a fake or meta tensor gives the result's shape
alone (`_build.shape_only`), and every call reports its work
(`_build.work`). Leading dims of ``a_u8`` fold into M. All three
kernels run on the tensor cores with the launch geometry of
`geometry.matmul_launch` (the int kernel with popcount's), the popcount
kernel's decode route with `geometry.decode_launch`'s; they mask the
ragged M, N and K edges themselves, so nothing is padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import pack_signs, packed_dim
from repro_torch.core.quant import fold_codes_to_uniform_step
from repro_torch.kernels import _build
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.w1a8_matmul import geometry
from repro_torch.kernels.w1a8_matmul import ref as _ref
from repro_torch.kernels.w1a8_matmul.geometry import matmul_launch

# (..., m, k, n, out_step, quant, grid_x, grid_y, bm, bn, wm, wn, threads,
# stream)
_GEOMETRY_ARGS = [_build.I] * 3 + [_build.F] + [_build.I] * 8 + [_build.P]
KERNEL = _build.Kernel("w1a8_matmul.cu", "w1a8_matmul",
                       [_build.P] * 6 + _GEOMETRY_ARGS)
POPCOUNT_KERNEL = _build.Kernel("w1a8_matmul_popcount.cu",
                                "w1a8_matmul_popcount",
                                [_build.P] * 5 + _GEOMETRY_ARGS)
# (a, w, div, bias, out, m, k, n, out_step, quant, blocks, threads, bm, bn,
# wm, wn, cs, stream): the popcount entry's decode route, a share of its
# launches
DECODE_KERNEL = _build.Kernel("w1a8_matmul_popcount.cu",
                              "w1a8_matmul_popcount_decode",
                              [_build.P] * 5 + [_build.I] * 3 + [_build.F]
                              + [_build.I] * 8 + [_build.P],
                              share_of=POPCOUNT_KERNEL)
# (a, w, div, bias, counts, out, experts, cap, k, n, decode, blocks,
# threads, bm, bn, wm, wn, cs, stream)
GROUPED_KERNEL = _build.Kernel("w1a8_matmul_popcount.cu",
                               "w1a8_matmul_popcount_grouped",
                               [_build.P] * 6 + [_build.I] * 12 + [_build.P])
# (a, w, out, m, k, n, grid_x, grid_y, bm, bn, wm, wn, threads, stream)
INT_KERNEL = _build.Kernel("w1a8_matmul_int.cu", "w1a8_matmul_int",
                           [_build.P] * 3 + [_build.I] * 10 + [_build.P])


def w1a8_matmul(a_u8: torch.Tensor, w_packed: torch.Tensor,
                mul_prev: Optional[torch.Tensor], div_post: torch.Tensor,
                bias: torch.Tensor, *, k: int,
                config: Optional[KernelConfig] = None) -> torch.Tensor:
    """y = ((a ⊙ mul_prev) @ unpack(w_packed)) ⊙ div_post + bias [+ requant].

    a_u8: (..., ≥k) uint8 codes; w_packed: (ceil(k/32), N) int32 words;
    mul_prev: (k,) f32 (None: popcount on folded operands); div_post,
    bias: (N,) f32. Returns (..., N) f32, or uint8 codes when
    ``config.out_step`` is set.
    """
    cfg = config if config is not None else KernelConfig(op="matmul")
    if cfg.op != "matmul":
        raise ValueError(f"config.op={cfg.op!r} does not match 'matmul'")
    lead = a_u8.shape[:-1]
    n = w_packed.shape[1]
    a2 = a_u8.reshape(-1, a_u8.shape[-1])[:, :k]
    popcount = cfg.accum == "popcount"
    if popcount:
        a2, div_post = fold_operands(a2, mul_prev, div_post)
        mul_prev = None
    elif mul_prev is None:
        raise ValueError("accum='dot' needs mul_prev")
    name = "w1a8_matmul_popcount" if popcount else "w1a8_matmul"
    with _build.work(name, 2 * a2.shape[0] * n * k,
                     "int8" if popcount else "bf16",
                     _build.nbytes(a2, w_packed, mul_prev, div_post, bias)
                     ) as out:
        if _build.shape_only(a2):
            _check(a2, w_packed, k)
            y = _result(a2.shape[0], n, cfg, a2.device)
        elif a2.is_cuda:
            y = _launch(POPCOUNT_KERNEL if popcount else KERNEL, a2,
                        w_packed, mul_prev, div_post, bias, k, cfg)
        elif popcount:
            y = _ref.w1a8_matmul_popcount_ref(a2, w_packed, k, div_post,
                                              bias, cfg.out_step)
        else:
            y = _ref.w1a8_matmul_ref(a2, w_packed, k, mul_prev, div_post,
                                     bias, cfg.out_step)
        out.append(y)
    return y.reshape(lead + (n,))


def _result(m: int, n: int, cfg: KernelConfig, dev) -> torch.Tensor:
    """The (m, n) result: uint8 codes with ``cfg.out_step``, else f32."""
    quant = cfg.out_step is not None
    return torch.empty((m, n), dtype=torch.uint8 if quant else torch.float32,
                       device=dev)


def fold_operands(a_u8: torch.Tensor, mul_prev: Optional[torch.Tensor],
                  div_post: torch.Tensor) -> tuple:
    """Popcount's consumer-side fold: the codes onto the uniform step m̄
    (`core.quant.fold_codes_to_uniform_step`, along the last axis) and
    div·m̄, in the reference's order; ``mul_prev=None`` means done."""
    if mul_prev is None:
        return a_u8, div_post
    codes, mbar = fold_codes_to_uniform_step(a_u8, mul_prev.to(a_u8.device))
    return codes, div_post.to(a_u8.device, torch.float32) * mbar


def _check(a2: torch.Tensor, w_packed: torch.Tensor, k: int) -> None:
    if a2.dtype != torch.uint8:
        raise TypeError(f"a_u8 must be uint8, got {a2.dtype}")
    if w_packed.dtype != torch.int32 or w_packed.shape[0] != packed_dim(k):
        raise ValueError(f"w_packed must be int32 ({packed_dim(k)}, N), got "
                         f"{w_packed.dtype} {tuple(w_packed.shape)}")


def _launch(kernel: _build.Kernel, a2, w_packed, mul_prev, div_post, bias,
            k: int, cfg: KernelConfig) -> torch.Tensor:
    """Launches the dot kernel, or the popcount kernel when ``mul_prev`` is
    None."""
    m = a2.shape[0]
    n = w_packed.shape[1]
    dev = a2.device
    _check(a2, w_packed, k)
    a2 = a2.contiguous()
    w = w_packed.to(dev).contiguous()

    def vec(x):
        return x.to(dev, torch.float32).reshape(-1).contiguous()
    div, bs = vec(div_post), vec(bias)
    mul = None if mul_prev is None else vec(mul_prev)
    if (mul is not None and mul.numel() != k) or div.numel() != n \
            or bs.numel() != n:
        raise ValueError("mul_prev must be (k,), div_post and bias (N,)")
    quant = cfg.out_step is not None
    out = _result(m, n, cfg, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    epilogue = (float(cfg.out_step if quant else 1.0), int(quant))
    if kernel is POPCOUNT_KERNEL and geometry.decodes(m, k):
        d = geometry.decode_launch(m, k, n)
        DECODE_KERNEL(a2.data_ptr(), w.data_ptr(), div.data_ptr(),
                      bs.data_ptr(), out.data_ptr(), m, k, n, *epilogue,
                      d.blocks, d.threads, d.bm, d.bn, d.wm, d.wn, d.cs,
                      stream)
        return out
    g = matmul_launch(m, n, cfg.accum)
    ptrs = [a2.data_ptr(), w.data_ptr()]
    if mul is not None:
        ptrs.append(mul.data_ptr())
    kernel(*ptrs, div.data_ptr(), bs.data_ptr(), out.data_ptr(), m, k, n,
           *epilogue, *g.grid, g.bm, g.bn, g.wm, g.wn, g.threads, stream)
    return out


def w1a8_matmul_grouped(a_u8: torch.Tensor, w_packed: torch.Tensor,
                        counts: torch.Tensor, div_post: torch.Tensor,
                        bias: torch.Tensor, *, k: int) -> torch.Tensor:
    """One popcount matmul per expert, in one launch: y[e] = (a[e] @
    unpack(w_packed[e])) ⊙ div_post[e] + bias[e], the exact int32 sum
    times div, for the rows e holds; rows from counts[e] on are 0.

    a_u8: (E, cap, k) uint8 codes on one grid; w_packed: (E, ceil(k/32),
    N) int32 words; counts: (E,) int (read on the device: no block works
    for an expert with no row, and it reads none of its words); div_post,
    bias: (E, N) f32. Returns (E, cap, N) f32.
    """
    e, cap = a_u8.shape[0], a_u8.shape[1]
    n = w_packed.shape[-1]
    with _build.work("w1a8_matmul_popcount_grouped", 2 * e * cap * n * k,
                     "int8", _build.nbytes(a_u8, w_packed, counts, div_post,
                                           bias)) as out:
        if _build.shape_only(a_u8):
            _check_grouped(a_u8, w_packed, k)
            y = torch.empty((e, cap, n), dtype=torch.float32,
                            device=a_u8.device)
        elif a_u8.is_cuda:
            y = _launch_grouped(a_u8, w_packed, counts, div_post, bias, k)
        else:
            y = _ref.w1a8_matmul_grouped_ref(a_u8, w_packed, counts, k,
                                             div_post, bias)
        out.append(y)
    return y


def _check_grouped(a_u8, w_packed, k: int) -> None:
    e, n = a_u8.shape[0], w_packed.shape[-1]
    if a_u8.dtype != torch.uint8 or a_u8.shape[2] != k:
        raise TypeError(f"a_u8 must be uint8 (E, cap, {k}), got "
                        f"{a_u8.dtype} {tuple(a_u8.shape)}")
    if w_packed.dtype != torch.int32 or \
            tuple(w_packed.shape) != (e, packed_dim(k), n):
        raise ValueError(f"w_packed must be int32 ({e}, {packed_dim(k)}, N), "
                         f"got {w_packed.dtype} {tuple(w_packed.shape)}")


def _launch_grouped(a_u8, w_packed, counts, div_post, bias,
                    k: int) -> torch.Tensor:
    _check_grouped(a_u8, w_packed, k)
    e, cap = a_u8.shape[0], a_u8.shape[1]
    n = w_packed.shape[-1]
    dev = a_u8.device

    def flat(x, dtype, numel):
        x = x.to(dev, dtype).contiguous()
        if x.numel() != numel:
            raise ValueError(f"expected {numel} elements, got "
                             f"{tuple(x.shape)}")
        return x
    a = a_u8.contiguous()
    w = w_packed.to(dev).contiguous()
    div, bs = flat(div_post, torch.float32, e * n), \
        flat(bias, torch.float32, e * n)
    cnt = flat(counts, torch.int32, e)
    out = torch.empty((e, cap, n), dtype=torch.float32, device=dev)
    g = geometry.grouped_launch(e, cap, k, n)
    GROUPED_KERNEL(a.data_ptr(), w.data_ptr(), div.data_ptr(), bs.data_ptr(),
                   cnt.data_ptr(), out.data_ptr(), e, cap, k, n,
                   int(g.decode), g.blocks, g.threads, g.bm, g.bn, g.wm, g.wn,
                   g.cs, torch.cuda.current_stream(dev).cuda_stream)
    return out


def w1a8_matmul_int(a_u8: torch.Tensor, w_packed: torch.Tensor,
                    colsum: torch.Tensor) -> torch.Tensor:
    """Exact Σ_k sign[k, n]·a[m, k] in int32 (counterpart of
    ``w1a8_matmul_int_pallas``, which forms it as (a − 128)·(±1) plus
    128·colsum on the TPU's int8 unit).

    a_u8 (M, K) uint8; w_packed (ceil(K/32), N) int32; colsum (N,) or
    (1, N) int32 = Σ_{k<K} sign[k, n]. Returns (M, N) int32. The kernel
    contracts the uint8 codes as they are (u8·s8 on the int8 tensor
    cores), so it needs no zero-point correction and does not read
    colsum; its shape is still checked, and the plain version uses it.
    """
    m, k = a_u8.shape
    n = w_packed.shape[1]
    with _build.work("w1a8_matmul_int", 2 * m * n * k, "int8",
                     _build.nbytes(a_u8, w_packed, colsum)) as out:
        if _build.shape_only(a_u8):
            _check(a_u8, w_packed, k)
            y = torch.empty((m, n), dtype=torch.int32, device=a_u8.device)
        elif a_u8.is_cuda:
            y = _launch_int(a_u8, w_packed, colsum)
        else:
            y = _ref.w1a8_matmul_int_ref(a_u8, w_packed, colsum)
        out.append(y)
    return y


def _launch_int(a_u8, w_packed, colsum) -> torch.Tensor:
    m, k = a_u8.shape
    _check(a_u8, w_packed, k)
    n = w_packed.shape[1]
    if colsum.numel() != n:
        raise ValueError(f"colsum must hold N={n} sums, got "
                         f"{colsum.numel()}")
    dev = a_u8.device
    a = a_u8.contiguous()
    w = w_packed.to(dev).contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    g = matmul_launch(m, n, "popcount")
    INT_KERNEL(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, *g.grid,
               g.bm, g.bn, g.wm, g.wn, g.threads,
               torch.cuda.current_stream(dev).cuda_stream)
    return out


def w1a8_pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, N) float → (ceil(K/32), N) int32 sign words (deploy-time)."""
    return pack_signs(w, axis=0)
