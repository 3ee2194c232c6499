#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Prints the card's name and power limit (nvidia-smi), builds the nine
   CUDA kernels from ``src/repro_torch/csrc`` with nvcc (in parallel) and
   prints the build seconds, each kernel's register use and spills and the
   count of tensor-core instructions (HMMA, HGMMA, IMMA) in each library's
   SASS (cuobjdump); the three dot libraries must hold HMMA, the three
   popcount ones, the int matmul's and the integer PE's IMMA, and no
   library may spill a register. Lists each ``__global__`` of the
   popcount matmul's library with its tensor-core instructions, registers
   and spill bytes (`popcount_globals`): each decode kernel must hold IMMA,
   spill nothing and hold at most `geometry.DECODE_REGS` registers, the
   residency its launch geometry counts on.
2. Holds each dot kernel against its plain PyTorch version on the card, at
   every W1A8 layer shape of the 320×320 detector with B = 4 and at one
   shape off its grid (B = 2, 18×18, Cin 24, Cout 40: Cin % 16 != 0, Cout
   % 32 != 0): f32 outputs within 6e-3·max|y|, uint8 codes within 1 LSB,
   the fused conv+pool kernel equal to the conv kernel plus a 2×2 max
   exactly, and results unchanged by the row blocking. The dot matmul also
   at three shapes off the grid, MATMUL_OFF_GRID (ragged M, N and K); at
   every matmul shape the rows of a call on a prefix of M, on
   ``a2[1:]`` and on a copy whose rows are not 16-byte aligned equal the
   full call's bit for bit (`row_checks`). Times each kernel,
   its plain version and one PyTorch library call at the layer shapes:
   the CUDA-event time of back-to-back calls and, for the kernel and the
   library call, the device time from torch.profiler (the union of the
   call's device intervals), which leaves out the host's cost.
3. The same for the binary domain, at every layer shape and the popcount
   convs also at the shape off the grid: each popcount kernel equal to its
   plain version (f32 outputs and codes), unchanged by `rows` 2, 3 and 4
   (each shape has a ragged last block under one of them), the fused
   popcount pool equal to the popcount conv plus a 2×2 max, and each
   popcount kernel bit-exact with the dot kernel of the layer under
   canonical operands (mul ≡ 1, div·m). The popcount matmul also at
   MATMUL_OFF_GRID, with the same row checks; at every matmul shape the int
   kernel equals its plain version and the popcount matmul's sum under
   div ≡ 1, bias ≡ 0, with the same row checks. Times each as in phase 2
   at the layer shapes (the int kernel beside ``torch._int_mm``), and
   prints each layer's device ms; then the device time of a one-element
   ``torch.add`` (the smallest launch, a floor for the kernels' times).
4. Checks that the committed autotune table
   (``src/repro_torch/kernels/AUTOTUNE_cuda.json``) holds its 22 entries
   for this card's `device_key` (else it fails, naming the key and the
   autotune command, so tuned serving never quietly equals dot) and holds
   each winner bit-exact against its accum mode's default config on the
   sweep's operands. Then drives the main path through the serving
   launcher (``repro_torch.launch.serve``: 16 random 320×320 uint8
   images, `slots=4`, `depth=2`) under ``--profile tuned`` and ``--profile
   default``, with every launch count set to 0 just before each run and
   read just after. Each dispatch is one CUDA graph replay per bucket and
   wire, and each replay adds its captured launches to the counts. The
   launcher checks zero drops, depth-K payloads bit-exact with depth 1 on
   both wires (the device-NMS wire over K ∈ {1, 2, 4, 8}), the device-NMS
   set equal to the raw-wire set, and the raw head within the
   `core.verify` envelope of the float forward; this script checks that
   the raw-wire depth-2 serve's launches equal its dispatches times the
   launches `per_dispatch` derives from the backend's resolved configs at
   320 (`DetectionBackend.configs`), and prints those configs per layer.
   It drives ``--workload multires --buckets 256,320`` on 16 requests
   (each bucket's raw heads bit-exact with the bucket served alone; at
   256 no entry is exact, so tuned serves the nearest entries' dot
   configs), counted the same way, each bucket's kernels launched, and
   profiles 8 dispatches under each profile (`launch.profile`): device
   busy, device records and idle share per dispatch.
5. Drives the popcount forward, ``yolo_forward_kernel(accum="popcount")``,
   at full width (B = 4, 320×320) on a per-channel artifact, once per pool
   route, with every launch count zeroed before and read after: launches
   (4, 4, 1) for (conv3x3_pool2_popcount, conv3x3_popcount,
   matmul_popcount) on the fused route and (0, 8, 1) on the unfused one,
   the two raw heads bit-identical and within the `core.verify` envelope of
   the float forward; once the dot forward on the fused route, counted the
   same way (4, 4, 1) for the three dot kernels, its raw head in the same
   envelope. On a per-tensor artifact the popcount and dot raw
   heads differ by less than 0.02. Then the int path: one
   `w1a8_matmul_int` call at conv9's shape on the detector's conv9 sign
   words, counted the same way and checked against the integer product.
   Prints each route's ms per forward beside the dot forward's: the
   CUDA-event time of back-to-back forwards, and from torch.profiler the
   device busy time, which excludes the host's gaps between launches.
6. The post-processing kernel (``csrc/detect_nms.cu``) and the graphs: a
   graph replay of each wire's backend equals a direct eager ``_forward``
   on the same images bit for bit, each replay launches
   ``detect_postprocess`` once and ``detect_nms`` never, and a profile of
   one dispatch gives its device records and busy ms. Both entry points,
   ``postprocess`` on the raw head and ``nms`` on ``decode_head``'s boxes,
   equal ``decode_head`` + ``nms_plain`` run on the card bit for bit: on
   the heads that replay served at 320 (and the served detections equal
   them), on a batch at 256 (G = 8, 192 boxes), on the score-separated
   fixture and on every head of ``launch/nms_fixtures.HEADS``; ``nms`` also
   on the tie fixture at both thresholds. Times the kernel, ``nms`` on the
   decoded heads, ``decode_head`` and the plain pair at the served shape
   (B = 4, 300 boxes, 20 classes) and counts the tiles of 32 ranks the
   sweep visited; no single PyTorch call computes greedy NMS.
7. The integer PE (``csrc/w1a8_int_pe.cu``, the integer golden datapath's
   one kernel, on the int8 tensor cores over signed digit planes): each of
   its entry points (W1A8, conv1, head) bit for bit against its plain
   version on the card at every layer shape of the 320 path at B = 1 and
   4 (the deployed artifact's constants and planes, random codes), off the
   grid (B = 2, 18×18, Cin 3, 16, 24, 48 and 128, ragged Cout) for every
   kind, ksize and pool it takes, with random m, mult, shift (0 included)
   and int40 biases, on overflow operands (m_raw ≈ 2^17, codes 255, every
   sign +1 at K = 1152: |acc| > 3e10, past int32, 3 planes), on m_raw of
   1 to 10 planes (INT64_MIN the tenth; numpy's int64 sum wraps from 8 on)
   at the W1A8 kind pooled and not and at the head, and on a head with
   negative values on rounding ties; times each layer at B = 4 (as in
   phase 2, beside ``F.conv2d`` in float64 on codes·m_raw, exact here) and
   prints its plane count and its device ms before the redesign (the
   int64 CUDA-core PE's, from PERF.md).
   Then drives ``yolo_forward_int`` at B = 4, 320×320 with every launch
   count zeroed before and read after: one integer PE launch per layer
   (11) and no other kernel, the int64 raw head equal to the plain
   version's on the CPU, inside the envelope of
   ``tests/test_yolo.py::test_int_pipeline_alignment`` (max_abs < 0.02,
   mean_abs < 0.002, 100% within 1 LSB of 0.02) against the float
   forward; prints its CUDA-event and device ms per forward and
   ``launch/alignment.py``'s rows (the paper's Table 6 checkpoints at 320).
8. Prints one ``{"kernels": [...]}`` line with the eleven kernels of the
   nine sources (the popcount matmul's decode route, whose launches are a
   share of its 2-D entry's, and its grouped entry beside the 2-D one;
   each kernel's launches summed over the driven paths, and by path: the
   three launcher runs, phase 5's forwards and int call, phase 7's
   integer forward, phase 9's QAT pipeline, phase 10's LM serve and int
   call, phase 11's launcher fleet, real traffic and compose runs, phase
   12's MoE and SSM serves and hybrid decode, phase 13's trained model
   served, phase 15's sharded MoE serves and its `generate(ctx=)` tick
   replays, phase 16's kernel suite under ``tables``, phase 17's rank 0
   decode step and tick replay, phase 19's tick replays; the two
   matmuls also their
   numbers at the LM shapes, under ``lm``, the popcount matmul phase 13's
   launches under ``lm_trained``, the grouped entry its phase 12a
   shapes, the decode route its phase 10a' shapes), phase 13's, 14's,
   15's, 17's and 19's summaries, and as the last line
   ``{"ok": true, "device": {...}}``.
9. Runs before phase 8's line: the paper's offline workflow (QAT, deploy,
   integer forward, Table 6, decode + NMS). (9a) One QAT train step of
   the eager body (`train.yolo_qat.make_eager_step`) at B = 2, 320×320,
   on the card against the same step on the CPU from the same params and
   batch, with cuDNN's TF32 flag at its default outside the trainer: loss
   and gradient norm within rtol 1e-4, each gradient leaf within
   1e-3·max|g| (codes that round across a tie on one side only forced to
   the CPU's, `train.ties`), which a TF32 backward would miss (its error
   is printed). (9b) The trainer's step (`make_yolo_train_step`: one CUDA
   graph replay a step after its capture) against the eager body on the
   card over 3 steps at B = 16 from the same calibrated params and
   batches, with cuDNN restricted to its deterministic algorithms and
   then at its default: the eager body runs twice first and the two
   runs' difference is printed; where they agree bit for bit every param,
   mu, nu, step, loss and grad norm of the replay must too, else each
   step is taken again from the first run's state before it and the
   replay held within 9a's contract (loss and grad norm rtol 1e-4, each
   param and moment leaf 1e-3·max|x|); after the capture a step is one
   ``CUDAGraph.replay`` and no ``yolo_loss`` call, and no kernel of the
   port launches (cuDNN runs the convs). Then ``launch/train_yolo_qat.
   train``, 30 AdamW steps at B = 16, 320×320, in turns (replay, eager,
   eager, replay; eager with the trainer's step swapped for the eager
   body): the held-out loss must fall in each; ms a step (CUDA events),
   img/s, peak memory, the 30 steps' wall seconds and the host ms of each
   ``data.detection_batch`` call in the loop, the sampler's host ms a
   batch alone, and device busy ms, records and idle share a step of
   each (torch.profiler). On the last replayed run's params, each with
   every launch count zeroed before and read after: ``yolo_forward_int``
   on 4 test images (11 integer PE launches and no other kernel,
   bit-exact with the plain version, in ``tests/test_system.py``'s
   envelope of the float head: corr > 0.99, mean_abs < 0.01, 100% within
   1 LSB), ``postprocess`` on that head (one ``detect_postprocess``
   launch, bit for bit with ``decode_head`` + ``nms_plain`` on the card)
   and ``launch/alignment.py``'s Table 6 rows (the launches the kernel
   path's tuned configs give, and 12 integer PE launches).

10. Runs before phase 8's line: the LM stack's dense family. The popcount
   matmul, called as a packed projection calls it (one step broadcast to
   (K,), whose fold is the identity), and the int matmul through
   ``core/w1a8.py::w1a8_linear_infer_int``, each bit for bit against its
   plain version on the card at chatglm3-6b's shapes: decode (M = 4) and
   prefill (M = 4 × 3) at every (K, N) of a layer's projections, and
   (37, 13696, 2061) off the grid, with the row checks there; timed as in
   phase 3 beside f32 ``torch.matmul`` on codes·step and the unpacked ±1
   (the reference's arithmetic), the bound from K·N/8 + M·K + 4·M·N bytes.
   (a') The decode route alone (`check_decode_route`, DECODE_ROUTE_SHAPES:
   chatglm3-6b's decode (K, N) at M = 4, (5, 4100, 2061) off the grid with
   the row checks, M = 1, 8 and 16 at (4096, 13696), the requant among
   them): bit for bit against its plain version, each launch counted on
   ``w1a8_matmul_popcount_decode``; device ms from graph replays in turns
   with the PR-15 tile at the same shape (`tile_sweep.pr15_route`: PR 15,
   decode, decode, PR 15) beside the plain version, f32 ``torch.matmul``,
   the bound and a one-element ``torch.add`` in a graph (the floor).
   Then chatglm3-6b at full width from a seeded init on the card,
   deployed and served through the launcher's ``run_lm`` (packed, 8
   requests, 16 new tokens, slots 4, max_len 128; each decode tick one
   CUDA graph replay, its launches the capture's) with every launch count
   zeroed before and read after: done-mask tokens equal to host-checked
   ones, and per decode step exactly one popcount matmul launch a packed
   projection (7 × 28 = 196, derived from the config) and no other
   kernel. The packed prefill logits against the unpacked ``w1a8_eval``
   prefill on the card, tie codes forced (`train.ties`): within
   LM_TOL·max|logit|, greedy tokens equal wherever the top-2 gap exceeds
   that. One ``w1a8_linear_infer_int`` call, counted the same way (one int
   matmul launch), its sums equal to an int64 product on the CPU. Prints
   tok/s, tick p50/p95, the decode step's CUDA-event ms, device busy ms,
   idle share (torch.profiler) and bound, and peak memory, with the card's
   name and power limit; then phase 19c's tick timing on the same tree.

11. Runs before phase 8's line: the serving tiers above one backend, each
   with every launch count zeroed just before and read just after. (a) The
   launcher's ``detect`` at 320, tuned, ``--requests 512 --replicas 2
   --autoscale --out`` (a file under ``build/``): the launcher checks the
   fleet's payloads bit-exact with the single-scheduler device-NMS run, 0
   lost and 0 dropped; here each kernel's launches in the fleet run equal
   the dispatches summed over the replicas times `per_dispatch`. (b)
   ``launch.traffic --mode real`` at 320, 2 replicas, 256 requests: equal
   completed sets and payloads bit-exact with one replica, launches equal
   to both runs' dispatches times `per_dispatch`; prints img/s of each.
   (c) ``traffic.run_model`` at 2000 requests a cell, calibrated from
   (a)'s record: 0 lost in all 12 cells; prints the calibration and the
   SLO in ticks. (d) The launcher's ``run_compose`` at 320 with
   chatglm3-6b at full width on phase 10's f32 params (float mode, 8
   requests, 16 greedy tokens, slots 4): 0 lost, 0 duplicated, 8 hand-offs,
   prompts equal to the template, detect launches equal to its
   dispatches times `per_dispatch`; prints ticks, wall s and peak memory.

12. Runs before phase 8's line, after phases 10 and 11 freed their f32
   params: the LM stack's MoE, SSM and hybrid families, packed. (a) The
   popcount matmul's grouped entry (one launch for a stack of experts,
   each expert's count of kept rows read on the device) bit for bit
   against its plain version at mixtral-8x7b's (E 8; K, N 4096, 14336
   both ways), kimi-k2's (E 384; 7168, 2048 both ways) and jamba's (E 16;
   8192, 24576 both ways) expert shapes,
   at cap 8 (the decode tile) and 64 (the PR-15 tile), expert 0 empty,
   and at mixtral's cap 8 with every expert empty, one holding cap rows,
   and counts past cap and below 0; the work items the launch forms from
   the counts (none for an empty expert: at kimi-k2's cap 8 most of the
   384 launch no work); timed like phase 10a' (graph replays in turns
   with the PR-15 tile over the same items; the plain version on the
   checked call) beside f32 ``torch.bmm`` on codes·step and every
   expert's ±1, the bound from the words of the experts that hold rows
   and the floor. (b) mixtral-8x7b at full width and depth (32 layers), drawn
   and packed stage by stage (`init_packed_lm`, 6.37 GB), served through
   ``run_lm`` (8 requests, 16 tokens, slots 4) with every launch count
   zeroed before and read after: done-mask tokens equal to host-checked
   ones, per decode step 128 popcount and 96 grouped launches (derived
   from the config) and no other kernel; the decode step's CUDA-event
   ms, device busy ms and idle share (torch.profiler) and its bound (the
   dense words, the words of the experts that held rows in that step,
   the f32 unembedding); the tick as a graph replay and eager (phase
   19c). (c) Packed against unpacked ``w1a8_eval``
   prefill, tie codes forced, within PARITY_TOL·max|logit|: at
   mixtral's full width over 2 layers, mamba2-1.3b's over its 48 (the
   served tree against the f32 one of the same seed) and jamba's over its
   period with 2 experts (the f32 tree of 16 would be 155 GB). (d)
   mamba2-1.3b at full width and depth, served and timed as (b) (96
   popcount launches a step), its tick as (b)'s. (e)
   jamba-1.5-large-398b at full width over one period (8 layers: 1
   attention, 7 Mamba-1, 4 MoE), packed: prefill and 5 decode steps,
   each step's launches equal to the config's (30 popcount, 12 grouped),
   and the step timed as (b). (f) For (d) and (e) (at capacity_factor =
   num_experts, `plan_dispatch`'s no-drop bound, so that a token's
   experts do not depend on its batch), prefill and 5 greedy decode
   steps against one teacher-forced ``lm_forward`` of the prompt and the
   emitted tokens, the decode's tie codes forced to the forward's
   (`train.ties.forced_by_rows`): within TF_TOL·max|logit|, argmax equal where
   decided.

13. Runs before phase 8's line, after phase 12 freed its trees: LM QAT
   training on the card. (a) One `lm_loss` + gradient of chatglm3-6b at
   full width cut to 1 layer, B = 2, S = 32, ``w1a8_train``, on the card
   against the CPU from the same seeded params and the port's batch, TF32
   on globally, tie codes forced (`train.ties`): loss within 1e-5
   relative, each gradient leaf within 1e-3·max|g| (the worst printed,
   beside what a backward outside `full_f32` would give, and remat
   against none on the card). (b) chatglm3-6b at full width, 4 layers
   (1.08 B params), ``w1a8_train``, remat, B = 8 × S = 256 in 2
   microbatches, 10 AdamW steps through `run_train` under the launcher's
   schedule (lr 3e-4): the loss falls, and every update lowers its own
   batch's loss; the loss curve, each step's CUDA-event ms, tokens/s, peak memory, the device
   busy ms and idle share of a step (torch.profiler) and the bound (8·N·T
   f32 operations at 67 T/s against the state's bytes). (e) (b)'s trained
   params through `deploy_lm`: no leaf keeps a grad; packed prefill
   against the unpacked ``w1a8_eval`` one within PARITY_TOL·max|logit|,
   tie codes forced; served through `run_lm` (8 requests × 16 tokens,
   slots 4) with every launch count zeroed before and read after:
   done-mask tokens equal host-checked ones, 28 popcount launches a
   decode step (7 × 4, from the config) and no other kernel; the decode
   step timed as phase 12's. (c) ``python -m repro_torch.launch.train
   --arch mamba2-1.3b --steps 3`` (48 layers, seq 128, batch 8, AdamW,
   remat): exit 0, finite losses, its JSON line. (d) reduced chatglm3-6b
   through `run_train` into ``build/ckpt_phase13/``, preempted by the
   ``PREEMPT`` sentinel after step 4 of 8: `resume_or_init` restores the
   saved state bit for bit and the resumed step-8 loss equals an
   uninterrupted run's within 1e-5 relative (printed whether bit for
   bit); the size a full-width checkpoint would write is printed.

14. Runs after phase 13 freed its trees, before phase 8's line: the
   distribution layer on one card (no kernel of the port: the reference's
   distribution layer reaches no Pallas kernel). (a) `QTensor.quantize_s8`,
   `quantize_b1` (per tensor and per slice) and `pack_b1` of a seeded f32
   tensor of chatglm3-6b's MLP up-projection gradient shape (4096 ×
   13696) on the card against the CPU: codes, words and scales bit for
   bit; each wire's bytes beside the f32 bytes. On a one-rank NCCL group
   (a FileStore under ``build/``): (c) `make_pipeline_train_step` (1F1B,
   one stage, M 2) on phase 13's model (chatglm3-6b at full width, 4
   layers, B 8 × S 256) from phase 13's seeded params and first batch,
   SGD-M, against the one-device `make_train_step` of the same row groups,
   TF32 on outside `full_f32`: loss within 1e-5 relative; the f32 grad
   wire's every gradient leaf within 1e-3·max|g|, the one-device run's tie
   codes forced in the order the pipeline calls the quantizer
   (`dist.pipeline.stage_calls`); the int8 grad wire's every leaf within
   3%·max|g| and off the f32 one; then CUDA-event ms of AdamW steps beside
   phase 13's. (b) `tree_quantized_allreduce` over a seeded unit-normal
   tree of (c)'s gradient shapes (1.08 G elements): within the reference's
   3% of the input, both legs' int8 codes and the output equal to a
   one-rank gloo group's on the CPU bit for bit, CUDA-event ms a tree
   against an f32 ``all_reduce`` of every leaf. (d) ``torchrun
   --nproc-per-node 1 -m repro_torch.launch.train --arch mamba2-1.3b
   --pipeline 1f1b --pipeline-stages 1 --microbatches 2 --grad-wire int8
   --steps 3 --ckpt-dir build/ckpt_phase14`` at the full published
   config: exit 0, the ``[pipeline]`` line, backend ``nccl``; the
   one-device launcher restores its checkpoint (some 16 GB, removed
   after); its ms a step, tokens/s and peak memory. About 105 s.

15. Runs after phase 14, before phase 8's line: the sharded model on a
   one-rank NCCL ('data', 'model') = (1, 1) mesh (no kernel of the port
   beyond the grouped popcount entry: the reference's sharded layer
   reaches no Pallas kernel). (a) mixtral-8x7b at full width cut to 8
   of its 32 layers (phases 12 and 19 serve it whole), packed, served
   greedy (two waves of 4 slots, prefill and 15 decode steps each)
   under a `ShardCtx` with the uint8 dispatch wire off and on: off,
   every step's logits and tokens equal the local path's bit for bit
   (at ep = 1 the all-to-all is a copy and the grouped launches see the
   same codes and counts); on, equal bit for bit to the local path with
   its expert outputs rounded through bf16 (codes · step re-quantize to
   the same codes; the return leg is bf16); 3 grouped launches a layer
   and decode step. The decode tick under the `ShardCtx` as one CUDA
   graph replay (`serve.engine.capture_tick(ctx=)`, the counterpart of
   the reference's jitted sharded step; the NCCL all-to-alls of the
   dispatch, of the counts and of the return leg captured in the graph):
   `generate(ctx=)`'s tokens equal the eager waves' bit for bit, one
   capture a wave and one replay a token; the replayed tick, greedy and
   sampled, bit for bit against the eager tick on clones of the state
   and generator (`last_tok` and every cache leaf, 4 ticks); a replay's
   launches an eager step's. The eager step's and the tick replay's
   CUDA-event ms, local, wire off and on, in turns. (b) mixtral at full
   width cut to 2 layers (3.03 G params), B 8 ×
   S 256, SGD-M without clip: `make_train_step(ctx=)` from
   `shard_tree` of the seeded params against the one-device step, whose
   gradients are moved to the host first, codes forced to its
   (`train.ties`): loss within 1e-5 relative, every leaf within
   1e-3·max|g|; then sharded steps' CUDA-event ms and peak memory. (c)
   ``--arch mixtral-8x7b --reduced --production-mesh --steps 2
   --ckpt-dir build/ckpt_phase15`` through `launch.train.train(args, dev,
   mesh)`: its checkpoint restored whole and elastically onto the mesh
   bit for bit, the one-device launcher resumes it (``--steps 3``), and
   ``torchrun --nproc-per-node 1 -m repro_torch.launch.train
   --production-mesh`` exits non-zero naming the 256 ranks it needs. (d)
   `sp_decode_attention` at jamba-1.5-large-398b's attention (64 heads,
   8 KV heads, head dim 128), B 4, one shard of 32768 positions, within
   1e-5 of a plain full-softmax attention, finite zeros where cur_pos
   precedes the shard; its CUDA-event ms. Prints one ``sharded`` line.
16. Runs after phase 15, before phase 8's line: the tooling. (a) The
   kernel suite of ``launch/tables.py`` on the card (the W1A8 linear's
   float path, packed plain path and popcount kernel at (256, 4096, 4096)
   and (64, 1152, 128), CUDA-event µs beside the H100 bound), its
   launches counted (21 popcount matmuls a shape) and listed under
   ``tables`` in phase 8's line. (b) ``python -m
   repro_torch.launch.quickstart`` and ``serve_lm`` on the card, each in a
   process of its own: exit 0, quickstart's two ``verify.compare`` rows
   100% within their LSB (0.05, 0.02), serve_lm's greedy requests' tokens
   equal to the same script's run on the CPU here. (c) The dry run
   against the card, on the local path: phase 13's train step
   (chatglm3-6b, 4 layers, B 8 × S 256, 2 microbatches, remat, AdamW) and
   phase 10's packed decode step (chatglm3-6b, 4 slots, max_len 128, f32)
   traced by `launch.dryrun`'s counter on ``meta`` and under
   ``FakeTensorMode``, then run on the card under the same counter: FLOPs
   by dtype equal; the predicted peak within 0.5–2× of
   ``max_memory_allocated``; the costs bound at most the CUDA-event ms.
   (d) mixtral-8x7b ``decode_32k`` at (16, 16) traced by
   `launch.dryrun.run_cell` on this machine's host, its ``trace_s``.
   Prints one ``tooling`` line.
17. Runs after phase 16, before phase 8's line: the production layout of
   PR 29. (a) chatglm3-6b's packed projections as |model| 16's blocks
   through `layers.packed_linear(tp=)` (column blocks bit for bit the
   whole call's columns, row blocks' int32 sums adding up exactly); each
   block's launch alone bit for bit against its plain version, its device
   ms in turns with the PR-15 tile, the plain version's and f32
   ``torch.matmul``'s ms, the bound and the floor. (a') Rank 0 of (16,
   16) serving chatglm3-6b packed (``fake`` backend for the other ranks):
   a decode step's launches, the decode route's share from the blocks'
   K; the rank's tick captured as one CUDA graph on the cell's params,
   cache and ctx, a replay's launches the eager step's (196, 168 of them
   on the decode route), replay and eager CUDA-event ms in turns; no
   value compared (the fake collectives move no data). (b) Rank 0
   training chatglm3-6b's train_4k cell: peak memory
   against the dry run's. Prints one ``tp`` line.
18. Runs after phase 17, before phase 8's line: the launchers' gates
   (``launch/serve.py --gate-bench``) against a record file in a
   temporary directory, never the package's ``results/``. detect at 320
   (16 requests, slots 4, depth 2), multires at 256,320 (8 requests),
   lm ``--reduced --packed --arch chatglm3-6b`` and compose ``--reduced``
   each run twice: the first records, the second enforces. The committed
   img/s is taken out between the two, since one run's img/s spreads
   28–35% on the card: the second run's gates are the exact ones, host
   sync bytes a tick (lm, detect: equal across the runs) and compose's 0
   lost, 0 duplicated. detect's device-NMS wire is at least 10× smaller
   a sync than the raw wire's. Then the launcher over the second run's
   record (its runner replaced by one returning it) against doctored
   committed records: img/s at 0.5× the measured passes and at 2× fails
   (detect, multires), host sync bytes at 0.5× fails (lm, detect), and a
   record with one request lost fails compose's gate; each failure names
   its key and leaves the file byte for byte as it was. Prints one
   ``gates`` line.
19. Runs after phase 18, before phase 8's line: the LM decode tick as one
   CUDA graph replay (`serve.engine.capture_tick`, the counterpart of the
   reference's jitted tick). chatglm3-6b at full width, packed
   (`init_packed_lm` from SEED: phase 10's deployed tree), slots 4,
   max_len 128. (a) For each tick variant, host-checked and done-mask,
   greedy and sampled (temperature 0.8 on two rows), 16 ticks of
   `LMBackend.step` against an eager `decode_step` (+ `sample_tokens`) or
   `decode_step_donemask` on clones of the backend's state and
   generator, tick for tick: tokens, done bits, counts, the token buffer
   and every cache leaf equal bit for bit, the generator left where the
   eager draws leave its clone; after the capturing tick each tick calls
   ``CUDAGraph.replay`` once and `decode_step` never. (a') `generate` at
   temperature 0 and 0.8: one capture, one replay a token, tokens equal
   to the eager loop's bit for bit. (b) Each replay's launches (the
   backend's ``decode_launches``) equal the eager tick's. (c) The
   done-mask greedy tick's CUDA-event ms as a replay and as an eager
   `decode_tick` on the same state, in turns (replay, eager, eager,
   replay), and each's device busy ms and idle share (torch.profiler, as
   phases 10 and 12 time a decode step; and busy over the CUDA-event
   ms), taken in phase 10 on its deployed tree and in phase 12 on
   mixtral-8x7b's and mamba2-1.3b's (late in the smoke a trace of
   replays loses its device records). Prints one ``ticks`` line.

Sixteen requests make four dispatches: enough for the checks, too few for
a rate. Throughput and tick latency come from a longer launcher run
(``python -m repro_torch.launch.serve --requests 512``).

Needs one card and the repository around it: without CUDA, or alone in a
directory, it exits non-zero and prints no result. Writes the per-layer
record to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
BATCH = 4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
CANONICAL_M = 0.05             # the uniform step of the canonical operands
OFF_GRID = (2, 18, 18, 24, 40)  # (B, H, W, Cin, Cout) off the detector's grid
# (M, K, N) off the grid: ragged M, N and K; K % 16 != 0 (byte gathers),
# K % 32 == 16 (a half-filled last span of 16-byte loads)
MATMUL_OFF_GRID = ((5, 70, 12), (33, 200, 64), (40, 176, 40))
ROWS = (2, 3, 4)               # popcount row blockings; each shape has a
                               # ragged last block under one of them
TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA")

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "w1a8_conv3x3_pool2": ("src/repro_torch/csrc/w1a8_conv3x3_pool2.cu",
                           "src/repro/kernels/w1a8_conv/fused_pool.py:72"),
    "w1a8_conv3x3": ("src/repro_torch/csrc/w1a8_conv3x3.cu",
                     "src/repro/kernels/w1a8_conv/kernel.py:80"),
    "w1a8_matmul": ("src/repro_torch/csrc/w1a8_matmul.cu",
                    "src/repro/kernels/w1a8_matmul/kernel.py:168"),
    "w1a8_conv3x3_pool2_popcount": (
        "src/repro_torch/csrc/w1a8_conv3x3_pool2_popcount.cu",
        "src/repro/kernels/w1a8_conv/fused_pool.py:56"),
    "w1a8_conv3x3_popcount": (
        "src/repro_torch/csrc/w1a8_conv3x3_popcount.cu",
        "src/repro/kernels/w1a8_conv/kernel.py:63"),
    "w1a8_matmul_popcount": (
        "src/repro_torch/csrc/w1a8_matmul_popcount.cu",
        "src/repro/kernels/w1a8_matmul/kernel.py:135"),
    # the 2-D entry's decode route (M <= 16): a share of its launches
    "w1a8_matmul_popcount_decode": (
        "src/repro_torch/csrc/w1a8_matmul_popcount.cu",
        "src/repro/kernels/w1a8_matmul/kernel.py:135"),
    # the same library's grouped entry: one launch for a stack of experts
    "w1a8_matmul_popcount_grouped": (
        "src/repro_torch/csrc/w1a8_matmul_popcount.cu",
        "src/repro/kernels/w1a8_matmul/kernel.py:135"),
    "w1a8_matmul_int": ("src/repro_torch/csrc/w1a8_matmul_int.cu",
                        "src/repro/kernels/w1a8_matmul/kernel.py:228"),
    # the counterpart of the reference's jitted postprocess (decode_head and
    # a lax.fori_loop NMS), which is no Pallas kernel
    "detect_postprocess": ("src/repro_torch/csrc/detect_nms.cu",
                           "src/repro/models/detection.py:90"),
    # the counterpart of the reference's numpy int64 yolo_forward_int, which
    # is no Pallas kernel
    "w1a8_int_pe": ("src/repro_torch/csrc/w1a8_int_pe.cu",
                    "src/repro/models/yolo.py:323"),
}
DOT = ("w1a8_conv3x3_pool2", "w1a8_conv3x3", "w1a8_matmul")
# name: the tensor-core instruction its library's SASS must hold
TENSOR_CORE_KERNELS = {
    "w1a8_conv3x3_pool2": "HMMA", "w1a8_conv3x3": "HMMA",
    "w1a8_matmul": "HMMA", "w1a8_conv3x3_pool2_popcount": "IMMA",
    "w1a8_conv3x3_popcount": "IMMA", "w1a8_matmul_popcount": "IMMA",
    "w1a8_matmul_popcount_decode": "IMMA",
    "w1a8_matmul_popcount_grouped": "IMMA", "w1a8_matmul_int": "IMMA",
    "w1a8_int_pe": "IMMA"}
PROFILES = ("tuned", "default")  # the launcher's --profile, both driven
AUTOTUNE_CMD = "PYTHONPATH=src python -m repro_torch.launch.autotune --batch 4"
WINNERS = 22                   # 11 cells x 2 accum modes in the table
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
NMS_IOU_OPS = 15               # float ops of one IoU and its suppression test
# popcount forward, per route: (pool2_popcount, conv3x3_popcount,
# matmul_popcount) launches of one forward
POPCOUNT = ("w1a8_conv3x3_pool2_popcount", "w1a8_conv3x3_popcount",
            "w1a8_matmul_popcount")
PER_FORWARD = {True: (4, 4, 1), False: (0, 8, 1)}
INT_PE = "w1a8_int_pe"
INT_BATCHES = (1, 4)           # the integer PE's per-layer checks
# (Cin, Cout) off the detector's grid: Cin % 16 != 0 (3, 24: the pair of
# units spans taps), 16, 48 and 128; Cout ragged against the warp tiles
INT_OFF_GRID = ((3, 16), (16, 20), (24, 40), (48, 33), (128, 75))
# the integer PE's device ms a layer and a forward at B = 4, 320×320 before
# its redesign, on the CUDA cores in int64 (PERF.md §6, NVIDIA H100 80GB
# HBM3, 700.00 W)
INT_BEFORE_DEVICE_MS = {
    "conv1": 0.2016, "conv2": 0.1462, "conv3": 0.1562, "conv4": 0.1864,
    "conv5": 0.1870, "conv6": 0.1878, "conv7": 0.1941, "conv8": 0.1227,
    "conv9": 0.0274, "conv10": 0.0628, "conv11": 0.0191, "forward": 1.4925}
# int head against the float head: tests/test_yolo.py's
# test_int_pipeline_alignment (max_abs, mean_abs; 100% within 1 LSB of 0.02)
INT_ENVELOPE = (0.02, 0.002)
QAT_PARITY_BATCH = 2           # phase 9's one step on the card and the CPU
QAT_BATCH, QAT_STEPS = 16, 30  # phase 9's training run at 320×320
QAT_REPLAY_STEPS = 3           # phase 9b's replayed steps against eager
LM_ARCH = "chatglm3-6b"        # phase 10's LM, at full width
LM_SLOTS, LM_PROMPT = 4, 3     # the launcher's slots and prompt length
LM_REQUESTS, LM_MAX_NEW, LM_MAX_LEN = 8, 16, 128
# packed against unpacked prefill logits at 28 layers, K up to 13696, tie
# codes forced: the unpacked path sums code·step·sign in f32 (about 1e-7
# relative a rounding, |Σ| some sqrt(K) ≈ 117 times below Σ|·| at random
# signs) where the packed one sums exactly, at each of 252 projections;
# the CPU tests hold 1e-4 at 2 layers and K ≤ 128
LM_TOL = 1e-3


def cuda_ms(torch, fn, reps: int = 7, n: int = 20) -> float:
    """Median over `reps` of the mean time of `n` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(nbytes: int, ops: int, ops_per_s: float = BF16_OPS_PER_S) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tensor_core_counts(_build) -> dict:
    """Phase 1: tensor-core instructions in each library's SASS, by name
    of its kernel; raises if a tensor-core kernel's library has none of its
    kind or any library's build log (ptxas -v) reports a spill."""
    import re
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    counts = {}
    for name, (source, _) in KERNELS.items():
        lib = _build.library_path(pathlib.Path(source).name)
        sass = subprocess.run([str(tool), "--dump-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in TENSOR_CORE_OPS}
        print(f"[sass] {lib.name}: " + ", ".join(
            f"{n} {op}" for op, n in counts[name].items()), flush=True)
    for name, (source, _) in KERNELS.items():
        op = TENSOR_CORE_KERNELS.get(name)
        if op and not counts[name][op]:
            raise AssertionError(f"{name}: no {op} instruction in its SASS")
        log = _build.build_log(pathlib.Path(source).name)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
        if not spills or any(int(n) for n in spills):
            raise AssertionError(f"{name}: spills registers or its build "
                                 f"log is missing: {spills}")
    return counts


def popcount_globals(_build) -> dict:
    """Phase 1, each ``__global__`` of the popcount matmul's library
    (``csrc/w1a8_matmul_popcount.cu``): its tensor-core instructions in
    the SASS (cuobjdump) and its registers and spill bytes (ptxas -v in
    the build log). Raises if a decode kernel holds no IMMA, spills, or
    holds more registers than `geometry.DECODE_REGS` (the residency its
    launch geometry counts on)."""
    import re

    from repro_torch.kernels.w1a8_matmul import geometry
    source = "w1a8_matmul_popcount.cu"
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass",
                           str(_build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {op: 0 for op in TENSOR_CORE_OPS}
        elif name:
            for op in TENSOR_CORE_OPS:
                out[name][op] += len(re.findall(rf"\b{op}\b", line))
    name = None
    for line in _build.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name in out:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    for name, rec in out.items():
        short = re.sub(r"^_ZN\w*?(matmul_popcount\w*?_kernel)", r"\1", name)
        print(f"[sass] {source} {short[:60]}: " + ", ".join(
            f"{k} {v}" for k, v in rec.items()), flush=True)
        if "decode_kernel" in name and (
                not rec["IMMA"] or rec.get("spill_bytes", 1)
                or rec.get("registers", 256) > geometry.DECODE_REGS):
            raise AssertionError(f"{short}: {rec} (IMMA, no spill, at most "
                                 f"{geometry.DECODE_REGS} registers)")
    if not any("decode_kernel" in name for name in out):
        raise AssertionError(f"{source}: no decode kernel in its SASS")
    return out


def layer_operands(torch, np, rng, b, h, cin, cout, dev, *, ksize=3):
    a = torch.from_numpy(rng.integers(0, 256, (b, h, h, cin),
                                      dtype=np.uint8)).to(dev)
    w = rng.standard_normal((ksize * ksize * cin, cout)).astype(np.float32)
    mul = rng.uniform(0.01, 0.1, cin).astype(np.float32)
    div = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return a, torch.from_numpy(w).to(dev), *(torch.from_numpy(x).to(dev)
                                             for x in (mul, div, bias))


def matmul_operands(torch, np, rng, m, k, n, dev):
    """(m, k) codes, (k, n) float weights, Mul_prev, Div and bias."""
    a = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8))
    w = rng.standard_normal((k, n)).astype(np.float32)
    mul = rng.uniform(0.01, 0.1, k).astype(np.float32)
    div = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return a.to(dev), *(torch.from_numpy(x).to(dev)
                        for x in (w, mul, div, bias))


def unaligned(torch, x):
    """A copy of the uint8 tensor ``x`` whose data starts one byte past a
    16-byte boundary, so that no row of it is 16-byte aligned."""
    buf = torch.empty(x.numel() + 32, dtype=torch.uint8, device=x.device)
    off = (1 - buf.data_ptr()) % 16
    y = buf[off:off + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 1
    return y


def row_checks(torch, run, a2, full, what: str) -> None:
    """Raises unless the rows of ``run`` on a prefix of M (several lengths,
    so several launch geometries), on ``a2[1:]`` (whose row pointer is not
    16-byte aligned where K % 16 != 0) and on an unaligned copy of ``a2``
    equal the same rows of ``full`` = run(a2) bit for bit."""
    m = a2.shape[0]
    for mp in sorted({1, min(17, m), m // 2, m - 1} - {0}):
        _exact(torch, run(a2[:mp]), full[:mp], f"{what} rows [:{mp}]")
    if m > 1:
        _exact(torch, run(a2[1:]), full[1:], f"{what} rows [1:]")
    _exact(torch, run(unaligned(torch, a2)), full, f"{what} unaligned")


def dot_matmul_case(torch, a2, wp, mul, div, bias, k, note, what):
    """Phase 2 on one matmul operand set: the dot matmul within 6e-3·max|y|
    (f32) and 1 LSB (codes) of its plain version, and `row_checks` on
    both. Returns (y, y_ref, q, q_ref, step)."""
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref

    def run(c):
        return lambda x: mm_ops.w1a8_matmul(x, wp, mul, div, bias, k=k,
                                            config=c)
    y_ref = mm_ref.w1a8_matmul_ref(a2, wp, k, mul, div, bias)
    y = run(None)(a2)
    step = float(y_ref.abs().max()) / 255.0
    cfg = KernelConfig(op="matmul", out_step=step)
    q = run(cfg)(a2)
    q_ref = mm_ref.w1a8_matmul_ref(a2, wp, k, mul, div, bias, step)
    torch.cuda.synchronize()
    err, tol = note("w1a8_matmul", y, y_ref), 6e-3 * float(y_ref.abs().max())
    codes = note("w1a8_matmul", q, q_ref)
    if err > tol or codes > 1:
        raise AssertionError(f"{what}: dot matmul f32 err {err} > {tol} or "
                             f"codes differ by {codes} > 1 LSB")
    row_checks(torch, run(None), a2, y, f"{what} dot matmul f32")
    row_checks(torch, run(cfg), a2, q, f"{what} dot matmul codes")
    return y, y_ref, q, q_ref, step


def check_kernels(torch, np, dev) -> tuple:
    """Phase 2: every dot kernel against its plain version at the main path's
    shapes, and the conv kernels at OFF_GRID. Returns the per-layer records,
    the off-grid record and, per kernel, the worst codes difference and f32
    error over every call that launched it."""
    import torch.nn.functional as F
    from repro_torch.core import packing
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_conv import fused_pool
    from repro_torch.kernels.w1a8_conv import ops as conv_ops
    from repro_torch.kernels.w1a8_conv import ref as conv_ref
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.models import yolo

    rng = np.random.default_rng(SEED)
    sizes = yolo.spatial_sizes(yolo.INPUT_SIZE)
    layers, off_grid = [], None
    errs = {name: {"codes": 0, "f32": None} for name in KERNELS}

    def note(kernel, got, want):
        e = errs[kernel]
        if got.dtype == torch.uint8:
            d = int((got.int() - want.int()).abs().max())
            e["codes"] = max(e["codes"], d)
        else:
            d = float((got - want).abs().max())
            e["f32"] = d if e["f32"] is None else max(e["f32"], d)
        return d
    cases = [(spec.name, BATCH, sizes[spec.name], spec.cin, spec.cout,
              spec.ksize, spec.pool)
             for spec in yolo.YOLO_LAYERS if spec.kind == "w1a8"]
    b, h, _, cin, cout = OFF_GRID
    cases.append(("off_grid", b, h, cin, cout, 3, True))
    for name, b, h, cin, cout, ksize, pool in cases:
        a, w, mul, div, bias = layer_operands(torch, np, rng, b, h, cin,
                                              cout, dev, ksize=ksize)
        rec = {"layer": name, "shape": [b, h, h, cin, cout]}
        if ksize == 1:
            rec["kernel"] = "w1a8_matmul"
            a2 = a.reshape(-1, cin)
            wp = mm_ops.w1a8_pack_weights(w)
            y, y_ref, q, q_ref, step = dot_matmul_case(
                torch, a2, wp, mul, div, bias, cin, note, name)
            cfg = KernelConfig(op="matmul", out_step=step)
            m = a2.shape[0]
            nbytes = (m * cin + wp.numel() * 4 + 4 * cin + 8 * cout
                      + m * cout)
            ops = 2 * m * cin * cout
            run = lambda: mm_ops.w1a8_matmul(a2, wp, mul, div, bias,  # noqa: E731
                                             k=cin, config=cfg)
            plain = lambda: mm_ref.w1a8_matmul_ref(  # noqa: E731
                a2, wp, cin, mul, div, bias, step)
            a_bf = mm_ref.bf16_prologue(a2, mul).to(torch.bfloat16)
            s_bf = packing.unpack_signs(wp, cin, dtype=torch.bfloat16)
            library = lambda: torch.matmul(a_bf, s_bf)  # noqa: E731
        else:
            wp = conv_ops.conv_pack_weights(w.reshape(3, 3, cin, cout))
            y_ref = conv_ref.w1a8_conv3x3_ref(a, wp, cin, mul, div, bias)
            y = conv_ops.w1a8_conv3x3(a, wp, mul, div, bias, cin=cin)
            step = float(y_ref.abs().max()) / 255.0
            cfg = KernelConfig(op="conv3x3", out_step=step)
            q = conv_ops.w1a8_conv3x3(a, wp, mul, div, bias, cin=cin,
                                      config=cfg)
            q_ref = conv_ref.w1a8_conv3x3_ref(a, wp, cin, mul, div, bias,
                                              step)
            q_rows = conv_ops.w1a8_conv3x3(a, wp, mul, div, bias, cin=cin,
                                           config=cfg.replace(rows=2))
            if not torch.equal(q_rows, q):
                raise AssertionError(f"{name}: conv3x3 rows=2 differs")
            ops = 2 * b * h * h * 9 * cin * cout
            a_bf = mm_ref.bf16_prologue(a, mul).to(torch.bfloat16) \
                .permute(0, 3, 1, 2).contiguous()
            w_bf = torch.where(w >= 0, 1.0, -1.0).reshape(3, 3, cin, cout) \
                .permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
            library = lambda: F.conv2d(a_bf, w_bf, padding=1)  # noqa: E731
            in_bytes = a.numel() + wp.numel() * 4 + 4 * cin + 8 * cout
            if pool:
                rec["kernel"] = "w1a8_conv3x3_pool2"
                p = fused_pool.w1a8_conv3x3_pool2(a, wp, mul, div, bias,
                                                  cin=cin, out_step=step)
                p_ref = conv_ref.w1a8_conv3x3_pool2_ref(a, wp, cin, mul, div,
                                                        bias, step)
                if not torch.equal(p, conv_ref.maxpool2_codes(q)):
                    raise AssertionError(
                        f"{name}: fused pool != conv3x3 kernel + max")
                p_rows = fused_pool.w1a8_conv3x3_pool2(
                    a, wp, mul, div, bias, cin=cin, out_step=step, rows=2)
                if not torch.equal(p_rows, p):
                    raise AssertionError(f"{name}: pool rows=2 differs")
                rec["pool_codes_max_diff"] = note(rec["kernel"], p, p_ref)
                nbytes = in_bytes + p.numel()
                run = lambda: fused_pool.w1a8_conv3x3_pool2(  # noqa: E731
                    a, wp, mul, div, bias, cin=cin, out_step=step)
                plain = lambda: conv_ref.w1a8_conv3x3_pool2_ref(  # noqa: E731
                    a, wp, cin, mul, div, bias, step)
            else:
                rec["kernel"] = "w1a8_conv3x3"
                nbytes = in_bytes + q.numel()
                run = lambda: conv_ops.w1a8_conv3x3(  # noqa: E731
                    a, wp, mul, div, bias, cin=cin, config=cfg)
                plain = lambda: conv_ref.w1a8_conv3x3_ref(  # noqa: E731
                    a, wp, cin, mul, div, bias, step)
        torch.cuda.synchronize()
        base = "w1a8_matmul" if ksize == 1 else "w1a8_conv3x3"
        scale = float(y_ref.abs().max())
        rec["f32_max_abs_err"] = note(base, y, y_ref)
        rec["f32_tol"] = 6e-3 * scale
        rec["codes_max_diff"] = note(base, q, q_ref)
        rec["codes_identical"] = float((q == q_ref).float().mean())
        if rec["f32_max_abs_err"] > rec["f32_tol"]:
            raise AssertionError(f"{name}: f32 error {rec}")
        if rec["codes_max_diff"] > 1 or rec.get("pool_codes_max_diff", 0) > 1:
            raise AssertionError(f"{name}: codes differ by > 1 LSB {rec}")
        if name == "off_grid":
            off_grid = rec
            print(f"[check] off the grid {rec['shape']}: conv3x3 and "
                  f"conv3x3_pool2 codes max diff {rec['codes_max_diff']}, "
                  f"{rec['pool_codes_max_diff']} "
                  f"({100 * rec['codes_identical']:.3f}% identical), f32 "
                  f"err {rec['f32_max_abs_err']:.3g} <= "
                  f"{rec['f32_tol']:.3g}; fused = conv + max and rows=2 "
                  f"exact", flush=True)
            continue
        rec["ms"] = cuda_ms(torch, run)
        rec["plain_ms"] = cuda_ms(torch, plain, reps=3, n=3)
        rec["library_ms"] = cuda_ms(torch, library)
        rec["device_ms"] = device_profile(torch, run)["device_busy_ms"]
        rec["library_device_ms"] = device_profile(torch,
                                                  library)["device_busy_ms"]
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        rec["bytes"], rec["ops"] = nbytes, ops
        print(f"[check] {name} {rec['kernel']} {rec['shape']}: codes "
              f"max diff {rec['codes_max_diff']} "
              f"({100 * rec['codes_identical']:.3f}% identical), f32 err "
              f"{rec['f32_max_abs_err']:.3g} <= {rec['f32_tol']:.3g}; "
              f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"device {rec['library_device_ms']:.4f}, bound "
              f"{rec['bound_ms']:.5f} by {rec['bound_by']})", flush=True)
        layers.append(rec)
    for m, k, n in MATMUL_OFF_GRID:
        a2, w, mul, div, bias = matmul_operands(torch, np, rng, m, k, n, dev)
        dot_matmul_case(torch, a2, mm_ops.w1a8_pack_weights(w), mul, div,
                        bias, k, note, f"off the grid {(m, k, n)}")
    print(f"[check] dot matmul off the grid {list(MATMUL_OFF_GRID)} and at "
          f"conv9: within the tolerances; rows of prefixes of M, of a2[1:] "
          f"and of unaligned rows bit-exact with the full call", flush=True)
    return layers, off_grid, errs


def _exact(torch, got, want, what: str) -> float:
    """Raises unless ``got`` equals ``want`` bit for bit, NaN where it is
    NaN; returns the largest absolute difference (0.0 when it returns)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    same = got == want
    if got.is_floating_point():
        same |= got.isnan() & want.isnan()
    if not bool(same.all()):
        diff = float((got.double() - want.double()).abs().max())
        raise AssertionError(f"{what}: not bit-exact (max diff {diff})")
    return 0.0


def check_popcount_kernels(torch, np, dev, size: int = None) -> tuple:
    """Phase 3: the popcount kernels and the int kernel at every W1A8 layer
    shape, exactly against their plain versions and, under canonical
    operands, against the dot kernels. Returns the per-layer records and,
    per kernel, the largest difference over every check (0 when it
    returns)."""
    import torch.nn.functional as F
    from repro_torch.core import packing
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_conv import fused_pool
    from repro_torch.kernels.w1a8_conv import ops as conv_ops
    from repro_torch.kernels.w1a8_conv import ref as conv_ref
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.models import yolo

    MM, INT = "w1a8_matmul_popcount", "w1a8_matmul_int"
    CONV, POOL = "w1a8_conv3x3_popcount", "w1a8_conv3x3_pool2_popcount"
    rng = np.random.default_rng(SEED + 1)
    sizes = yolo.spatial_sizes(size or yolo.INPUT_SIZE)
    records = []
    errs = {name: 0.0 for name in (MM, INT, CONV, POOL)}

    def exact(kernel, got, want, what):
        errs[kernel] = max(errs[kernel], _exact(torch, got, want, what))

    def conv_checks(name, a, wp, div, bias, cin, pooled):
        """The popcount conv (and, where ``pooled``, the fused pool) on
        one layer's operands, exactly against the plain versions, across
        `rows`, against conv + max and against dot under canonical
        operands. Returns the requant step, the conv codes and the fused
        pool's call (None where not pooled)."""
        # canonical operands: a uniform step m̄ against mul ≡ 1 and div·m̄
        cin_ones = torch.ones(cin, device=dev)
        mul_m = torch.full((cin,), CANONICAL_M, device=dev)
        div_m = div * torch.tensor(CANONICAL_M, device=dev)
        cfg = KernelConfig(op="conv3x3", accum="popcount")

        def conv(mul, d, c, fn=conv_ops.w1a8_conv3x3):
            return fn(a, wp, mul, d, bias, cin=cin, config=c)
        y = conv(None, div, cfg)
        exact(CONV, y, conv_ref.w1a8_conv3x3_popcount_ref(
            a, wp, cin, div, bias), f"{name} conv f32")
        step = float(y.abs().max()) / 255.0
        qcfg = cfg.replace(out_step=step)
        q = conv(None, div, qcfg)
        exact(CONV, q, conv_ref.w1a8_conv3x3_popcount_ref(
            a, wp, cin, div, bias, step), f"{name} conv codes")
        for rows in ROWS:
            exact(CONV, conv(None, div, qcfg.replace(rows=rows)), q,
                  f"{name} conv rows={rows}")
        for c in (cfg, qcfg):
            exact(CONV, conv(mul_m, div, c),
                  conv(cin_ones, div_m, c.replace(accum="dot")),
                  f"{name} conv popcount vs dot")
        if not pooled:
            return step, q, None

        def pool(rows=1):
            return fused_pool.w1a8_conv3x3_pool2(
                a, wp, None, div, bias, cin=cin, out_step=step,
                accum="popcount", rows=rows)
        p = pool()
        exact(POOL, p, conv_ref.w1a8_conv3x3_pool2_popcount_ref(
            a, wp, cin, div, bias, step), f"{name} pool codes")
        exact(POOL, p, conv_ref.maxpool2_codes(q),
              f"{name} fused pool vs conv + max")
        for rows in ROWS:
            exact(POOL, pool(rows), p, f"{name} pool rows={rows}")
        pcfg = KernelConfig(op="conv3x3_pool", accum="popcount",
                            out_step=step)
        exact(POOL, conv(mul_m, div, pcfg, conv_ops.w1a8_conv3x3_pool),
              conv(cin_ones, div_m, pcfg.replace(accum="dot"),
                   conv_ops.w1a8_conv3x3_pool),
              f"{name} pool popcount vs dot")
        return step, q, pool

    def matmul_checks(a2, wp, div, bias, k, name):
        """The popcount matmul on one operand set, exactly: against its
        plain version (f32 and codes), against the dot matmul under
        canonical operands, and its sum under div ≡ 1, bias ≡ 0 against
        the int kernel, which is held against its plain version; then
        `row_checks`. Returns the call, the requant step, the signs and
        their column sums."""
        n = wp.shape[1]
        ones = torch.ones(k, device=dev)
        mul_m = torch.full((k,), CANONICAL_M, device=dev)
        div_m = div * torch.tensor(CANONICAL_M, device=dev)
        cfg = KernelConfig(op="matmul", accum="popcount")

        def mm(x, d, c, mul=None):
            return mm_ops.w1a8_matmul(x, wp, mul, d, bias, k=k, config=c)
        y = mm(a2, div, cfg)
        exact(MM, y, mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div, bias),
              f"{name} matmul f32")
        step = float(y.abs().max()) / 255.0
        qcfg = cfg.replace(out_step=step)
        q = mm(a2, div, qcfg)
        exact(MM, q, mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div, bias,
                                                     step),
              f"{name} matmul codes")
        for c in (cfg, qcfg):
            exact(MM, mm(a2, div, c, mul_m),
                  mm(a2, div_m, c.replace(accum="dot"), ones),
                  f"{name} matmul popcount vs dot")
        signs = packing.unpack_signs(wp, k, dtype=torch.float32)
        colsum = signs.sum(dim=0).to(torch.int32)
        yi = mm_ops.w1a8_matmul_int(a2, wp, colsum)
        exact(INT, yi, mm_ref.w1a8_matmul_int_ref(a2, wp, colsum),
              f"{name} int")
        sums = mm_ops.w1a8_matmul(a2, wp, None, torch.ones(n, device=dev),
                                  torch.zeros(n, device=dev), k=k, config=cfg)
        exact(INT, yi.to(torch.float32), sums, f"{name} int vs popcount sum")
        row_checks(torch, lambda x: mm_ops.w1a8_matmul_int(x, wp, colsum), a2,
                   yi, f"{name} int")
        row_checks(torch, lambda x: mm(x, div, cfg), a2, y,
                   f"{name} popcount matmul f32")
        row_checks(torch, lambda x: mm(x, div, qcfg), a2, q,
                   f"{name} popcount matmul codes")
        return mm, step, signs, colsum

    for spec in yolo.YOLO_LAYERS:
        if spec.kind != "w1a8":
            continue
        first = len(records)
        h, cin, cout = sizes[spec.name], spec.cin, spec.cout
        name = spec.name
        a, w, _, div, bias = layer_operands(torch, np, rng, BATCH, h, cin,
                                            cout, dev, ksize=spec.ksize)
        shape = [BATCH, h, h, cin, cout]
        if spec.ksize == 1:
            a2 = a.reshape(-1, cin)
            m = a2.shape[0]
            wp = mm_ops.w1a8_pack_weights(w)
            mm, step, signs, colsum = matmul_checks(a2, wp, div, bias, cin,
                                                    name)
            qcfg = KernelConfig(op="matmul", accum="popcount", out_step=step)
            ops = 2 * m * cin * cout
            nbytes = m * cin + wp.numel() * 4 + 8 * cout + m * cout
            a_bf, s_bf = a2.to(torch.bfloat16), signs.to(torch.bfloat16)
            records.append(dict(
                layer=name, kernel=MM, shape=shape,
                run=lambda: mm(a2, div, qcfg),
                plain=lambda: mm_ref.w1a8_matmul_popcount_ref(
                    a2, wp, cin, div, bias, step),
                library=lambda: torch.matmul(a_bf, s_bf),
                bound=bound(nbytes, ops, INT8_OPS_PER_S), bytes=nbytes,
                ops=ops))
            nbytes = m * cin + wp.numel() * 4 + 4 * cout + 4 * m * cout
            a8 = (a2.to(torch.int16) - 128).to(torch.int8)
            s8 = signs.to(torch.int8)
            records.append(dict(
                layer=name, kernel=INT, shape=shape,
                run=lambda: mm_ops.w1a8_matmul_int(a2, wp, colsum),
                plain=lambda: mm_ref.w1a8_matmul_int_ref(a2, wp, colsum),
                library=lambda: torch._int_mm(a8, s8),
                bound=bound(nbytes, ops, INT8_OPS_PER_S), bytes=nbytes,
                ops=ops))
        else:
            wp = conv_ops.conv_pack_weights(w.reshape(3, 3, cin, cout))
            step, q, pool = conv_checks(name, a, wp, div, bias, cin,
                                        spec.pool)
            qcfg = KernelConfig(op="conv3x3", accum="popcount",
                                out_step=step)
            ops = 2 * BATCH * h * h * 9 * cin * cout
            in_bytes = a.numel() + wp.numel() * 4 + 8 * cout
            a_bf = a.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
            w_bf = torch.where(w >= 0, 1.0, -1.0).reshape(3, 3, cin, cout) \
                .permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
            library = lambda: F.conv2d(a_bf, w_bf, padding=1)  # noqa: E731
            if spec.pool:
                nbytes = in_bytes + q.numel() // 4
                records.append(dict(
                    layer=name, kernel=POOL, shape=shape, run=pool,
                    plain=lambda: conv_ref.w1a8_conv3x3_pool2_popcount_ref(
                        a, wp, cin, div, bias, step),
                    library=library, bound=bound(nbytes, ops, INT8_OPS_PER_S),
                    bytes=nbytes, ops=ops))
            else:
                nbytes = in_bytes + q.numel()
                records.append(dict(
                    layer=name, kernel=CONV, shape=shape,
                    run=lambda: conv_ops.w1a8_conv3x3(
                        a, wp, None, div, bias, cin=cin, config=qcfg),
                    plain=lambda: conv_ref.w1a8_conv3x3_popcount_ref(
                        a, wp, cin, div, bias, step),
                    library=library, bound=bound(nbytes, ops, INT8_OPS_PER_S),
                    bytes=nbytes, ops=ops))
        torch.cuda.synchronize()
        for rec in records[first:]:
            run, library = rec.pop("run"), rec.pop("library")
            rec["ms"] = cuda_ms(torch, run)
            rec["plain_ms"] = cuda_ms(torch, rec.pop("plain"), reps=2, n=2)
            rec["library_ms"] = cuda_ms(torch, library)
            rec["device_ms"] = device_profile(torch, run)["device_busy_ms"]
            rec["library_device_ms"] = device_profile(
                torch, library)["device_busy_ms"]
            rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
            print(f"[popcount] {rec['layer']} {rec['kernel']} "
                  f"{rec['shape']}: bit-exact with its plain version and "
                  f"the dot kernel; {rec['ms']:.4f} ms, device "
                  f"{rec['device_ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
                  f"library {rec['library_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.4f}, bound "
                  f"{rec['bound_ms']:.6f} by {rec['bound_by']})",
                  flush=True)

    # off the detector's grid: Cin % 16 != 0, Cout % 32 != 0
    b, h, _, cin, cout = OFF_GRID
    a, w, _, div, bias = layer_operands(torch, np, rng, b, h, cin, cout, dev)
    conv_checks("off_grid", a,
                conv_ops.conv_pack_weights(w.reshape(3, 3, cin, cout)), div,
                bias, cin, True)
    print(f"[popcount] off the grid {list(OFF_GRID)}: conv3x3_popcount and "
          f"conv3x3_pool2_popcount bit-exact with their plain versions, "
          f"with conv + max, across rows {ROWS} and with the dot kernels",
          flush=True)
    for m, k, n in MATMUL_OFF_GRID:
        a2, w, _, div, bias = matmul_operands(torch, np, rng, m, k, n, dev)
        matmul_checks(a2, mm_ops.w1a8_pack_weights(w), div, bias, k,
                      f"off the grid {(m, k, n)}")
    print(f"[popcount] matmul off the grid {list(MATMUL_OFF_GRID)} and at "
          f"conv9: bit-exact with its plain version, with the dot matmul "
          f"and with the int kernel's sum; rows of prefixes of M, of a2[1:] "
          f"and of unaligned rows bit-exact with the full call", flush=True)
    return records, errs


# the measurements whose every trace lost device activity, timed with CUDA
# events instead (`events_profile`)
TRACE_FALLBACKS = []


def device_profile(torch, fn, n: int = 10, tries: int = 5) -> dict:
    """torch.profiler over ``n`` calls of ``fn`` after a warm one: device
    busy ms per call (the union of the traced device intervals), host ms per
    call (profiled, so above the unprofiled time) and device launches per
    call. Every call launches at least one kernel, so a trace with fewer
    device events than calls has lost some, as one now and then does; it is
    taken again, up to ``tries`` times, and then `events_profile` times the
    calls."""
    from repro_torch.launch.profile import union_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(events) >= n:
            break
    else:
        return events_profile(torch, fn, n, tries)
    busy_us = union_us((e.time_range.start, e.time_range.end)
                       for e in events)
    return {"device_busy_ms": busy_us / 1e3 / n, "wall_ms": wall_ms / n,
            "device_launches": len(events) / n,
            "device_timing": "torch.profiler"}


def events_profile(torch, fn, n: int, tries: int) -> dict:
    """Where ``tries`` traces lost device activity (CUPTI may record
    nothing in a process): CUDA-event ms per call over ``n`` calls, which
    bounds the device busy time from above, and host ms per call; device
    launches are not measured (None). Noted in `TRACE_FALLBACKS` and
    printed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    TRACE_FALLBACKS.append(getattr(fn, "__qualname__", repr(fn)))
    print(f"[profile] {tries} traces lost device activity: CUDA events "
          f"instead (device launches not measured)", flush=True)
    return {"device_busy_ms": start.elapsed_time(end) / n,
            "wall_ms": wall_ms / n, "device_launches": None,
            "device_timing": "cuda events"}


def _num(x, spec: str) -> str:
    """``x`` formatted by ``spec``, or "not measured" where it is None."""
    return "not measured" if x is None else format(x, spec)


def _zero(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def drive_popcount(torch, np, dev, size: int = None) -> dict:
    """Phase 5: the popcount forward at full width on a per-channel
    artifact, once per pool route, and the int path; every launch count
    zeroed just before each run and read just after. Returns the record
    with the popcount kernels' and the int kernel's launches."""
    from repro_torch.core import packing, verify
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import yolo

    size = size or yolo.INPUT_SIZE
    rng = np.random.default_rng(SEED + 2)
    imgs = torch.from_numpy(rng.integers(0, 256, (BATCH, size, size, 3),
                                         dtype=np.uint8)).to(dev) \
        .to(torch.float32) / 256.0
    params, art = yolo.build_detector(SEED, imgs, device=dev)
    with torch.no_grad():
        ref = yolo.yolo_forward_float(params, imgs).cpu().numpy()
    launches = {name: 0 for name in POPCOUNT}
    raws, record = {}, {"routes": {}}
    for fused in (True, False):
        configs = yolo.kernel_configs(art, size, BATCH, accum="popcount",
                                      fuse_pool=fused)
        _zero(launch.KERNELS)
        with torch.no_grad():
            raws[fused] = yolo.yolo_forward_kernel(art, imgs,
                                                   configs=configs)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        got = tuple(counts[name] for name in POPCOUNT)
        if got != PER_FORWARD[fused] or any(
                counts[name] for name in DOT + ("w1a8_matmul_int",)):
            raise AssertionError(f"popcount forward fused={fused}: launches "
                                 f"{counts}, want {PER_FORWARD[fused]}")
        for name in POPCOUNT:
            launches[name] += counts[name]
        rep = verify.compare("popcount_vs_float", raws[fused].cpu().numpy(),
                             ref, lsb=0.02)
        if not (rep.max_abs < 0.02 and rep.within_1lsb == 1.0):
            raise AssertionError(f"popcount raw head fused={fused} outside "
                                 f"the envelope: {rep.row()}")
        with torch.no_grad():
            forward = lambda: yolo.yolo_forward_kernel(  # noqa: E731
                art, imgs, configs=configs)
            ms = cuda_ms(torch, forward, reps=5, n=10)
            prof = device_profile(torch, forward)
        record["routes"]["fused" if fused else "unfused"] = {
            "launches": dict(zip(POPCOUNT, got)), "ms_per_forward": ms,
            "profile": prof, "max_abs": rep.max_abs,
            "within_1lsb": rep.within_1lsb}
    _exact(torch, raws[True], raws[False], "popcount fused vs unfused route")
    dot_configs = yolo.kernel_configs(art, size, BATCH, accum="dot",
                                      fuse_pool=True)
    _zero(launch.KERNELS)
    with torch.no_grad():
        dot_raw = yolo.yolo_forward_kernel(art, imgs, configs=dot_configs)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    record["dot_launches"] = {name: counts[name] for name in DOT}
    if tuple(record["dot_launches"].values()) != PER_FORWARD[True] or any(
            counts[name] for name in POPCOUNT + ("w1a8_matmul_int",)):
        raise AssertionError(f"dot forward: launches {counts}, want "
                             f"{PER_FORWARD[True]}")
    rep = verify.compare("dot_vs_float", dot_raw.cpu().numpy(), ref,
                         lsb=0.02)
    if not (rep.max_abs < 0.02 and rep.within_1lsb == 1.0):
        raise AssertionError(f"dot raw head outside the envelope: "
                             f"{rep.row()}")
    with torch.no_grad():
        forward = lambda: yolo.yolo_forward_kernel(  # noqa: E731
            art, imgs, configs=dot_configs)
        record["dot_ms_per_forward"] = cuda_ms(torch, forward, reps=5, n=10)
        record["dot_profile"] = device_profile(torch, forward)

    # per-tensor artifact: popcount and dot differ by the dot path's bf16
    # prologue rounding only
    _, art_t = yolo.build_detector(SEED, imgs, per_channel=False,
                                   device=dev)
    with torch.no_grad():
        pc = yolo.yolo_forward_kernel(art_t, imgs, accum="popcount")
        dot = yolo.yolo_forward_kernel(art_t, imgs, accum="dot")
    record["per_tensor_popcount_vs_dot"] = float((pc - dot).abs().max())
    if not record["per_tensor_popcount_vs_dot"] < 0.02:
        raise AssertionError(f"per-tensor popcount vs dot: {record}")

    # the int path: one call at conv9's shape on conv9's sign words
    conv9 = next(e for e in art["layers"] if e["spec"].name == "conv9")
    spec = conv9["spec"]
    h = yolo.spatial_sizes(size)["conv9"]
    a = torch.from_numpy(rng.integers(0, 256, (BATCH * h * h, spec.cin),
                                      dtype=np.uint8)).to(dev)
    signs = packing.unpack_signs(conv9["w_packed"], spec.cin,
                                 dtype=torch.float32)
    colsum = signs.sum(dim=0).to(torch.int32)
    _zero(launch.KERNELS)
    out = mm_ops.w1a8_matmul_int(a, conv9["w_packed"], colsum)
    torch.cuda.synchronize()
    launches["w1a8_matmul_int"] = launch.launch_counts()["w1a8_matmul_int"]
    with torch.no_grad():
        want = (a.to(torch.float64) @ signs.to(torch.float64)) \
            .to(torch.int32)
    _exact(torch, out, want, "int path vs the integer product")
    if launches["w1a8_matmul_int"] != 1:
        raise AssertionError(f"int path launches: {launches}")
    record["launches"] = launches
    print(f"[popcount forward] B={BATCH} {size}x{size}, per-channel "
          f"artifact: launches {record['routes']['fused']['launches']} "
          f"fused, {record['routes']['unfused']['launches']} unfused, raw "
          f"heads bit-identical, max_abs vs float "
          f"{record['routes']['fused']['max_abs']:.3g}; per-tensor "
          f"popcount vs dot {record['per_tensor_popcount_vs_dot']:.3g}; "
          f"int path launches {launches['w1a8_matmul_int']}", flush=True)
    for name, ms, prof in (
            ("popcount fused", record["routes"]["fused"]["ms_per_forward"],
             record["routes"]["fused"]["profile"]),
            ("popcount unfused",
             record["routes"]["unfused"]["ms_per_forward"],
             record["routes"]["unfused"]["profile"]),
            ("dot fused", record["dot_ms_per_forward"],
             record["dot_profile"])):
        print(f"[forward ms] {name}: {ms:.4f} ms per forward back to back "
              f"(CUDA events); profiled: device busy "
              f"{prof['device_busy_ms']:.4f} ms, host "
              f"{prof['wall_ms']:.4f} ms, "
              f"{_num(prof['device_launches'], '.0f')} device launches per "
              f"forward", flush=True)
    return record


def per_dispatch(configs) -> dict:
    """Launches of one dispatch by kernel, derived from the W1A8 layers'
    configs (dicts, as `DetectionBackend.configs` gives them): a fused
    pool layer launches its mode's fused kernel, an unfused one its mode's
    conv kernel (the 2×2 max is PyTorch's), a conv layer its mode's conv
    kernel and the matmul its mode's matmul; then one post-processing
    launch."""
    counts = {"detect_postprocess": 1}
    for cfg in configs:
        suffix = "_popcount" if cfg["accum"] == "popcount" else ""
        if cfg["op"] == "matmul":
            name = "w1a8_matmul"
        elif cfg["op"] == "conv3x3_pool" and cfg["fused"]:
            name = "w1a8_conv3x3_pool2"
        else:
            name = "w1a8_conv3x3"
        counts[name + suffix] = counts.get(name + suffix, 0) + 1
    return counts


def check_table() -> dict:
    """The committed autotune table's entries for this card; raises when
    it has none, so tuned serving can never quietly equal the dot
    default."""
    from repro_torch.kernels import config

    key = config.device_key()
    entries = {k: rec for k, rec in config.load_table().items()
               if config.parse_key(k)[3] == key}
    if len(entries) != WINNERS:
        raise AssertionError(
            f"the committed autotune table ({config.DEFAULT_TABLE.name}) "
            f"holds {len(entries)} entries for device key {key!r}, want "
            f"{WINNERS}: sweep it on this card with `{AUTOTUNE_CMD}`")
    return entries


def check_winners(torch, entries: dict, batch: int) -> list:
    """Each committed winner bit-exact against its accum mode's default
    config on the card, on the sweep's operands at the sweep's batch (no
    timing)."""
    from repro_torch.kernels.config import KernelConfig, parse_key
    from repro_torch.launch import autotune

    dev = torch.device("cuda", 0)
    held = []
    for key, rec in sorted(entries.items()):
        op, dims, accum, _ = parse_key(key)
        operands = autotune._operands(op, dims, batch, dev)
        default = autotune.candidates(op, dims, accum)[0]
        tuned = KernelConfig.from_dict(rec["config"])
        why = autotune.launch_error(op, dims, batch, tuned)
        if why is not None:
            raise AssertionError(f"{key}: winner cannot launch: {why}")
        _exact(torch, autotune._call(op, operands, tuned),
               autotune._call(op, operands, default),
               f"{key} winner {tuned} vs default")
        held.append(key)
    torch.cuda.synchronize()
    print(f"[autotune] {len(held)} committed winners bit-exact with their "
          f"defaults on the card (batch {batch})", flush=True)
    return held


def drive_main_path(profile: str) -> tuple:
    """Phase 4: the serving launcher under ``profile``, with every launch
    count zeroed just before and read just after; the raw-wire depth-2
    serve's launches must equal its dispatches times `per_dispatch` of
    the configs the backend resolved at 320. Returns (its record, the
    counts)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import yolo

    _zero(launch.KERNELS)
    record = launch.main(["--workload", "detect", "--requests", "16",
                          "--slots", str(BATCH), "--depth", "2",
                          "--profile", profile])
    launches = launch.launch_counts()
    dispatches = record["raw_wire_dispatches"]
    configs = record["configs"]["320"]
    per = per_dispatch(configs)
    check_dispatch_launches(record["raw_wire_launches"], dispatches,
                            configs, profile)
    for name in per:
        if not launches[name]:
            raise AssertionError(f"{profile}: {name} never launched")
    names = [s.name for s in yolo.YOLO_LAYERS if s.kind == "w1a8"]
    for name, cfg in zip(names, configs):
        print(f"[serve {profile}] {name}: {cfg}", flush=True)
    print(f"[serve {profile}] 16 requests, 0 dropped, checks passed; "
          f"raw-wire depth-2 serve: {dispatches} graph replays, launches "
          f"{ {k: v for k, v in record['raw_wire_launches'].items() if v} } "
          f"= {dispatches} x {per}", flush=True)
    return record, launches


def profile_dispatch(profile: str) -> dict:
    """Device busy, device records and idle share per dispatch under
    ``profile`` (`launch.profile`: 8 dispatches of 4 images, raw wire)."""
    from repro_torch.launch import profile as prof

    rec = prof.profile_dispatches(profile=profile)
    if rec["trace_lost"]:
        print(f"[profile {profile}] the trace lost records: "
              f"{rec['trace_lost']}", flush=True)
    print(f"[profile {profile}] per dispatch: device busy "
          f"{rec['device_busy_ms_per_dispatch']:.4f} ms, "
          f"{_num(rec['device_launches_per_dispatch'], '.0f')} device "
          f"records, idle share {_num(rec['device_idle_share'], '.3f')} "
          f"({rec['device_timing']}), W1A8 and post-processing "
          f"ms {({g: round(v, 5) for g, v in rec['groups'].items()})}",
          flush=True)
    return rec


def drive_multires() -> tuple:
    """Phase 4b: the launcher's multires workload at 256 and 320 (tuned):
    per-bucket raw heads bit-exact with each bucket served alone, and the
    launcher's other checks, per bucket; every launch count zeroed just
    before and read just after. Returns (its record, the counts)."""
    from repro_torch.launch import serve as launch

    _zero(launch.KERNELS)
    record = launch.main(["--workload", "multires", "--buckets", "256,320",
                          "--requests", "16", "--slots", str(BATCH)])
    launches = launch.launch_counts()
    for bucket, configs in record["configs"].items():
        for name in per_dispatch(configs):
            if not launches[name]:
                raise AssertionError(f"multires {bucket}: {name} never "
                                     f"launched")
        print(f"[multires] {bucket}: " + ", ".join(
            f"{c['op']} {c['accum']} rows={c['rows']} fused={c['fused']} "
            f"({c['source']})" for c in configs), flush=True)
    print(f"[multires] buckets {record['buckets']}, "
          f"{record['requests_per_bucket']} requests: per-bucket raw heads "
          f"bit-exact with each bucket alone, checks passed; alignment "
          f"{record['alignment']}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return record, launches


def sweep_tiles(np, boxes, scores, out_b, out_s, max_out: int,
                score_thresh: float, tile: int = 32) -> list:
    """Tiles of 32 ranks the post-processing kernel's sweep visits in each
    image, from its decoded inputs and its outputs: it stops at the tile
    that holds the max_out-th kept box, or after the last candidate."""
    tiles = []
    for bx, sc, kb, ks in zip(boxes, scores, out_b, out_s):
        best = sc.max(-1)
        score = np.where(best >= np.float32(score_thresh), best, 0)
        order = np.lexsort((np.arange(len(score)), -score))
        m = int((score > 0).sum())
        k = int((ks > 0).sum())
        last = m - 1
        if k == max_out:
            last = next(i for i, j in enumerate(order[:m])
                        if score[j] == ks[k - 1]
                        and (bx[j] == kb[k - 1]).all())
        tiles.append(last // tile + 1 if m else 0)
    return tiles


def check_graphs_and_postprocess(torch, np, dev) -> dict:
    """Phase 6: graph replays against eager forwards; the post-processing
    kernel's two entry points against `decode_head` + `nms_plain` on the
    card, bit for bit; its launches and the device records per dispatch
    through the replays; then its times at the served shape. Returns the
    kernel's record."""
    from repro_torch.launch import nms_fixtures
    from repro_torch.launch import serve as launch
    from repro_torch.models import detection, yolo
    from repro_torch.serve import DetectionBackend

    size = yolo.INPUT_SIZE
    imgs = launch.make_images(4 * BATCH, SEED + 3, size)
    _, art = yolo.build_detector(SEED, imgs[:1].astype(np.float32) / 256.0,
                                 device=dev)
    raws, served, per_dispatch = [], [], {}
    for device_nms in (False, True):
        backend = DetectionBackend(art, slots=BATCH, device=dev,
                                   device_nms=device_nms)
        batches = [backend._host_batch(list(imgs[i:i + BATCH]))
                   for i in range(0, len(imgs), BATCH)]
        backend._dispatch(batches[0])          # captures the graph
        torch.cuda.synchronize()
        replayed = {"detect_postprocess": 0, "detect_nms": 0}
        for batch in batches:
            _zero(launch.KERNELS)
            host = backend._host_outputs(size, *backend._dispatch(batch))
            for name in replayed:
                replayed[name] += launch.KERNELS[name].launches
            with torch.no_grad():
                eager = backend._forward(batch.to(dev).to(torch.float32)
                                         / 256.0)
            for got, want in zip(host, eager):
                _exact(torch, torch.from_numpy(got), want.cpu(),
                       f"graph replay vs eager forward, device_nms="
                       f"{device_nms}")
            if not device_nms:
                raws.append(host[0])
                served.append(host[1:])
        wire = "device_nms" if device_nms else "raw"
        if replayed != {"detect_postprocess": len(batches), "detect_nms": 0}:
            raise AssertionError(f"{wire} wire: launches {replayed} for "
                                 f"{len(batches)} replays, want one "
                                 f"detect_postprocess and no detect_nms a "
                                 f"dispatch")
        prof = device_profile(torch, lambda: backend._host_outputs(
            size, *backend._dispatch(batches[0])))
        per_dispatch[wire] = {"device_records": prof["device_launches"],
                              "device_busy_ms": prof["device_busy_ms"]}
    nb = len(raws)

    def held(raw, what, **post):
        """postprocess(raw) and nms(decode_head(raw)) against nms_plain on
        decode_head(raw), all on the card, bit for bit."""
        dec = detection.decode_head(raw)
        want = detection.nms_plain(dec["boxes"], dec["scores"], **post)
        for entry, got in (
                ("postprocess", detection.postprocess(raw, **post)),
                ("nms", detection.nms(dec["boxes"], dec["scores"], **post))):
            for g, w, field in zip(got, want, ("boxes", "scores", "classes")):
                _exact(torch, g, w, f"{entry} vs plain, {what}, {field}")
        return want

    raw = torch.from_numpy(np.concatenate(raws)).to(dev)
    got = held(raw, "served heads at 320")
    for g, field, parts in zip(got, ("boxes", "scores", "classes"),
                               zip(*served)):
        _exact(torch, g.cpu(), torch.from_numpy(np.concatenate(parts)),
               f"served {field} vs nms_plain on the served heads")
    small = torch.from_numpy(launch.make_images(BATCH, SEED + 4, 256)).to(dev)
    with torch.no_grad():
        raw256 = yolo.yolo_forward_kernel(
            art, small.to(torch.float32) / 256.0,
            configs=yolo.kernel_configs(art, 256, BATCH))
    held(raw256, "a batch at 256 (G = 8, 192 boxes)")
    head, peaks = nms_fixtures.separated_head()
    _, sep_scores, _ = held(torch.from_numpy(head).to(dev),
                            "score-separated fixture")
    if int((sep_scores > 0).sum()) != len(peaks):
        raise AssertionError(f"separated fixture: kept "
                             f"{int((sep_scores > 0).sum())} of {len(peaks)}")
    for name, fixture in nms_fixtures.HEADS.items():
        head, post = fixture()
        held(torch.from_numpy(head).to(dev), f"fixture {name}", **post)
    boxes, scores = (torch.from_numpy(x).to(dev)
                     for x in nms_fixtures.tied_boxes())
    for thresh in (nms_fixtures.TIE_IOU, 0.45):
        tie = detection.nms(boxes, scores, iou_thresh=thresh)
        for g, w in zip(tie, detection.nms_plain(boxes, scores,
                                                 iou_thresh=thresh)):
            _exact(torch, g, w, f"nms vs plain, tie fixture at {thresh}")
    tie_b, tie_s, _ = detection.nms(boxes, scores,
                                    iou_thresh=nms_fixtures.TIE_IOU)
    kept = [int(torch.nonzero((boxes[0] == tie_b[0, i]).all(-1))[0])
            for i in range(int((tie_s[0] > 0).sum()))]
    if tuple(kept) != nms_fixtures.TIE_KEPT:
        raise AssertionError(f"tie fixture kept {kept}, want "
                             f"{nms_fixtures.TIE_KEPT}")

    # times at the served shape: the first dispatch's four heads
    r4 = raw[:BATCH].contiguous()
    dec = detection.decode_head(r4)
    b4, s4 = dec["boxes"], dec["scores"]
    n, c = s4.shape[1:]
    max_out, score_thresh = 50, 0.25
    run = lambda: detection.postprocess(r4)  # noqa: E731
    out_b, out_s, _ = run()
    rec = {"shape": [BATCH, n, c, max_out], "served_heads": nb,
           "ms": cuda_ms(torch, run),
           "device_ms": device_profile(torch, run)["device_busy_ms"],
           "nms_device_ms": device_profile(
               torch, lambda: detection.nms(b4, s4))["device_busy_ms"],
           "decode_head_device_ms": device_profile(
               torch, lambda: detection.decode_head(r4))["device_busy_ms"],
           "plain_ms": cuda_ms(torch, lambda: detection.nms_plain(
               **detection.decode_head(r4)), reps=3, n=3),
           "library_ms": None, "per_dispatch": per_dispatch}
    scores_np = s4.cpu().numpy()
    rec["tiles"] = sweep_tiles(np, b4.cpu().numpy(), scores_np,
                               out_b.cpu().numpy(), out_s.cpu().numpy(),
                               max_out, score_thresh)
    # bytes: the raw head in, the outputs out; operations: the decode
    # (5 + 2C a box), the ranking (a compare per candidate pair) and an IoU
    # of each kept box with each candidate, as the greedy loop takes them
    cand = (scores_np.max(-1) >= score_thresh).sum(-1)
    kept_n = (out_s.cpu().numpy() > 0).sum(-1)
    rec["bytes"] = 4 * r4.numel() + BATCH * max_out * 24
    rec["ops"] = int(sum(n * (5 + 2 * c) + m * n + k * m * NMS_IOU_OPS
                         for m, k in zip(cand, kept_n)))
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"],
                                             FP32_OPS_PER_S)
    print(f"[graphs] {nb} served heads: each wire's graph replay equals an "
          f"eager forward bit for bit; one detect_postprocess launch and no "
          f"detect_nms launch a dispatch through the replays; device "
          f"records a dispatch: raw wire "
          f"{_num(per_dispatch['raw']['device_records'], '.0f')}, "
          f"device-NMS wire "
          f"{_num(per_dispatch['device_nms']['device_records'], '.0f')}; "
          f"device busy "
          f"{per_dispatch['raw']['device_busy_ms']:.4f} / "
          f"{per_dispatch['device_nms']['device_busy_ms']:.4f} ms",
          flush=True)
    print(f"[postprocess] detect_postprocess and detect_nms bit-exact with "
          f"decode_head + nms_plain on the card: served heads at 320 (and "
          f"the served detections), a batch at 256, the score-separated "
          f"fixture ({len(peaks)} kept), fixtures "
          f"{list(nms_fixtures.HEADS)}, tie fixture (kept {kept}); "
          f"B={BATCH}, {n} boxes, {c} classes: {rec['ms']:.4f} ms, device "
          f"{rec['device_ms']:.5f} ms (detect_nms on the decoded heads "
          f"{rec['nms_device_ms']:.5f}, decode_head "
          f"{rec['decode_head_device_ms']:.5f}; plain {rec['plain_ms']:.4f}, "
          f"bound {rec['bound_ms']:.6f} by {rec['bound_by']}); tiles swept "
          f"{rec['tiles']}", flush=True)
    return rec


def int_plain(entry, x):
    """The plain version of the integer PE entry point that runs
    ``entry``'s layer, on the tensors' device (integer sums, no matmul)."""
    from repro_torch.kernels.w1a8_int import ref
    from repro_torch.models import yolo
    spec = entry["spec"]
    if spec.name == "conv1":
        return ref.int_pe_conv1_ref(
            x, entry["w_raw"].reshape(-1, spec.cout), entry["b_shifted"],
            entry["post_mult"], entry["post_shift"], pool=spec.pool)
    if spec.name == "conv11":
        return ref.int_pe_head_ref(
            x, entry["w_raw"].reshape(-1, spec.cout), entry["m_raw"],
            entry["b_shifted"], yolo.FM)
    return ref.w1a8_int_pe_ref(
        x, entry["w_packed"], entry["m_raw"], entry["post_mult"],
        entry["b_pre"], entry["post_shift"], ksize=spec.ksize,
        pool=spec.pool)


def int_library(torch, entry, x):
    """F.conv2d in float64 on codes·m_raw and the ±1 or raw weights: the
    layer's accumulator, exact since every partial sum is an integer below
    2^53; the port never makes this call. Returns the call."""
    import torch.nn.functional as F
    spec = entry["spec"]
    a = x.to(torch.float64)
    if "m_raw" in entry:
        a = a * entry["m_raw"].to(torch.float64)
    a = a.permute(0, 3, 1, 2).contiguous()
    w = entry["signs"] if "signs" in entry else entry["w_raw"]
    w = w.to(torch.float64).reshape(spec.ksize, spec.ksize, spec.cin,
                                    spec.cout).permute(3, 2, 0, 1) \
        .contiguous()
    return lambda: F.conv2d(a, w, padding=spec.ksize // 2)


def int_bytes_ops(entry, x, out) -> tuple:
    """Bytes the layer must move (codes in, weights, per-channel constants,
    output) and its operations (2 per MAC)."""
    spec = entry["spec"]
    w = entry["w_packed"] if "w_packed" in entry else entry["w_raw"]
    consts = sum(entry[k].numel() * 8 for k in (
        "m_raw", "post_mult", "post_shift", "b_pre", "b_shifted")
        if k in entry)
    nbytes = (x.numel() + w.numel() * w.element_size() + consts
              + out.numel() * out.element_size())
    b, h, wd, _ = x.shape
    return nbytes, 2 * b * h * wd * spec.ksize ** 2 * spec.cin * spec.cout


def check_int_pe(torch, np, dev, art) -> list:
    """Phase 7a: the integer PE's three entry points bit for bit against
    their plain versions on the card: at every layer shape of the 320 path
    (the deployed artifact's constants and digit planes, random codes) at
    B = 1 and 4; off the grid (INT_OFF_GRID: Cin 3, 16, 24, 48 and 128,
    ragged Cout) for every kind, ksize and pool it takes, with random m,
    mult, shift (0 included) and int40 biases; on the overflow operands
    (m_raw ≈ 2^17, codes 255, every sign +1 at K = 1152: |acc| ≈ 3.9e10,
    3 planes), on m_raw of 1 to 9 planes and INT64_MIN (10) at the W1A8
    kind, pooled and not, and at the head, the large ones wrapping numpy's
    int64 sum; and on a head with negative values on rounding ties. Times
    each layer at B = 4. Returns the per-layer records."""
    from repro_torch.core import packing
    from repro_torch.kernels.w1a8_int import ops, planes as pl, ref
    from repro_torch.models import yolo

    rng = np.random.default_rng(SEED + 3)
    sizes = yolo.spatial_sizes(yolo.INPUT_SIZE)
    records = []

    def codes(shape):
        return torch.from_numpy(rng.integers(0, 256, shape,
                                             dtype=np.uint8)).to(dev)
    for batch in INT_BATCHES:
        for entry in art["layers"]:
            spec = entry["spec"]
            h = sizes[spec.name]
            x = codes((batch, h, h, spec.cin))
            out = yolo.int_layer(entry, x)
            want = int_plain(entry, x)
            torch.cuda.synchronize()
            _exact(torch, out, want, f"int PE {spec.name} B={batch}")
            if batch != BATCH:
                continue
            nbytes, ops_n = int_bytes_ops(entry, x, out)
            run = lambda: yolo.int_layer(entry, x)  # noqa: E731
            library = int_library(torch, entry, x)
            acc = library()
            if float(acc.abs().max()) >= 2 ** 53:
                raise AssertionError(f"{spec.name}: float64 library sum "
                                     f"is not exact")
            rec = {"layer": spec.name,
                   "shape": [batch, h, h, spec.cin, spec.cout],
                   "planes": int(entry["planes"].shape[0]),
                   "ms": cuda_ms(torch, run),
                   "device_ms": device_profile(torch, run)["device_busy_ms"],
                   "plain_ms": cuda_ms(torch, lambda: int_plain(entry, x),
                                       reps=3, n=3),
                   "library_ms": cuda_ms(torch, library, reps=3, n=3),
                   "library_device_ms": device_profile(
                       torch, library, n=3)["device_busy_ms"],
                   "before_device_ms": INT_BEFORE_DEVICE_MS[spec.name],
                   "bytes": nbytes, "ops": ops_n}
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops_n,
                                                     INT8_OPS_PER_S)
            print(f"[int pe] {spec.name} {rec['shape']}: P = "
                  f"{rec['planes']}, bit-exact at B = {INT_BATCHES}; "
                  f"{rec['ms']:.4f} ms, device {rec['device_ms']:.5f} ms "
                  f"(before {rec['before_device_ms']:.4f}; plain "
                  f"{rec['plain_ms']:.4f}, float64 conv2d "
                  f"{rec['library_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.5f}, bound "
                  f"{rec['bound_ms']:.6f} by {rec['bound_by']})", flush=True)
            records.append(rec)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape,
                                             dtype=np.int64)).to(dev)

    def signs(k, cout):
        return packing.pack_signs(ints(0, 2, (k, cout)) * 2 - 1, axis=0)

    def w1a8_case(x, wp, m, mult, bias, shift, ksize, pool, what):
        _exact(torch, ops.w1a8_int_pe(x, wp, m, mult, bias, shift,
                                      ksize=ksize, pool=pool),
               ref.w1a8_int_pe_ref(x, wp, m, mult, bias, shift, ksize=ksize,
                                   pool=pool), f"w1a8 {what}")

    def head_case(x, w, m, bias, shift, what):
        _exact(torch, ops.int_pe_head(x, w, m, bias, shift),
               ref.int_pe_head_ref(x, w, m, bias, shift), f"head {what}")
    b, h = 2, 18
    for cin, cout in INT_OFF_GRID:
        for ksize, pool in ((3, True), (3, False), (1, False), (1, True)):
            x = codes((b, h, h, cin))
            k = ksize * ksize * cin
            m = ints(1, 1 << 17, cin)
            mult, bias = ints(0, 1 << 15, cout), ints(-(1 << 40), 1 << 40,
                                                      cout)
            shift = ints(0, 47, cout)
            shift[0] = 0
            w = ints(-(1 << 16), 1 << 16, (k, cout))
            what = (f"off the grid (B {b}, {h}x{h}, Cin {cin}, Cout {cout}) "
                    f"ksize {ksize} pool {pool}")
            w1a8_case(x, signs(k, cout), m, mult, bias, shift, ksize, pool,
                      what)
            if ksize == 3:
                _exact(torch, ops.int_pe_conv1(x, w, bias, mult, shift,
                                               pool=pool),
                       ref.int_pe_conv1_ref(x, w, bias, mult, shift,
                                            pool=pool), f"conv1 {what}")
            elif not pool:
                head_case(x, w, m, bias, 16, what)

    # overflow: int32 accumulation would wrap
    x = torch.full((BATCH, 20, 20, 128), 255, dtype=torch.uint8, device=dev)
    wp = packing.pack_signs(torch.ones(1152, 128, device=dev), axis=0)
    m = (1 << 17) - ints(0, 64, 128)
    mult, shift = ints(1 << 14, 1 << 15, 128), ints(40, 47, 128)
    bias = ints(-(1 << 40), 1 << 40, 128)
    acc = ref.accumulate(x, m, packing.unpack_signs(wp, 1152,
                                                    dtype=torch.int64), 3)
    overflow_acc = float(acc.abs().max())
    if not overflow_acc > 3e10 or pl.plane_count(m) != 3:
        raise AssertionError("the overflow operands stay inside int32")
    w1a8_case(x, wp, m, mult, bias, shift, 3, False, "overflow operands")
    # m_raw of 1 to 9 planes (7P bits), then INT64_MIN (10): numpy's int64
    # sum wraps from 8 planes on, and the fused max is over the codes
    x = codes((2, 10, 10, 128))
    wp = signs(1152, 96)
    wrapped = []
    for p in range(1, pl.MAX_PLANES + 1):
        if p < pl.MAX_PLANES:
            m = ints(1 << (7 * p - 7), min(1 << (7 * p), (1 << 63) - 1),
                     128)
        else:
            m = torch.full((128,), -(1 << 63), dtype=torch.int64,
                           device=dev)
        if pl.plane_count(m) != p:
            raise AssertionError(f"m_raw of {p} planes has "
                                 f"{pl.plane_count(m)}")
        exact = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2).double() * m.double()[None, :, None, None],
            packing.unpack_signs(wp, 1152, dtype=torch.float64).reshape(
                3, 3, 128, 96).permute(3, 2, 0, 1), padding=1)
        if float(exact.abs().max()) > 2.0 ** 63:
            wrapped.append(p)
        mult, bias = ints(1, 1 << 15, 96), ints(-(1 << 40), 1 << 40, 96)
        shift = ints(0, 63, 96)
        for pool in (True, False):
            w1a8_case(x, wp, m, mult, bias, shift, 3, pool,
                      f"m_raw of {p} planes, pool {pool}")
        head_case(x[..., :64], ints(-3, 4, (64, 75)), m[:64], bias[:75],
                  20, f"m_raw of {p} planes")
    if not set(range(8, pl.MAX_PLANES + 1)) <= set(wrapped):
        raise AssertionError(f"numpy's int64 sum wraps only at planes "
                             f"{wrapped}")
    # the head on exact ties of the 16-bit shift, negatives included
    x = codes((BATCH, 10, 10, 64))
    w = ints(0, 2, (64, 75)) * 2 - 1
    m = torch.full((64,), 1 << 15, dtype=torch.int64, device=dev)
    bias = ints(-400, 400, 75)
    want = ref.int_pe_head_ref(x, w, m, bias, 16)
    acc = ref.accumulate(x, m, w, 1)
    if not (bool((want < 0).any()) and bool(
            ((acc < 0) & (acc.abs() % (1 << 16) == 1 << 15)).any())):
        raise AssertionError("the head fixture has no negative tie")
    _exact(torch, ops.int_pe_head(x, w, m, bias, 16), want,
           "int PE head on negative ties")
    torch.cuda.synchronize()
    print(f"[int pe] off the grid (B 2, 18×18, (Cin, Cout) "
          f"{INT_OFF_GRID}: W1A8 3×3 and 1×1, pooled and not; conv1 pooled "
          f"and not; the head), overflow operands (max |acc| "
          f"{overflow_acc:.6g}, 3 planes), m_raw of 1 to "
          f"{pl.MAX_PLANES} planes (numpy's int64 sum wrapping at "
          f"{wrapped}) and a head on negative ties: bit-exact", flush=True)
    return records


def drive_int(torch, np, dev) -> dict:
    """Phase 7b: `yolo_forward_int` at B = 4, 320×320 on the card, with
    every launch count zeroed just before and read just after: one integer
    PE launch per layer, the raw head equal to the plain version's (on the
    CPU) as int64 and inside INT_ENVELOPE of the port's float forward.
    Prints `launch/alignment.py`'s rows. Returns the record, with the
    per-layer records of `check_int_pe`."""
    from repro_torch.core import verify
    from repro_torch.launch import alignment
    from repro_torch.launch import serve as launch
    from repro_torch.models import yolo

    rng = np.random.default_rng(SEED + 4)
    img_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, yolo.INPUT_SIZE, yolo.INPUT_SIZE, 3),
        dtype=np.uint8)).to(dev)
    img = img_u8.to(torch.float32) / torch.tensor(256.0, device=dev)
    with torch.no_grad():
        params = yolo.calibrate_yolo(yolo.init_yolo_params(SEED, device=dev),
                                     img)
        art = yolo.deploy_yolo(params)
        layers = check_int_pe(torch, np, dev, art)
        _zero(launch.KERNELS)
        raw = yolo.yolo_forward_int(art, img_u8, device=dev)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        n_layers = len(yolo.YOLO_LAYERS)
        if counts[INT_PE] != n_layers or any(
                n for name, n in counts.items() if name != INT_PE):
            raise AssertionError(f"int forward: launches {counts}, want "
                                 f"{n_layers} of {INT_PE} alone")
        art_cpu = {"layers": [{k: (v.cpu() if hasattr(v, "cpu") else v)
                               for k, v in e.items()}
                              for e in art["layers"]]}
        t0 = time.perf_counter()
        want = yolo.yolo_forward_int(art_cpu, img_u8.cpu(), device="cpu")
        cpu_s = time.perf_counter() - t0
        _exact(torch, raw.cpu(), want, "int forward vs its plain version")
        ref = yolo.yolo_forward_float(params, img).double().cpu().numpy()
    rep = verify.compare("int_vs_float", raw.cpu().numpy() / 2.0 ** 15, ref,
                         lsb=0.02)
    if not (rep.max_abs < INT_ENVELOPE[0] and rep.mean_abs < INT_ENVELOPE[1]
            and rep.within_1lsb == 1.0):
        raise AssertionError(f"int raw head outside the envelope: "
                             f"{rep.row()}")
    with torch.no_grad():
        forward = lambda: yolo.yolo_forward_int(  # noqa: E731
            art, img_u8, device=dev)
        ms = cuda_ms(torch, forward, reps=5, n=10)
        prof = device_profile(torch, forward)
    record = {"launches": {INT_PE: counts[INT_PE]}, "ms_per_forward": ms,
              "profile": prof, "plain_cpu_s": cpu_s, "max_abs": rep.max_abs,
              "mean_abs": rep.mean_abs, "corr": rep.corr,
              "within_1lsb": rep.within_1lsb, "layers": layers}
    print(f"[int forward] B={BATCH} {yolo.INPUT_SIZE}x{yolo.INPUT_SIZE}: "
          f"{counts[INT_PE]} {INT_PE} launches, raw head bit-exact with the "
          f"plain version ({cpu_s:.2f} s on the CPU), vs float max_abs "
          f"{rep.max_abs:.6g} mean_abs {rep.mean_abs:.6g} corr "
          f"{rep.corr:.6f}; {ms:.4f} ms per forward back to back (CUDA "
          f"events), device busy {prof['device_busy_ms']:.5f} ms (before "
          f"{INT_BEFORE_DEVICE_MS['forward']}), "
          f"{_num(prof['device_launches'], '.0f')} device launches per "
          f"forward", flush=True)
    with torch.no_grad():
        record["alignment"] = alignment.run(size=yolo.INPUT_SIZE, device=dev)
    for name, value, note in record["alignment"]:
        print(f"[alignment] {name} {value!r} {note}", flush=True)
    return record


def _max_rel_err(np, got: dict, want: dict) -> dict:
    """{layer.name: max|got − want| / max|want|} over the params' leaves,
    both moved to the host."""
    out = {}
    for layer in sorted(want):
        for k in sorted(want[layer]):
            g = got[layer][k].detach().double().cpu().numpy()
            w = want[layer][k].detach().double().cpu().numpy()
            scale = float(np.abs(w).max())
            out[f"{layer}.{k}"] = (float(np.abs(g - w).max()) / scale
                                   if scale > 0 else float(np.abs(g).max()))
    return out


def check_qat_step(torch, np, dev) -> dict:
    """Phase 9a: one QAT train step on the card against the same step on
    the CPU, from the same params and batch (the card's, moved over), with
    cuDNN's TF32 flag left at its default outside the trainer. A code that
    rounds across a tie on one side only is forced to the CPU's
    (`train.ties`, within 1e-3 of a tie on both). Loss and gradient norm
    within rtol 1e-4, each gradient leaf within 1e-3·max|g|: the backward
    runs in full f32. Also prints how far a backward outside `full_f32`
    (cuDNN's TF32 default) lands, which that check would catch."""
    from repro_torch.data import pipeline as data
    from repro_torch.models import yolo
    from repro_torch.optim import adamw, tree_leaves, tree_map
    from repro_torch.train import ties, yolo_qat

    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN's TF32 flag is off before the QAT step: "
                             "the check would not show a TF32 backward")
    ds = data.make_detection_dataset(QAT_PARITY_BATCH, seed=SEED)
    img, boxes, classes = data.detection_batch(ds, 0, device=dev)
    with torch.no_grad():
        params = yolo.calibrate_yolo(yolo.init_yolo_params(SEED, device=dev),
                                     img)
    host = lambda t: tree_map(lambda v: v.cpu(), t)  # noqa: E731
    target = data.yolo_target(boxes, classes)
    opt = adamw(1e-3)
    # the eager body: a graph captured inside ties.forced would keep the
    # forced codes in every replay (9b holds the replay against this body)
    step = yolo_qat.make_eager_step(opt)

    t0 = time.perf_counter()
    with ties.record() as recorded:
        loss_c, grads_c = yolo_qat.loss_and_grads(host(params), img.cpu(),
                                                  target.cpu())
        _, _, m_c = step(host(params), opt[0](host(params)), img.cpu(),
                         boxes.cpu(), classes.cpu())
    cpu_s = time.perf_counter() - t0
    with ties.forced(recorded) as forced:
        loss_g, grads_g = yolo_qat.loss_and_grads(params, img, target)
        _, _, m_g = step(params, opt[0](params), img, boxes, classes)
    torch.cuda.synchronize()
    errs = _max_rel_err(np, grads_g, grads_c)
    rel = lambda a, b: abs(float(a) / float(b) - 1.0)  # noqa: E731
    if (rel(loss_g, loss_c) > 1e-4 or rel(m_g["loss"], m_c["loss"]) > 1e-4
            or rel(m_g["grad_norm"], m_c["grad_norm"]) > 1e-4
            or max(errs.values()) > 1e-3):
        raise AssertionError(
            f"QAT step on the card vs the CPU: loss {float(loss_g)} vs "
            f"{float(loss_c)}, grad_norm {float(m_g['grad_norm'])} vs "
            f"{float(m_c['grad_norm'])}, gradient errors {errs}")
    # the same gradients with the backward outside full_f32: TF32 convs
    leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
    with ties.forced(recorded):
        loss = yolo_qat.yolo_loss(leaves, img, target)
    flat = tree_leaves(leaves)
    tf32 = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    tf32_errs = _max_rel_err(
        np, tree_map(lambda v: tf32[id(v)], leaves), grads_c)
    record = {"loss_card": float(loss_g), "loss_cpu": float(loss_c),
              "grad_norm_card": float(m_g["grad_norm"]),
              "grad_norm_cpu": float(m_c["grad_norm"]),
              "max_grad_rel_err": max(errs.values()),
              "grad_rel_err": errs, "forced_codes": forced,
              "tf32_backward_max_grad_rel_err": max(tf32_errs.values()),
              "batch": QAT_PARITY_BATCH, "cpu_s": cpu_s}
    worst = max(errs, key=errs.get)
    print(f"[qat] one step, B={QAT_PARITY_BATCH} 320x320, card vs CPU: loss "
          f"{float(loss_g):.7g} vs {float(loss_c):.7g}, grad norm "
          f"{float(m_g['grad_norm']):.7g} vs {float(m_c['grad_norm']):.7g}, "
          f"worst gradient leaf {worst} {errs[worst]:.3g}·max|g| (limit "
          f"1e-3), codes forced at ties {forced}; a TF32 backward would be "
          f"{record['tf32_backward_max_grad_rel_err']:.3g}·max|g| off",
          flush=True)
    return record


def _rel_diff(torch, got, want) -> float:
    """max|got − want| / max|want| (max|got| where want is all zero), in
    float64 on the device; 0.0 exactly where they are equal."""
    g, w = got.double(), want.double()
    scale = float(torch.max(torch.abs(w)))
    diff = float(torch.max(torch.abs(g - w)))
    return diff / scale if scale > 0 else diff


@contextlib.contextmanager
def swapped(module, name: str, value):
    """``module.name`` is ``value`` inside."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def check_qat_replay(torch, np, dev, smi: str) -> dict:
    """Phase 9b: the trainer's step (`make_yolo_train_step`: one CUDA
    graph replay a step after its capture) against its eager body
    (`make_eager_step`) on the card, from the same calibrated params and
    QAT_REPLAY_STEPS batches at B = QAT_BATCH, 320×320, once with cuDNN
    restricted to its deterministic algorithms and once as the trainer
    runs (cuDNN's default, whose backward algorithms may sum in an order
    that changes from run to run). In each, the eager body runs twice
    first. If the two runs agree bit for bit, every param, mu, nu, step,
    loss and grad norm of the replayed steps must too. Else each step is
    taken again from the first eager run's state before it, eagerly and
    replayed, and the replay held within 9a's contract of that step's
    eager result: loss and grad norm within rtol 1e-4, each param, mu and
    nu leaf within 1e-3·max|x| (its difference printed beside the two
    eager runs'; over several steps the runs part, since a code that
    flips at a rounding tie changes the next step's gradients). After the
    capture each step is one `CUDAGraph.replay` and no `yolo_loss` call;
    no kernel of the port launches (cuDNN runs the convs), so the replays
    credit none."""
    from repro_torch.data import pipeline as data
    from repro_torch.launch import serve as launch
    from repro_torch.launch.train_yolo_qat import LR
    from repro_torch.models import yolo
    from repro_torch.optim import adamw, tree_map
    from repro_torch.optim.optimizers import tree_items
    from repro_torch.train import yolo_qat

    t0 = time.perf_counter()
    ds = data.make_detection_dataset(QAT_BATCH, seed=SEED)
    batches = [data.detection_batch(ds, i, device=dev)
               for i in range(QAT_REPLAY_STEPS)]
    with torch.no_grad():
        params = yolo.calibrate_yolo(yolo.init_yolo_params(SEED, device=dev),
                                     batches[0][0])
    opt = adamw(LR)
    first = tree_map(torch.clone, params)
    clone = lambda t: tree_map(torch.clone, t)  # noqa: E731

    def leaves(out) -> dict:
        return {path: t.clone() for path, t in tree_items(out)}

    def diffs(got: list, want: list) -> list:
        return [{k: _rel_diff(torch, g[k], w[k]) for k in w}
                for g, w in zip(got, want)]

    def worst(ds: list) -> list:
        return [max(d.values()) for d in ds]

    def counted(fn, *args):
        with counting_calls(yolo_qat, "yolo_loss") as n_loss, \
                counting_calls(torch.cuda.CUDAGraph, "replay") as n_replay:
            out = fn(*args)
        torch.cuda.synchronize()
        return out, n_loss[0], n_replay[0]

    def chain(fn) -> tuple:
        """QAT_REPLAY_STEPS steps of ``fn`` from ``params``: the leaves
        after each, the (params, state) before each, and the yolo_loss
        and CUDAGraph.replay calls a step."""
        p, s = params, opt[0](params)
        out, before, calls = [], [], []
        for b in batches:
            before.append(clone((p, s)))
            (p, s, m), n_loss, n_replay = counted(fn, p, s, *b)
            calls.append((n_loss, n_replay))
            out.append(leaves((p, s, m)))
        return out, before, calls

    def one_mode(name: str) -> dict:
        body = yolo_qat.make_eager_step(opt)
        eager, before, _ = chain(body)
        eager_diff = diffs(chain(body)[0], eager)
        _zero(launch.KERNELS)
        step = yolo_qat.make_yolo_train_step(opt)
        replay, _, calls = chain(step)
        bitwise = not any(worst(eager_diff))
        rec = {"eager_vs_eager_worst": worst(eager_diff),
               "eager_vs_eager_differing_leaves": [
                   sum(v > 0 for v in d.values()) for d in eager_diff]}
        if bitwise:
            rec["contract"] = "bit for bit"
            replay_diff = diffs(replay, eager)
            bad = [(i, k, v) for i, d in enumerate(replay_diff)
                   for k, v in d.items() if v]
        else:
            rec["contract"] = ("from each step's eager state: loss and grad "
                               "norm rtol 1e-4, each leaf 1e-3·max|x|")
            again, replay_diff, bad = [], [], []
            for i, b in enumerate(batches):
                e1, _, _ = counted(body, *clone(before[i]), *b)
                r, n_loss, n_replay = counted(step, *clone(before[i]), *b)
                calls.append((n_loss, n_replay))
                again.append(leaves(e1))
                replay_diff += diffs([leaves(r)], [eager[i]])
            rec["same_state_eager_vs_eager_worst"] = worst(
                diffs(again, eager))
            for i, d in enumerate(replay_diff):
                for k, v in d.items():
                    limit = (0.0 if k.endswith("['step']") else 1e-4
                             if k.startswith("[2]") else 1e-3)
                    if v > limit:
                        bad.append((i, k, v))
        counts = {k: n for k, n in launch.launch_counts().items() if n}
        want = [(yolo_qat.WARM_STEPS + 1, 1)] + [(0, 1)] * (len(calls) - 1)
        if calls != want or counts or step.graph.launches.counts:
            raise AssertionError(
                f"QAT replay ({name}): (yolo_loss, CUDAGraph.replay) calls a "
                f"step {calls}, port launches {counts}, captured "
                f"{step.graph.launches.counts}")
        if bad:
            raise AssertionError(f"QAT replay ({name}) against the eager "
                                 f"body, {rec['contract']}: {bad[:8]} "
                                 f"({len(bad)} leaves)")
        rec.update({"replay_vs_eager_worst": worst(replay_diff),
                    "tensors_compared": sum(len(d) for d in replay_diff),
                    "calls": calls,
                    "loss": [float(e["[2]['loss']"]) for e in eager]})
        print(f"[qat] (9b) {name}: eager body twice at B={QAT_BATCH} "
              f"320x320 over {QAT_REPLAY_STEPS} steps, worst leaf "
              f"difference a step {rec['eager_vs_eager_worst']} "
              f"(max|a-b|/max|b|; leaves that differ "
              f"{rec['eager_vs_eager_differing_leaves']}); "
              + ("" if bitwise else
                 f"from each step's eager state, eager again "
                 f"{rec['same_state_eager_vs_eager_worst']}, ")
              + f"the replayed step {rec['replay_vs_eager_worst']}, held "
              f"{rec['contract']} ({rec['tensors_compared']} tensors: "
              f"params, mu, nu, step, loss, grad norm); (yolo_loss, "
              f"CUDAGraph.replay) calls a step {calls}, no port launch "
              f"({smi})", flush=True)
        return rec

    with swapped(torch.backends.cudnn, "deterministic", True):
        out = {"deterministic cuDNN": one_mode("deterministic cuDNN")}
    out["default cuDNN"] = one_mode("default cuDNN")
    if any(not torch.equal(params[n][k], first[n][k])
           for n in first for k in first[n]):
        raise AssertionError("QAT replay: the caller's params were written")
    out.update({"steps": QAT_REPLAY_STEPS, "batch": QAT_BATCH,
                "wall_s": time.perf_counter() - t0})
    return out


def qat_turns(torch, np, dev, smi: str) -> tuple:
    """Phase 9's 30-step run, `launch/train_yolo_qat.train` (QAT_STEPS
    steps at B = QAT_BATCH, 320×320) with its step a graph replay (the
    trainer's) and, with `make_yolo_train_step` swapped for the eager body,
    eager, in turns (replay, eager, eager, replay): CUDA-event ms a step
    (median), peak memory, the 30 steps' wall seconds, and the host ms of
    each `data.detection_batch` call in the loop (its copies to the card
    wait for the stream, so a call also holds the previous step's device
    work); the held-out loss must fall in each. Then the sampler alone (30
    batches, then a sync), and `device_profile` of 5 more steps of each
    from the trained params: device busy ms, records and idle share of
    the step's CUDA-event ms. Returns (the record, the last replayed run's
    params, its dataset)."""
    from repro_torch.data import pipeline as data
    from repro_torch.launch import train_yolo_qat
    from repro_torch.optim import adamw, tree_map
    from repro_torch.train import yolo_qat

    makes = {"replay": yolo_qat.make_yolo_train_step,
             "eager": yolo_qat.make_eager_step}
    sampler = data.detection_batch
    runs = {"replay": [], "eager": []}
    for kind in ("replay", "eager", "eager", "replay"):
        host = []

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = sampler(*args, **kwargs)
            host.append(1e3 * (time.perf_counter() - t0))
            return out
        with swapped(train_yolo_qat, "make_yolo_train_step", makes[kind]), \
                swapped(data, "detection_batch", timed):
            params, ds, rec = train_yolo_qat.train(QAT_STEPS, QAT_BATCH, SEED,
                                                   dev)
        if not rec["held_out_loss_after"] < rec["held_out_loss_before"]:
            raise AssertionError(f"QAT ({kind}): the held-out loss did not "
                                 f"fall: {rec}")
        rec["sampler_host_ms_in_loop"] = statistics.median(host[-QAT_STEPS:])
        runs[kind].append(rec)
        print(f"[qat] (turn: {kind}) {QAT_STEPS} steps at B={QAT_BATCH}: "
              f"{rec['ms_per_step']:.4f} ms a step (CUDA events, median; "
              f"first step {rec['first_step_ms']:.1f}), "
              f"{rec['img_per_s']:.1f} img/s, peak memory "
              f"{rec['peak_memory_bytes'] / 2 ** 20:.1f} MiB, wall "
              f"{rec['wall_s']:.3f} s, sampler "
              f"{rec['sampler_host_ms_in_loop']:.3f} host ms a call in the "
              f"loop; held-out {rec['held_out_loss_before']:.6g} -> "
              f"{rec['held_out_loss_after']:.6g} ({smi})", flush=True)
    t0 = time.perf_counter()
    for i in range(QAT_STEPS):
        sampler(ds, i, device=dev)
    torch.cuda.synchronize()
    sampler_alone_ms = 1e3 * (time.perf_counter() - t0) / QAT_STEPS

    opt = adamw(train_yolo_qat.LR)
    batch = sampler(ds, QAT_STEPS, device=dev)
    profiles = {}
    for kind, make in makes.items():
        step = make(opt)
        live = {"params": tree_map(torch.clone, params)}
        live["state"] = opt[0](live["params"])

        def one_step():
            live["params"], live["state"], _ = step(live["params"],
                                                    live["state"], *batch)
        prof = device_profile(torch, one_step, n=5)
        ms = statistics.mean(r["ms_per_step"] for r in runs[kind])
        prof["idle_share_of_step"] = (
            None if prof["device_launches"] is None
            else 1.0 - prof["device_busy_ms"] / ms)
        profiles[kind] = prof
        del step, live
    out = {"runs": runs, "profile": profiles,
           "sampler_host_ms_alone": sampler_alone_ms}
    per = {k: [r["ms_per_step"] for r in v] for k, v in runs.items()}
    mib = {k: [round(r["peak_memory_bytes"] / 2 ** 20, 1) for r in v]
           for k, v in runs.items()}
    print(f"[qat] turns (replay, eager, eager, replay): ms a step "
          f"{per['replay'][0]:.4f}, {per['eager'][0]:.4f}, "
          f"{per['eager'][1]:.4f}, {per['replay'][1]:.4f}; device busy "
          f"replay {profiles['replay']['device_busy_ms']:.4f} ms "
          f"({_num(profiles['replay']['device_launches'], '.1f')} device "
          f"records), eager {profiles['eager']['device_busy_ms']:.4f} ms "
          f"({_num(profiles['eager']['device_launches'], '.1f')}); idle "
          f"share of the step replay "
          f"{_num(profiles['replay']['idle_share_of_step'], '.4f')}, eager "
          f"{_num(profiles['eager']['idle_share_of_step'], '.4f')} "
          f"({profiles['replay']['device_timing']}, "
          f"{profiles['eager']['device_timing']}); peak memory replay "
          f"{mib['replay']} MiB, eager {mib['eager']} MiB; wall s replay {[r['wall_s'] for r in runs['replay']]}, "
          f"eager {[r['wall_s'] for r in runs['eager']]}; the sampler "
          f"{sampler_alone_ms:.3f} host ms a batch alone ({smi})",
          flush=True)
    return out, params, ds


def drive_qat(torch, np, dev, smi: str) -> dict:
    """Phase 9: the paper's offline workflow on the card. `check_qat_step`
    (9a, the eager body, card against CPU), `check_qat_replay` (9b, the
    replayed step against the eager body on the card), then `qat_turns`
    (`launch/train_yolo_qat.train`, QAT_STEPS AdamW steps at B =
    QAT_BATCH, 320×320, replayed and eager in turns): the held-out loss
    must fall; ms per step (CUDA events) and images per second, peak
    memory, and from torch.profiler the device busy ms and idle share of a
    step. Then, on the last replayed run's params, with every launch
    count zeroed just before each and read just after: `yolo_forward_int`
    of the trained artifact on BATCH test images (11 integer PE launches
    and no other kernel, bit-exact with the plain version on the CPU, the
    int head within test_system's envelope of the float head:
    corr > 0.99, mean_abs < 0.01, 100% within 1 LSB of 0.02), `postprocess`
    on that head (1 `detect_postprocess` launch, bit for bit with
    `decode_head` + `nms_plain` on the card) and `launch/alignment.py`'s
    Table 6 rows on the trained params (the kernel path under the tuned
    profile: PER_FORWARD[True] popcount launches). Returns the record,
    with the launches of those three as the path's."""
    from repro_torch.core import verify
    from repro_torch.data import pipeline as data
    from repro_torch.launch import alignment, train_yolo_qat
    from repro_torch.launch import serve as launch
    from repro_torch.models import detection, yolo

    record = {"step_parity": check_qat_step(torch, np, dev),
              "replay_parity": check_qat_replay(torch, np, dev, smi)}
    turns, params, ds = qat_turns(torch, np, dev, smi)
    train = turns["runs"]["replay"][-1]
    record.update({"train": train, "turns": turns,
                   "step_profile": turns["profile"]["replay"]})

    by_path = {}
    art = yolo.deploy_yolo(params)
    img, _, _ = data.detection_batch(ds, train_yolo_qat.TEST_STEP, device=dev)
    img = img[:BATCH]
    img_u8 = torch.clamp(torch.round(img * 256.0), 0, 255).to(torch.uint8)
    with torch.no_grad():
        _zero(launch.KERNELS)
        raw_i = yolo.yolo_forward_int(art, img_u8, device=dev)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        n_layers = len(yolo.YOLO_LAYERS)
        if counts[INT_PE] != n_layers or any(
                n for name, n in counts.items() if name != INT_PE):
            raise AssertionError(f"QAT int forward: launches {counts}, want "
                                 f"{n_layers} of {INT_PE} alone")
        by_path["int forward"] = counts
        art_cpu = {"layers": [{k: (v.cpu() if hasattr(v, "cpu") else v)
                               for k, v in e.items()}
                              for e in art["layers"]]}
        _exact(torch, raw_i.cpu(), yolo.yolo_forward_int(
            art_cpu, img_u8.cpu(), device="cpu"),
            "trained int forward vs its plain version")
        out_f = yolo.yolo_forward_float(params, img)
    rep = verify.compare("final_raw (trained)",
                         raw_i.cpu().numpy() / 2.0 ** 15,
                         out_f.double().cpu().numpy(), lsb=0.02)
    if not (rep.corr > 0.99 and rep.mean_abs < 0.01
            and rep.within_1lsb == 1.0):
        raise AssertionError(f"trained int head outside the envelope: "
                             f"{rep.row()}")
    record["final_raw"] = {"max_abs": rep.max_abs, "mean_abs": rep.mean_abs,
                           "corr": rep.corr, "within_1lsb": rep.within_1lsb}
    print(f"[qat] int forward of the trained artifact, B={BATCH}: "
          f"{counts[INT_PE]} {INT_PE} launches, bit-exact with the plain "
          f"version; {rep.row()}", flush=True)

    raw = raw_i.to(torch.float32) / 2.0 ** 15
    post = {"score_thresh": 0.05, "max_out": 8}
    _zero(launch.KERNELS)
    got = detection.postprocess(raw, **post)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    if counts["detect_postprocess"] != 1 or any(
            n for name, n in counts.items() if name != "detect_postprocess"):
        raise AssertionError(f"QAT postprocess: launches {counts}")
    by_path["postprocess"] = counts
    dec = detection.decode_head(raw)
    want = detection.nms_plain(dec["boxes"], dec["scores"], **post)
    for g, w, field in zip(got, want, ("boxes", "scores", "classes")):
        _exact(torch, g, w, f"trained head postprocess {field}")
    kept = [int(n) for n in torch.sum(got[1] > 0, dim=1)]
    record["kept_boxes"] = kept
    print(f"[qat] postprocess of the trained int head: 1 detect_postprocess "
          f"launch, bit for bit with decode_head + nms_plain; kept {kept} "
          f"of max_out {post['max_out']}", flush=True)

    _zero(launch.KERNELS)
    with torch.no_grad():
        rows = alignment.run(device=dev, trained_params=params)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    # the kernel path's launches, derived from its configs (tuned, B = 1)
    # as phase 4 derives a dispatch's; the int path's conv1 checkpoint and
    # forward launch the integer PE 1 + 11 times
    configs = yolo.kernel_configs(yolo.deploy_yolo_kernel(params),
                                  yolo.INPUT_SIZE, 1)
    want = per_dispatch([c.to_dict() for c in configs])
    del want["detect_postprocess"]
    want[INT_PE] = n_layers + 1
    if {k: n for k, n in counts.items() if n} != want:
        raise AssertionError(f"Table 6 on trained params: launches {counts}, "
                             f"want {want}")
    by_path["table 6"] = counts
    print(f"[qat alignment] launches {want}", flush=True)
    record["alignment"] = rows
    for name, value, note in rows:
        print(f"[qat alignment] {name} {value!r} {note}", flush=True)
    record["launches"] = {name: sum(c[name] for c in by_path.values())
                          for name in launch.KERNELS}
    record["launches_by_step"] = by_path
    return record


# ---------------------------------------------------------------------------
# Phase 10: the LM stack's dense family (chatglm3-6b at full width, packed)
# ---------------------------------------------------------------------------

def lm_projections(cfg) -> dict:
    """(K, N) of each packed projection of one layer, in call order."""
    d, hd = cfg.d_model, cfg.hd
    qn, kvn = cfg.heads_eff * hd, cfg.num_kv_heads * hd
    out = {"wq": (d, qn), "wk": (d, kvn), "wv": (d, kvn), "wo": (qn, d),
           "up": (d, cfg.d_ff)}
    if cfg.gated_mlp:
        out["gate"] = (d, cfg.d_ff)
    out["down"] = (cfg.d_ff, d)
    return out


def lm_shapes(cfg) -> list:
    """(what, M, K, N) the LM path gives the matmuls: decode at M = slots
    and prefill at M = slots × prompt for each distinct (K, N), and one
    shape off the grid (ragged M and N, the widest K)."""
    kn = sorted(set(lm_projections(cfg).values()))
    rows = [("decode", LM_SLOTS, k, n) for k, n in kn]
    rows += [("prefill", LM_SLOTS * LM_PROMPT, k, n) for k, n in kn]
    k_max = max(k for k, _ in kn)
    rows.append(("off grid", 37, k_max, 2061))
    return rows


def check_lm_kernels(torch, np, dev, cfg) -> tuple:
    """Phase 10a: the popcount matmul, called as `layers.packed_linear`
    calls it (one uniform step broadcast to (K,)), and the int matmul,
    through `core.w1a8.w1a8_linear_infer_int`, each bit for bit against
    its plain version on the card at the LM path's shapes; rows of a
    prefix of M, of a2[1:] and of an unaligned copy at the shape off the
    grid. Times each like phases 2–3, beside ``torch.matmul`` in f32 on
    codes·step and the unpacked ±1 (the reference's arithmetic). Returns
    the records and the largest difference per kernel (0)."""
    from repro_torch.core import packing, w1a8
    from repro_torch.device import full_f32
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.models import layers

    MM, INT = "w1a8_matmul_popcount", "w1a8_matmul_int"
    rng = np.random.default_rng(SEED + 10)
    records = []
    for what, m, k, n in lm_shapes(cfg):
        a2 = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8)
                              ).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(
            np.float32)).to(dev)
        wp = packing.pack_signs(w, axis=0)
        step = torch.full((), 0.05, device=dev)
        mul = torch.broadcast_to(step, (k,))
        alpha = torch.mean(torch.abs(w), dim=0)
        bias = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev)

        def run():
            return mm_ops.w1a8_matmul(a2, wp, mul, alpha, bias, k=k,
                                      config=layers.POPCOUNT)
        codes, div = mm_ops.fold_operands(a2, mul, alpha)
        y = run()
        _exact(torch, codes, a2, f"LM {what} {(m, k, n)}: uniform-step fold")
        _exact(torch, y, mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div,
                                                         bias),
               f"LM {what} {(m, k, n)} popcount matmul")
        dep = {"w_packed": wp, "mul_prev": mul.contiguous(),
               "div_post": alpha, "bias": bias, "k": k}
        colsum = packing.unpack_signs(wp, k, dtype=torch.int32).sum(
            dim=0, dtype=torch.int32)
        acc = w1a8.int_sums(dep, a2)
        want = mm_ref.w1a8_matmul_int_ref(a2, wp, colsum)
        _exact(torch, acc, want, f"LM {what} {(m, k, n)} int sums")
        _exact(torch, w1a8.w1a8_linear_infer_int(dep, a2),
               want.to(torch.float32) * mul[0] * alpha + bias,
               f"LM {what} {(m, k, n)} w1a8_linear_infer_int")
        if what == "off grid":
            row_checks(torch, lambda x: mm_ops.w1a8_matmul(
                x, wp, mul, alpha, bias, k=k, config=layers.POPCOUNT),
                a2, y, f"LM {what} popcount")
            row_checks(torch, lambda x: mm_ops.w1a8_matmul_int(
                x, wp, colsum), a2, acc, f"LM {what} int")
        xq = a2.to(torch.float32) * step
        signs = packing.unpack_signs(wp, k, dtype=torch.float32)

        def library():
            with full_f32():
                return torch.matmul(xq, signs)
        nbytes = k * n // 8 + m * k + 4 * m * n
        ops = 2 * m * k * n
        for kernel, fn, alone, plain in (
                (MM, run, lambda: mm_ops.w1a8_matmul(
                    a2, wp, None, div, bias, k=k, config=layers.POPCOUNT),
                 lambda: mm_ref.w1a8_matmul_popcount_ref(
                     a2, wp, k, div, bias)),
                (INT, lambda: mm_ops.w1a8_matmul_int(a2, wp, colsum),
                 lambda: mm_ops.w1a8_matmul_int(a2, wp, colsum),
                 lambda: mm_ref.w1a8_matmul_int_ref(a2, wp, colsum))):
            rec = {"kernel": kernel, "what": what, "shape": [m, k, n],
                   "bytes": nbytes, "ops": ops,
                   "ms": cuda_ms(torch, fn),
                   # the wrapper's: the popcount matmul's holds its fold
                   # of the codes onto one grid (PyTorch kernels) beside
                   # the kernel; the int matmul's launches the kernel alone
                   "device_ms": graph_ms(torch, fn),
                   "kernel_device_ms": graph_ms(torch, alone),
                   "plain_ms": cuda_ms(torch, plain, reps=2, n=2),
                   "library_ms": cuda_ms(torch, library),
                   "library_device_ms": graph_ms(torch, library)}
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops,
                                                     INT8_OPS_PER_S)
            _exact(torch, alone(), fn(), f"LM {what} {kernel} alone")
            records.append(rec)
            alone_ms = f", of it the kernel {rec['kernel_device_ms']:.5f}"
            print(f"[lm kernels] {kernel} {what} (M, K, N) = {(m, k, n)}: "
                  f"bit-exact with its plain version; {rec['ms']:.4f} ms, "
                  f"device {rec['device_ms']:.5f}{alone_ms} ms (plain "
                  f"{rec['plain_ms']:.4f}, f32 torch.matmul "
                  f"{rec['library_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.5f}, bound "
                  f"{rec['bound_ms']:.6f} by {rec['bound_by']})",
                  flush=True)
    return records, {MM: 0.0, INT: 0.0}


# (what, M, K, N, requant): the popcount matmul's decode route at
# chatglm3-6b's decode shapes (M = LM_SLOTS), off the grid (ragged M, K %
# 32 != 0, ragged N) and across its M range at the widest (K, N)
DECODE_ROUTE_SHAPES = (
    ("decode", LM_SLOTS, 4096, 4096, False),
    ("decode", LM_SLOTS, 4096, 256, False),
    ("decode", LM_SLOTS, 4096, 13696, False),
    ("decode", LM_SLOTS, 13696, 4096, False),
    ("off grid", 5, 4100, 2061, False),
    ("M 1", 1, 4096, 13696, True), ("M 8", 8, 4096, 13696, False),
    ("M 16", 16, 4096, 13696, True))


def floor_graph_ms(torch, dev) -> float:
    """Device ms of a one-element ``torch.add`` from graph replays: the
    smallest launch, timed as the decode route's rows are."""
    one = torch.zeros(1, device=dev)
    return graph_ms(torch, lambda: torch.add(one, 1.0))


def turns_ms(torch, fn, old) -> tuple:
    """Device ms of ``fn`` from graph replays in turns with the context
    ``old`` (another route of the same call): old, new, new, old."""
    with old():
        before = [graph_ms(torch, fn)]
    new = [graph_ms(torch, fn), graph_ms(torch, fn)]
    with old():
        before.append(graph_ms(torch, fn))
    return new, before


def check_decode_route(torch, np, dev, smi: str) -> list:
    """Phase 10a': the popcount matmul's decode route, the kernel alone
    (codes on one grid, Div carrying the step), bit for bit against its
    plain version on the card at DECODE_ROUTE_SHAPES (the requant among
    them; the row checks off the grid), each launch counted on
    ``w1a8_matmul_popcount_decode``; device ms from graph replays in
    turns with the PR-15 tile at the same shape (`tile_sweep.pr15_route`:
    PR 15, decode, decode, PR 15), the plain version's and f32
    ``torch.matmul``'s (codes·step against the unpacked ±1) ms, the bound
    (sign words, codes, constants and output at 3.35 TB/s against 2·M·K·N
    int8 operations) and a one-element ``torch.add``'s device ms, the
    floor. These launches compare: they are on no path."""
    import dataclasses

    from repro_torch.core import packing
    from repro_torch.device import full_f32
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.w1a8_matmul import geometry
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.launch.tile_sweep import pr15_route

    rng = np.random.default_rng(SEED + 30)
    floor = floor_graph_ms(torch, dev)
    step = 0.05
    records = []
    for what, m, k, n, quant in DECODE_ROUTE_SHAPES:
        if not geometry.decodes(m, k):
            raise AssertionError(f"{(m, k, n)} does not take the decode "
                                 f"route")
        a2 = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8)
                              ).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(
            np.float32)).to(dev)
        wp = packing.pack_signs(w, axis=0)
        div = torch.mean(torch.abs(w), dim=0) * step
        bias = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev)
        cfg = KernelConfig(op="matmul", accum="popcount")
        if quant:
            y = mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div, bias)
            cfg = cfg.replace(out_step=float(y.abs().max()) / 255.0)

        def run(x=a2):
            return mm_ops.w1a8_matmul(x, wp, None, div, bias, k=k,
                                      config=cfg)

        def plain():
            return mm_ref.w1a8_matmul_popcount_ref(a2, wp, k, div, bias,
                                                   cfg.out_step)
        before = mm_ops.DECODE_KERNEL.launches
        got = run()
        if mm_ops.DECODE_KERNEL.launches != before + 1:
            raise AssertionError(f"{(m, k, n)}: no decode launch")
        _exact(torch, got, plain(), f"decode route {what} {(m, k, n)}")
        if what == "off grid":
            row_checks(torch, run, a2, got, f"decode route {what}")
        with pr15_route():
            _exact(torch, run(), got, f"PR-15 tile {what} {(m, k, n)}")
        new, old = turns_ms(torch, run, pr15_route)
        xq = a2.to(torch.float32) * step
        signs = packing.unpack_signs(wp, k, dtype=torch.float32)

        def library():
            with full_f32():
                return torch.matmul(xq, signs)
        nbytes = 4 * packing.packed_dim(k) * n + m * k + 8 * n \
            + m * n * (1 if quant else 4)
        ops = 2 * m * k * n
        rec = {"kernel": DECODE, "what": what, "shape": [m, k, n],
               "quant": quant,
               "launch": dataclasses.asdict(geometry.decode_launch(m, k, n)),
               "bytes": nbytes, "ops": ops, "ms": cuda_ms(torch, run),
               "device_ms": sum(new) / 2, "decode_device_ms": new,
               "pr15_device_ms": old,
               "plain_ms": cuda_ms(torch, plain, reps=2, n=2),
               "library_ms": cuda_ms(torch, library),
               "library_device_ms": graph_ms(torch, library),
               "floor_device_ms": floor}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops,
                                                 INT8_OPS_PER_S)
        del xq, signs
        records.append(rec)
        print(f"[decode route] {what} (M, K, N) = {(m, k, n)}"
              f"{', requant' if quant else ''}: bit-exact with its plain "
              f"version, split {rec['launch']['cw']}x{rec['launch']['kw']}"
              f"x{rec['launch']['cs']}; device ms "
              f"{' '.join(f'{x:.5f}' for x in new)} against the PR-15 tile "
              f"{' '.join(f'{x:.5f}' for x in old)} (turns), {rec['ms']:.4f}"
              f" ms CUDA events; plain {rec['plain_ms']:.3f}, f32 "
              f"torch.matmul device {rec['library_device_ms']:.5f}, bound "
              f"{rec['bound_ms']:.6f} by {rec['bound_by']}, floor "
              f"{floor:.5f} ({smi})", flush=True)
    torch.cuda.empty_cache()
    return records


def lm_prefill_parity(torch, params, packed, cfg, prompts,
                      tol: float = LM_TOL) -> dict:
    """Phase 10c (and 12c): prefill logits of the packed path against the
    unpacked ``w1a8_eval`` path on the same card, the packed run's codes
    that round across a tie forced to the unpacked run's (`train.ties`,
    each within 1e-3 of a tie on both sides): within tol·max|logit|, and
    greedy tokens equal wherever the unpacked run's top-2 gap exceeds
    that. The unforced difference is printed beside it."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import prefill
    from repro_torch.train import ties

    with torch.no_grad():
        with ties.record("quantize_act", module=layers) as recorded:
            want, _ = prefill(cfg, params, prompts, max_len=LM_MAX_LEN,
                              mode="w1a8_eval")
        with ties.forced(recorded, "quantize_act", module=layers) as counts:
            got, _ = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                             mode="w1a8_eval")
        free, _ = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                          mode="w1a8_eval")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    free_err = float((free - want).abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"packed prefill logits {err} off the unpacked "
                             f"path's, > {tol} * {scale}")
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol * scale
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    if not bool(same[decided].all()):
        raise AssertionError("packed prefill: a greedy token differs where "
                             "the top-2 gap exceeds the tolerance")
    return {"max_abs_err": err, "max_abs_logit": scale, "tol": tol,
            "rel_err": err / scale, "unforced_max_abs_err": free_err,
            "codes_forced": sum(counts), "quantizer_calls": len(counts),
            "decided_rows": int(decided.sum()), "rows": int(len(decided))}


def step_profile(torch, fn, popcount_per_call: int, n: int = 2,
                 tries: int = 3, top: int = 12) -> dict:
    """torch.profiler over ``n`` calls of ``fn`` (a decode step) after a
    warm one: device busy ms per call (the union of the traced device
    intervals), profiled wall ms and idle share, device records per call
    and device ms per call by kernel name (the ``top`` largest). A trace
    must hold ``popcount_per_call`` popcount matmul records a call, or it
    has lost device records and is taken again, up to ``tries`` times, and
    then `events_profile` times the calls (idle share, device records and
    the kernels' ms not measured)."""
    from repro_torch.launch.profile import union_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum("matmul_popcount" in e.name for e in events) == \
                popcount_per_call * n:
            break
    else:
        rec = events_profile(torch, fn, n, tries)
        return {"device_busy_ms": rec["device_busy_ms"],
                "wall_ms": rec["wall_ms"], "idle_share": None,
                "device_records": None, "device_ms_by_kernel": {},
                "device_ms_rest": None, "device_timing": "cuda events"}
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / n
    order = sorted(by_name.items(), key=lambda kv: -kv[1])
    busy = union_us((e.time_range.start, e.time_range.end)
                    for e in events) / 1e3 / n
    return {"device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "device_records": len(events) / n,
            "device_ms_by_kernel": dict(order[:top]),
            "device_ms_rest": sum(v for _, v in order[top:]),
            "device_timing": "torch.profiler"}


def graph_ms(torch, fn, n: int = 20, reps: int = 5) -> float:
    """Device ms per call of ``fn``: CUDA events around replays of one
    CUDA graph that holds ``n`` calls, so no host work sits between the
    launches (median of ``reps`` replays). Phase 10 times its calls so,
    not with torch.profiler: on the card, after phase 9, five traces in a
    row of one short call came back short of device records."""
    from repro_torch.kernels import _build
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.capturing(), torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(torch, graph.replay, reps=reps, n=1) / n


def drive_lm(torch, np, dev, smi: str) -> dict:
    """Phase 10: the LM stack's dense family on the card. The popcount and
    int matmuls at the LM path's shapes (`check_lm_kernels`); chatglm3-6b
    at full width from a seeded init, deployed (`deploy_lm`) and served
    through the launcher's `run_lm` (packed, 8 requests, 16 new tokens,
    slots 4, max_len 128) with every launch count zeroed just before and
    read just after: done-mask tokens equal to host-checked ones (run_lm
    raises otherwise), and per decode step exactly one popcount matmul
    launch a packed projection (7 × 28 = 196, derived from the config) and
    no other kernel; the packed prefill against the unpacked one
    (`lm_prefill_parity`); one `w1a8_linear_infer_int` call, counted the
    same way; the decode step's CUDA-event ms, device busy ms and idle
    share (torch.profiler), and peak memory. Returns (the f32 params,
    which phase 11 serves, and the record)."""
    import argparse

    from repro_torch import configs
    from repro_torch.core import packing, w1a8
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import init_lm_params, tree_items
    from repro_torch.serve import deploy_lm, prefill
    from repro_torch.serve.engine import decode_step

    cfg = configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    kernel_rows, kernel_errs = check_lm_kernels(torch, np, dev, cfg)
    print(f"[lm kernels] {len(kernel_rows)} timed calls in "
          f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    t0 = time.perf_counter()
    decode_rows = check_decode_route(torch, np, dev, smi)
    print(f"[decode route] {len(decode_rows)} shapes in "
          f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    per_step = len(lm_projections(cfg)) * cfg.num_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = init_lm_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        args = argparse.Namespace(
            workload="lm", arch=LM_ARCH, reduced=False, packed=True,
            requests=LM_REQUESTS, max_new=LM_MAX_NEW, slots=LM_SLOTS,
            max_len=LM_MAX_LEN, temperature=0.0, stop_token=[], seed=SEED,
            device=str(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        _zero(launch.KERNELS)
        record = launch.run_lm(args, params=params)
        torch.cuda.synchronize()
        counts = launch.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    want = lm_launches_per_step(cfg)
    if want["w1a8_matmul_popcount"] != per_step or \
            record["kernel_launches_per_decode_step"] != want:
        raise AssertionError(f"LM decode step: launches "
                             f"{record['kernel_launches_per_decode_step']}, "
                             f"want {want}")
    if set(n for name, n in counts.items() if name not in want) - {0}:
        raise AssertionError(f"LM serve launched other kernels: {counts}")
    print(f"[lm serve] {LM_ARCH} full width, packed, {LM_REQUESTS} requests "
          f"x {LM_MAX_NEW} tokens, slots {LM_SLOTS}: done-mask tokens equal "
          f"host-checked; {per_step} w1a8_matmul_popcount launches a decode "
          f"step, {want.get(DECODE, 0):.0f} of them its decode route "
          f"({record['decode_steps']} steps), "
          f"{counts['w1a8_matmul_popcount']} in the run; "
          f"{record['tok_per_s']:.2f} tok/s, tick p50 "
          f"{record['tick_p50_ms']:.3f} ms, p95 {record['tick_p95_ms']:.3f} "
          f"ms, peak memory {peak / 2 ** 30:.2f} GiB; init "
          f"{init_s:.1f} s ({smi})", flush=True)
    with torch.no_grad():
        packed = deploy_lm(params)
        sign_bytes = sum(int(x.numel()) * 4 for name, x in tree_items(packed)
                         if "w_packed" in name)
        emb_bytes = packed["embed"]["emb"].numel() * 4
        prompts = torch.tensor(
            [[2 + i, 11, 7 + i % 3] for i in range(LM_SLOTS)],
            dtype=torch.int32, device=dev)
        parity = lm_prefill_parity(torch, params, packed, cfg, prompts)
        print(f"[lm parity] packed prefill logits vs unpacked w1a8_eval on "
              f"the card: max_abs {parity['max_abs_err']:.6g} of max|logit| "
              f"{parity['max_abs_logit']:.6g} (rel {parity['rel_err']:.3g}, "
              f"tol {LM_TOL}; {parity['codes_forced']} tie codes forced "
              f"over {parity['quantizer_calls']} quantizer calls; unforced "
              f"max_abs {parity['unforced_max_abs_err']:.6g}); greedy "
              f"tokens equal on {parity['decided_rows']} of "
              f"{parity['rows']} rows decided beyond the tolerance",
              flush=True)
        # one w1a8_linear_infer_int call at the wo projection, counted
        k, n = lm_projections(cfg)["wo"]
        o = packed["slots"][0]["attn"]["wo"]
        dep = {"w_packed": o["w_packed"][0], "mul_prev": o["act_step"][0],
               "div_post": o["alpha"][0],
               "bias": torch.zeros(n, device=dev), "k": k}
        a = torch.randint(0, 256, (LM_SLOTS, k), generator=gen,
                          device=dev).to(torch.uint8)
        _zero(launch.KERNELS)
        y = w1a8.w1a8_linear_infer_int(dep, a)
        torch.cuda.synchronize()
        int_counts = launch.launch_counts()
        if {k_: c for k_, c in int_counts.items() if c} != \
                {"w1a8_matmul_int": 1}:
            raise AssertionError(f"w1a8_linear_infer_int: {int_counts}")
        signs = packing.unpack_signs(dep["w_packed"].cpu(), k,
                                     dtype=torch.int64)
        _exact(torch, w1a8.int_sums(dep, a).cpu(),
               (a.cpu().to(torch.int64) @ signs).to(torch.int32),
               "w1a8_linear_infer_int sums vs int64 on the CPU")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("w1a8_linear_infer_int: non-finite output")
        # the decode step alone, on the served shape
        logits, cache = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                                mode="w1a8_eval")
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def step():
            return decode_step(cfg, packed, cache, tok, mode="w1a8_eval")
        step_ms = cuda_ms(torch, step, reps=3, n=5)
        prof = step_profile(torch, step, per_step)
    tick = tick_timing(torch, cfg, packed, dev, smi)
    step_bound = (sign_bytes + emb_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"[lm decode step] {LM_ARCH} at M = {LM_SLOTS}: {step_ms:.3f} ms "
          f"(CUDA events), device busy {prof['device_busy_ms']:.4f} ms, "
          f"profiled wall {prof['wall_ms']:.3f} ms, idle share "
          f"{_num(prof['idle_share'], '.4f')}, "
          f"{_num(prof['device_records'], '.0f')} device records a step "
          f"({prof['device_timing']}); bound {step_bound:.4f} ms ({sign_bytes / 1e9:.3f}"
          f" GB of sign words + {emb_bytes / 1e9:.3f} GB of f32 "
          f"unembedding at 3.35 TB/s) ({smi})", flush=True)
    for name, ms in prof["device_ms_by_kernel"].items():
        print(f"[lm decode step] device ms a step {ms:.4f}: {name[:90]}",
              flush=True)
    print(f"[lm decode step] device ms a step "
          f"{_num(prof['device_ms_rest'], '.4f')}: the rest", flush=True)
    return params, {"card": smi, "arch": LM_ARCH, "kernels": kernel_rows,
            "kernel_errs": kernel_errs, "decode_route": decode_rows,
            "serve": record,
            "launches": counts, "int_call_launches": int_counts,
            "per_decode_step": per_step, "peak_memory_bytes": peak,
            "init_s": init_s, "parity": parity, "step_ms": step_ms,
            "step_profile": prof, "step_bound_ms": step_bound,
            "sign_bytes": sign_bytes, "emb_bytes": emb_bytes, "tick": tick}


def check_dispatch_launches(launches: dict, dispatches: int, configs,
                            what: str) -> None:
    """``launches`` by kernel equal ``dispatches`` times `per_dispatch` of
    ``configs`` (each replay adds the launches its capture recorded)."""
    per = per_dispatch(configs)
    for name in set(launches) | set(per):
        if launches.get(name, 0) != dispatches * per.get(name, 0):
            raise AssertionError(f"{what}: {name}: {launches.get(name, 0)} "
                                 f"launches for {dispatches} dispatches, "
                                 f"want {per.get(name, 0)} each")


def drive_tiers(torch, dev, smi: str, lm_params) -> dict:
    """Phase 11: the launcher's fleet, the traffic harness's real and model
    modes, and compose on phase 10's f32 params, each with every launch
    count zeroed just before and read just after."""
    import argparse

    from repro_torch.launch import serve as launch
    from repro_torch.launch import traffic

    serve_out = ROOT / "build" / "tiers_serve.json"
    fleet_out = ROOT / "build" / "tiers_fleet.json"
    for path in (serve_out, fleet_out):
        path.parent.mkdir(exist_ok=True)
        path.unlink(missing_ok=True)
    counts = {}
    # (a) the launcher's detect with a 2-replica autoscaled fleet
    _zero(launch.KERNELS)
    record = launch.main(["--workload", "detect", "--requests", "512",
                          "--slots", str(BATCH), "--depth", "2",
                          "--profile", "tuned", "--replicas", "2",
                          "--autoscale", "--out", str(serve_out)])
    counts["launcher fleet"] = launch.launch_counts()
    fleet = record["fleet"]
    check_dispatch_launches(fleet["launches"], fleet["dispatches"],
                            record["configs"]["320"], "launcher fleet")
    if fleet["requests_lost"] or sum(fleet["drops_by_cause"].values()):
        raise AssertionError(f"launcher fleet: {fleet['drops_by_cause']}")
    print(f"[fleet] launcher detect, 512 requests, 2 replicas autoscaled "
          f"(replicas {fleet['replicas_min']}→{fleet['replicas_max']}, "
          f"{len(fleet['scale_events'])} scale events): payloads bit-exact "
          f"with the single scheduler, 0 lost, 0 dropped; "
          f"{fleet['dispatches']} dispatches, launches "
          f"{ {k: v for k, v in fleet['launches'].items() if v} }; single "
          f"scheduler {record['img_per_s']:.2f} img/s, tick p50 "
          f"{record['tick_p50_ms']:.4f} ms ({smi})", flush=True)
    # (b) real replicas: 1 against 2, bit for bit
    _zero(launch.KERNELS)
    real = traffic.main(["--mode", "real", "--requests", "256",
                         "--replicas", "2", "--out", str(fleet_out)])
    counts["traffic real"] = launch.launch_counts()
    check_dispatch_launches(
        real["launches"], real["dispatches_single"]
        + real["dispatches_fleet"], real["configs"], "traffic real")
    print(f"[traffic real] 256 requests at 320, slots {real['slots']}: "
          f"1 replica {real['img_per_s_single']:.2f} img/s, 2 replicas "
          f"{real['img_per_s_fleet']:.2f} img/s; completed sets equal, "
          f"payloads bit-exact ({smi})", flush=True)
    # (c) the model replay calibrated from (a)'s record
    model = traffic.run_model(argparse.Namespace(
        serve_bench=str(serve_out), slo_ms=5000.0, requests=2000,
        seed=SEED, max_seconds=0.0))
    cells = {f"{kind}/{name}": cell for kind in traffic.TRACES
             for name, cell in model[kind].items()}
    if len(cells) != 12 or any(c["requests_lost"] for c in cells.values()):
        raise AssertionError(f"model replay: {len(cells)} cells, lost "
                             f"{[c['requests_lost'] for c in cells.values()]}")
    cal = model["config"]
    print(f"[traffic model] 12 cells, {model['total_requests']} requests, "
          f"0 lost; calibration width {cal['width']}, depth {cal['depth']}, "
          f"tick {cal['tick_ms']:.4f} ms: slo {cal['slo_ms']} ms = "
          f"{cal['slo_ticks']} ticks; attainment "
          f"{ {k: round(c['slo_attainment'], 4) for k, c in cells.items()} }",
          flush=True)
    # (d) compose on phase 10's params, at full width
    args = argparse.Namespace(
        device=str(dev), requests=8, buckets="320", seed=SEED,
        slots=LM_SLOTS, depth=2, profile="tuned", arch=LM_ARCH,
        reduced=False, max_new=LM_MAX_NEW, max_len=LM_MAX_LEN,
        temperature=0.0, stop_token=[])
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(launch.KERNELS)
    with torch.no_grad():
        compose = launch.run_compose(args, params=lm_params)
    torch.cuda.synchronize()
    counts["compose"] = launch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if compose["handoffs"] != 8 or compose["lost"] or compose["duplicated"]:
        raise AssertionError(f"compose: {compose['handoffs']} hand-offs, "
                             f"{compose['lost']} lost, "
                             f"{compose['duplicated']} duplicated")
    check_dispatch_launches(compose["launches"],
                            compose["detect_dispatches"],
                            compose["configs"]["320"], "compose")
    print(f"[compose] {LM_ARCH} full width, float, 8 requests x "
          f"{LM_MAX_NEW} greedy tokens, slots {LM_SLOTS}: 0 lost, 0 "
          f"duplicated, 8 hand-offs, prompts the template; "
          f"{compose['ticks']} ticks, {compose['wall_s']:.2f} s, "
          f"{compose['detect_dispatches']} detect dispatches, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    return {"launches": counts, "launcher": record, "real": real,
            "model": model, "compose": compose, "compose_peak_bytes": peak,
            "summary": {
                "launcher_fleet": {k: fleet[k] for k in (
                    "dispatches", "replicas_min", "replicas_max",
                    "requests_completed", "requests_lost")},
                "img_per_s_single": real["img_per_s_single"],
                "img_per_s_fleet": real["img_per_s_fleet"],
                "calibration": {k: cal[k] for k in (
                    "width", "depth", "tick_ms", "slo_ticks")},
                "compose": {k: compose[k] for k in (
                    "ticks", "wall_s", "handoffs", "lost", "duplicated")},
                "compose_peak_bytes": peak}}


# ---------------------------------------------------------------------------
# Phase 12: the LM stack's MoE, SSM and hybrid families, packed
# ---------------------------------------------------------------------------

GROUPED = "w1a8_matmul_popcount_grouped"
DECODE = "w1a8_matmul_popcount_decode"
MOE_ARCH, SSM_ARCH = "mixtral-8x7b", "mamba2-1.3b"
HYBRID_ARCH, HYBRID_LAYERS = "jamba-1.5-large-398b", 8   # one period
# (arch, experts, K, N) of the expert projections the grouped entry is
# held at, each at a decode cap (the launcher's slots) and a prefill cap
GROUPED_SHAPES = (("mixtral-8x7b", 8, 4096, 14336),
                  ("mixtral-8x7b", 8, 14336, 4096),
                  ("kimi-k2-1t-a32b", 384, 7168, 2048),
                  ("kimi-k2-1t-a32b", 384, 2048, 7168),
                  ("jamba-1.5-large-398b", 16, 8192, 24576),
                  ("jamba-1.5-large-398b", 16, 24576, 8192))
# (what, cap, routed tokens): cap 8 takes the slots' 4 tokens whole; at
# cap 64, 256 tokens fill mixtral's experts past the cap and leave kimi's
# some 5 rows an expert
GROUPED_CAPS = (("decode", 8, LM_SLOTS), ("prefill", 64, 256))
MOE_PARITY_LAYERS = 2
# jamba's one period unpacked in f32 holds 4 MoE layers of 16 experts,
# 155 GB: its packed-against-unpacked prefill cuts the experts to 2 (top 2
# of 2), some 45 GB; every projection keeps its shape, and the grouped
# entry at 16 experts is held bit for bit in 12(a)
HYBRID_PARITY_EXPERTS = 2
# packed against unpacked prefill at full width, tie codes forced:
# tests/test_torch_lm.py's contract (K ≤ 128 there, up to 24576 here: some
# 10x more roundings a sum, still ~1e-6 relative), for mixtral over 2
# layers, mamba2-1.3b over its 48 and jamba over its period
PARITY_TOL = 1e-4
# decode against the teacher-forced forward, both packed on the card, the
# codes that round across a tie forced (`ties.forced_by_rows`): sums in another
# order (the scan against the recurrent step, the ring cache against the
# full attention, cuBLAS at another M) some 1e-6 relative each, over up to
# 48 layers
TF_TOL, TF_STEPS = 1e-3, 5


def grouped_counts(np, rng, e: int, top_k: int, cap: int, tokens: int):
    """Rows each expert holds when ``tokens`` tokens each pick ``top_k``
    distinct experts at random, expert 0 never (an empty expert in every
    case), each clamped to ``cap``."""
    counts = np.zeros(e, np.int64)
    for _ in range(tokens):
        counts[1 + rng.permutation(e - 1)[:top_k]] += 1
    return np.minimum(counts, cap).astype(np.int32)


# counts of phase 12a's extra cases at mixtral-8x7b's expert shape, cap 8:
# every expert empty, one expert holding cap rows, counts past cap and
# below 0 (clamped to [0, cap] on the device)
GROUPED_COUNT_CASES = {"all empty": [0] * 8,
                       "one full": [0, 0, 0, 8, 0, 0, 0, 0],
                       "past cap and negative": [9, -1, 100, 3, -7, 8, 0, 2]}


def grouped_items(np, counts_np, e: int, cap: int, k: int, n: int) -> int:
    """The work items a grouped launch forms on the device: (held expert,
    row block, column tile), as `geometry.grouped_launch` tiles them."""
    from repro_torch.kernels.w1a8_matmul import geometry
    g = geometry.grouped_launch(e, cap, k, n)
    held = np.clip(counts_np, 0, cap)
    if g.decode:
        return int((held > 0).sum()) * -(-n // g.bn)
    return int((-(-held // g.bm)).sum()) * -(-n // g.bn)


def check_grouped(torch, np, dev, smi: str) -> list:
    """Phase 12a: the grouped popcount entry, called as a packed MoE layer
    calls it (div = α·step, bias 0), bit for bit against its plain version
    on the card at mixtral's, kimi-k2's and jamba's expert shapes, at a
    decode and a prefill cap, an empty expert in each, and at mixtral's
    cap 8 on GROUPED_COUNT_CASES (up projection). The launch's work items
    are the held experts' (none for an empty one: at kimi-k2's cap 8 most
    of the 384 hold no row); rows from each count on are zeros. Times it (CUDA
    events, and device ms from graph replays, at the decode caps in turns
    with the PR-15 tile over the same items, `tile_sweep.pr15_route`;
    above them both routes are that tile) beside its plain version
    and f32 ``torch.bmm`` on codes·step and the unpacked ±1 of every
    expert (the reference's arithmetic); the bound counts the sign words
    of the experts that hold rows, their codes, every output row and the
    constants, at 3.35 TB/s, against their int8 operations; the floor is
    a one-element ``torch.add``'s device ms."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import packing
    from repro_torch.device import full_f32
    from repro_torch.kernels.w1a8_matmul import geometry
    from repro_torch.kernels.w1a8_matmul import ops as mm_ops
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.launch.tile_sweep import pr15_route

    rng = np.random.default_rng(SEED + 12)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    step = 0.05
    floor = floor_graph_ms(torch, dev)
    records = []
    for arch, e, k, n in GROUPED_SHAPES:
        top_k = configs.get_config(arch).top_k
        words = packing.packed_dim(k)
        w = torch.randint(-2 ** 31, 2 ** 31 - 1, (e, words, n),
                          dtype=torch.int32, device=dev, generator=gen)
        div = torch.rand((e, n), device=dev, generator=gen) * step
        bias = torch.zeros_like(div)
        cases = [(what, cap, grouped_counts(np, rng, e, top_k, cap, tokens))
                 for what, cap, tokens in GROUPED_CAPS]
        if (arch, e, k, n) == GROUPED_SHAPES[0]:
            cases += [(f"decode, {name}", 8, np.array(c, np.int32))
                      for name, c in GROUPED_COUNT_CASES.items()]
        for what, cap, counts_np in cases:
            counts = torch.from_numpy(counts_np).to(dev)
            a = torch.from_numpy(rng.integers(0, 256, (e, cap, k),
                                              dtype=np.uint8)).to(dev)

            def run():
                return mm_ops.w1a8_matmul_grouped(a, w, counts, div, bias,
                                                  k=k)

            def plain():
                return mm_ref.w1a8_matmul_grouped_ref(a, w, counts, k, div,
                                                      bias)
            plain()                                  # warm
            # the plain version is timed on the one call the check makes
            # (seconds at kimi-k2's prefill cap)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain()
            end.record()
            end.synchronize()
            got = run()
            _exact(torch, got, want,
                   f"grouped {arch} {what} {(e, cap, k, n)}")
            del want
            decode = geometry.grouped_launch(e, cap, k, n).decode
            if decode:
                with pr15_route():
                    _exact(torch, run(), got,
                           f"grouped {arch} {what} PR-15 tile")
                new, old = turns_ms(torch, run, pr15_route)
            else:
                new, old = [graph_ms(torch, run)] * 2, None
            del got
            held_np = np.clip(counts_np, 0, cap)
            active = int((held_np > 0).sum())
            held = int(held_np.sum())
            nbytes = active * (words * n * 4 + 8 * n) + held * k \
                + e * cap * n * 4 + e * 4
            ops = 2 * held * k * n
            rec = {"kernel": GROUPED, "arch": arch, "what": what,
                   "shape": [e, cap, k, n], "experts_holding_rows": active,
                   "rows_held": held,
                   "launch": dataclasses.asdict(
                       geometry.grouped_launch(e, cap, k, n)),
                   "items": grouped_items(np, counts_np, e, cap, k, n),
                   "bytes": nbytes, "ops": ops,
                   "ms": cuda_ms(torch, run),
                   "device_ms": sum(new) / 2, "decode_device_ms": new,
                   "pr15_device_ms": old,
                   "plain_ms": start.elapsed_time(end),
                   "floor_device_ms": floor}
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops,
                                                     INT8_OPS_PER_S)
            signs = torch.empty((e, k, n), dtype=torch.float32, device=dev)
            for i in range(e):
                signs[i] = packing.unpack_signs(w[i], k, dtype=torch.float32)
            xq = a.to(torch.float32) * step

            def library():
                with full_f32():
                    return torch.bmm(xq, signs)
            rec["library_ms"] = cuda_ms(torch, library, reps=3, n=5)
            rec["library_device_ms"] = graph_ms(torch, library, n=5, reps=3)
            del signs, xq, a
            records.append(rec)
            tile = "decode tile" if rec["launch"]["decode"] else "PR-15 tile"
            print(f"[grouped] {arch} {what} (E, cap, K, N) = "
                  f"{(e, cap, k, n)}, {active} experts hold {held} rows, "
                  f"{e - active} launch no work ({rec['items']} items of "
                  f"the {tile} over {rec['launch']['blocks']} persistent "
                  f"blocks): bit-exact with its plain version; device ms "
                  f"{' '.join(f'{x:.5f}' for x in new)}"
                  + (f" against the PR-15 tile "
                     f"{' '.join(f'{x:.5f}' for x in old)} (turns)"
                     if old else "") + ", "
                  f"{rec['ms']:.4f} ms CUDA events (plain "
                  f"{rec['plain_ms']:.2f}, f32 torch.bmm "
                  f"{rec['library_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.5f}, bound "
                  f"{rec['bound_ms']:.5f} by {rec['bound_by']}, floor "
                  f"{floor:.5f}) ({smi})", flush=True)
        del w, div, bias
    torch.cuda.empty_cache()
    return records


def dense_ks(cfg) -> list:
    """K of each 2-D popcount launch one packed decode step makes, from
    the config: an attention mixer's q, k, v (d_model) and o (heads·hd)
    projections, a Mamba mixer's in (d_model) and out (d_inner), a dense
    MLP's up and gate (d_model) and down (d_ff)."""
    from repro_torch.models.mamba import d_inner
    d, ks = cfg.d_model, []
    for i in range(cfg.num_layers):
        mk, fk = cfg.mixer_kind(i % cfg.period), cfg.ffn_kind(i % cfg.period)
        if mk.startswith("attn"):
            ks += [d, d, d, cfg.heads_eff * cfg.hd]
        else:
            ks += [d, d_inner(cfg)]
        if fk == "dense":
            ks += [d] * (2 if cfg.gated_mlp else 1) + [cfg.d_ff]
    return ks


def with_decode_share(want: dict, ks, m: int = LM_SLOTS) -> dict:
    """``want`` with the decode route's share of its 2-D popcount
    launches (those at M = m over the K's ``ks`` that
    `geometry.decodes`), where there is one."""
    from repro_torch.kernels.w1a8_matmul import geometry
    share = sum(geometry.decodes(m, k) for k in ks)
    return {**want, DECODE: float(share)} if share else dict(want)


def lm_launches_per_step(cfg) -> dict:
    """Launches of each popcount entry one packed decode step makes, from
    the config: one 2-D launch a dense projection (4 an attention mixer,
    2 a Mamba mixer's in and out projections, 2 or 3 a dense MLP), of
    which the decode route's share (`with_decode_share`), one grouped
    launch an expert projection (3 an MoE FFN)."""
    grouped = 3 * sum(cfg.ffn_kind(i % cfg.period) == "moe"
                      for i in range(cfg.num_layers))
    ks = dense_ks(cfg)
    out = with_decode_share({"w1a8_matmul_popcount": float(len(ks))}, ks)
    if grouped:
        out[GROUPED] = float(grouped)
    return out


def expert_bytes_read(torch, fn, packed) -> int:
    """Sign-word bytes of the experts that hold rows in one call of
    ``fn`` (the rest read none), from the counts each grouped launch
    gets."""
    from repro_torch.models import moe
    real, held = moe.w1a8_matmul_grouped, []

    def counting(a, w, counts, div, bias, *, k):
        held.append(int((counts > 0).sum()) * w[0].numel() * 4)
        return real(a, w, counts, div, bias, k=k)
    moe.w1a8_matmul_grouped = counting
    try:
        fn()
    finally:
        moe.w1a8_matmul_grouped = real
    return sum(held)


def decode_vs_forward(torch, cfg, params, prompts) -> dict:
    """Phase 12f: prefill and TF_STEPS greedy decode steps against one
    teacher-forced `lm_forward` over the prompt and the emitted tokens,
    both packed on the card. The decode is run again on the same tokens
    with its codes that round across a tie forced to the forward's
    (`ties.forced_by_rows`): on random weights one flipped code moves the
    logits by percents (an attention softmax over random packed
    projections is near one-hot, an MoE router near a tie picks another
    expert), so only the forced run is held: each step's logits within
    TF_TOL·max|logit| of the forward's at its position, and its argmax
    the forward's wherever the top-2 gap exceeds that. The unforced
    difference is printed beside it."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serve import prefill
    from repro_torch.serve.engine import decode_step
    from repro_torch.train import ties

    s = prompts.shape[1]

    def decode(toks=None):
        logits, cache = prefill(cfg, params, prompts, max_len=LM_MAX_LEN,
                                mode="w1a8_eval")
        steps, fed = [logits], []
        for i in range(TF_STEPS):
            fed.append(torch.argmax(steps[-1], -1).to(torch.int32)
                       if toks is None else toks[i])
            logits, cache = decode_step(cfg, params, cache, fed[-1][:, None],
                                        mode="w1a8_eval")
            steps.append(logits)
        return torch.stack(steps, 1), fed

    with torch.no_grad():
        free, toks = decode()
        seq = torch.cat([prompts, torch.stack(toks, 1)], dim=1)
        with ties.record("quantize_act", module=layers) as recorded:
            full = lm_forward(cfg, params, seq, mode="w1a8_eval")[:, s - 1:]
        with ties.forced_by_rows(recorded, "quantize_act",
                                 module=layers) as counts:
            got, _ = decode(toks)
    scale = float(full.abs().max())
    err = float((got - full).abs().max())
    if not err <= TF_TOL * scale:
        raise AssertionError(f"{cfg.name}: decode logits {err} off the "
                             f"teacher-forced forward's, > {TF_TOL} * "
                             f"{scale}")
    top2 = torch.topk(full, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > TF_TOL * scale
    same = torch.argmax(got, -1) == torch.argmax(full, -1)
    if not bool(same[decided].all()):
        raise AssertionError(f"{cfg.name}: a greedy token differs from the "
                             f"teacher-forced forward's where decided")
    return {"max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "tol": TF_TOL, "steps": TF_STEPS,
            "unforced_max_abs_err": float((free - full).abs().max()),
            "codes_forced": sum(counts), "quantizer_calls": len(counts),
            "decided_tokens": int(decided.sum()),
            "tokens": int(decided.numel())}


def serve_family(torch, dev, smi: str, arch: str, packed) -> tuple:
    """Phase 12b / 12d: the launcher's ``run_lm`` on packed params at full
    width (8 requests, 16 tokens, slots 4), every launch count zeroed just
    before and read just after: done-mask tokens equal to host-checked
    ones (run_lm raises otherwise), each popcount entry's launches a
    decode step equal to `lm_launches_per_step`'s, no other kernel.
    Returns (record, launches, peak bytes)."""
    import argparse

    from repro_torch import configs
    from repro_torch.launch import serve as launch

    cfg = configs.get_config(arch)
    args = argparse.Namespace(
        workload="lm", arch=arch, reduced=False, packed=True,
        requests=LM_REQUESTS, max_new=LM_MAX_NEW, slots=LM_SLOTS,
        max_len=LM_MAX_LEN, temperature=0.0, stop_token=[], seed=SEED,
        device=str(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(launch.KERNELS)
    with torch.no_grad():
        record = launch.run_lm(args, params=packed)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = lm_launches_per_step(cfg)
    if record["kernel_launches_per_decode_step"] != want:
        raise AssertionError(f"{arch} decode step: launches "
                             f"{record['kernel_launches_per_decode_step']}, "
                             f"want {want}")
    if set(n for name, n in counts.items() if name not in want) - {0}:
        raise AssertionError(f"{arch} serve launched other kernels: "
                             f"{counts}")
    print(f"[families serve] {arch} full width, packed, {LM_REQUESTS} "
          f"requests x {LM_MAX_NEW} tokens, slots {LM_SLOTS}: done-mask "
          f"tokens equal host-checked; launches a decode step {want} "
          f"({record['decode_steps']} steps), in the run "
          f"{ {k: v for k, v in counts.items() if v} }; "
          f"{record['tok_per_s']:.2f} tok/s, tick p50 "
          f"{record['tick_p50_ms']:.3f} ms, p95 {record['tick_p95_ms']:.3f} "
          f"ms, peak memory {peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    return record, counts, peak


def time_decode_step(torch, cfg, packed, prompts, smi: str) -> dict:
    """One packed decode step at M = slots after a prefill of
    ``prompts``: CUDA-event ms, the torch.profiler step profile, and the
    bound from the sign words it reads (the dense ones, and the experts'
    that hold rows in this step) and the f32 unembedding."""
    from repro_torch.models.transformer import tree_items
    from repro_torch.serve import prefill
    from repro_torch.serve.engine import decode_step

    per = lm_launches_per_step(cfg)
    with torch.no_grad():
        logits, cache = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                                mode="w1a8_eval")
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def step():
            return decode_step(cfg, packed, cache, tok, mode="w1a8_eval")
        step_ms = cuda_ms(torch, step, reps=3, n=5)
        prof = step_profile(torch, step, int(sum(
            v for name, v in per.items() if name != DECODE)))
        experts = expert_bytes_read(torch, step, packed)
    dense = sum(int(x.numel()) * 4 for name, x in tree_items(packed)
                if "w_packed" in name)
    emb = int(packed["embed"]["emb"].numel()) * 4
    step_bound = (dense + experts + emb) / HBM_BYTES_PER_S * 1e3
    print(f"[families decode step] {cfg.name} ({cfg.num_layers} layers) at "
          f"M = {LM_SLOTS}: {step_ms:.3f} ms (CUDA events), device busy "
          f"{prof['device_busy_ms']:.4f} ms, profiled wall "
          f"{prof['wall_ms']:.3f} ms, idle share "
          f"{_num(prof['idle_share'], '.4f')}, "
          f"{_num(prof['device_records'], '.0f')} device records a step "
          f"({prof['device_timing']}); bound {step_bound:.4f} ms "
          f"({dense / 1e9:.3f} GB of dense sign words, {experts / 1e9:.3f} "
          f"GB of the experts that hold rows, {emb / 1e9:.3f} GB of f32 "
          f"unembedding at 3.35 TB/s) ({smi})", flush=True)
    for name, ms in prof["device_ms_by_kernel"].items():
        print(f"[families decode step] {cfg.name} device ms a step "
              f"{ms:.4f}: {name[:90]}", flush=True)
    return {"step_ms": step_ms, "step_profile": prof,
            "step_bound_ms": step_bound, "dense_sign_bytes": dense,
            "expert_sign_bytes": experts, "emb_bytes": emb}


def lm_launches_per_step_of(rec: dict) -> dict:
    """The launches a decode step of a phase 12 path made, by kernel."""
    if "serve" in rec:
        return rec["serve"]["kernel_launches_per_decode_step"]
    return {k: v / TF_STEPS for k, v in rec["decode_launches"].items() if v}


def families_summary(families: dict) -> dict:
    """Phase 12's numbers for the JSON line."""
    out = {}
    for key in ("moe", "ssm", "hybrid"):
        rec = families[key]
        out[rec["arch"]] = {
            "launches_per_decode_step": lm_launches_per_step_of(rec),
            "decode_step_ms": rec["step_ms"],
            "decode_step_device_busy_ms":
                rec["step_profile"]["device_busy_ms"],
            "decode_step_idle_share": rec["step_profile"]["idle_share"],
            "decode_step_bound_ms": rec["step_bound_ms"],
            "peak_memory_bytes": rec["peak_memory_bytes"],
            "init_s": rec["init_s"]}
        if "serve" in rec:
            out[rec["arch"]].update({k: rec["serve"][k] for k in (
                "tok_per_s", "tick_p50_ms", "tick_p95_ms")})
        for check in ("parity", "decode_vs_forward"):
            if check in rec:
                out[rec["arch"]][check] = rec[check]
    return out


def family_parity(torch, dev, cfg, prompts, packed=None) -> dict:
    """Phase 12c: `lm_prefill_parity` of ``cfg`` at PARITY_TOL, the f32
    params drawn with SEED and ``packed`` their `deploy_lm` where not
    given; printed."""
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.serve import deploy_lm

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        params = init_lm_params(cfg, gen, device=dev)
        if packed is None:
            packed = deploy_lm(params)
        parity = lm_prefill_parity(torch, params, packed, cfg, prompts,
                                   tol=PARITY_TOL)
    del params, packed
    torch.cuda.empty_cache()
    print(f"[families parity] {cfg.name} full width, {cfg.num_layers} "
          f"layers, {cfg.num_experts} experts: packed prefill logits vs "
          f"unpacked w1a8_eval max_abs {parity['max_abs_err']:.6g} of "
          f"max|logit| {parity['max_abs_logit']:.6g} (rel "
          f"{parity['rel_err']:.3g}, tol {PARITY_TOL}; "
          f"{parity['codes_forced']} tie codes forced over "
          f"{parity['quantizer_calls']} quantizer calls; unforced max_abs "
          f"{parity['unforced_max_abs_err']:.6g}); greedy tokens equal on "
          f"{parity['decided_rows']} of {parity['rows']} decided rows",
          flush=True)
    return parity


def drive_families(torch, np, dev, smi: str) -> dict:
    """Phase 12: the grouped popcount entry (a); mixtral-8x7b at full
    width and depth, packed (drawn stage by stage, `init_packed_lm`),
    served through `run_lm` (b) and its decode step timed; its packed
    prefill against the unpacked one over 2 layers (c); mamba2-1.3b the
    same as (b) (d), decode ≡ forward (f) and (c) over 48 layers;
    jamba-1.5-large-398b over one period (8 layers), packed, prefilled
    and decoded 5 steps with every launch counted (e), decode ≡ forward
    (f) and (c) with HYBRID_PARITY_EXPERTS experts. (e) and (f) set
    capacity_factor = num_experts, `plan_dispatch`'s no-drop bound, so a
    token's experts do not depend on the batch it came in."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve as launch
    from repro_torch.serve import init_packed_lm
    from repro_torch.serve.engine import decode_step, prefill

    t0 = time.perf_counter()
    grouped = check_grouped(torch, np, dev, smi)
    print(f"[grouped] {len(grouped)} shapes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = torch.tensor([[2 + i, 11, 7 + i % 3] for i in range(LM_SLOTS)],
                           dtype=torch.int32, device=dev)
    out = {"card": smi, "grouped": grouped, "launches": {}}

    def packed_init(cfg):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        t0 = time.perf_counter()
        packed = init_packed_lm(cfg, gen, device=dev)
        torch.cuda.synchronize()
        return packed, time.perf_counter() - t0

    # (b) mixtral-8x7b, 32 layers, packed, served
    cfg = configs.get_config(MOE_ARCH)
    packed, init_s = packed_init(cfg)
    record, counts, peak = serve_family(torch, dev, smi, MOE_ARCH, packed)
    out["launches"]["lm moe serve"] = counts
    out["moe"] = {"arch": MOE_ARCH, "init_s": init_s, "serve": record,
                  "peak_memory_bytes": peak,
                  **time_decode_step(torch, cfg, packed, prompts, smi),
                  "tick": tick_timing(torch, cfg, packed, dev, smi)}
    del packed
    torch.cuda.empty_cache()
    # (c) packed against unpacked prefill, mixtral's full width, 2 layers
    cfg2 = dataclasses.replace(cfg, num_layers=MOE_PARITY_LAYERS)
    out["moe"]["parity"] = family_parity(torch, dev, cfg2, prompts)
    # (d) mamba2-1.3b, 48 layers, packed, served; (f) decode ≡ forward
    cfg = configs.get_config(SSM_ARCH)
    packed, init_s = packed_init(cfg)
    record, counts, peak = serve_family(torch, dev, smi, SSM_ARCH, packed)
    out["launches"]["lm ssm serve"] = counts
    out["ssm"] = {"arch": SSM_ARCH, "init_s": init_s, "serve": record,
                  "peak_memory_bytes": peak,
                  **time_decode_step(torch, cfg, packed, prompts, smi),
                  "tick": tick_timing(torch, cfg, packed, dev, smi),
                  "decode_vs_forward": decode_vs_forward(torch, cfg, packed,
                                                         prompts)}
    # its packed prefill against the unpacked one over all 48 layers, the
    # served tree (`init_packed_lm`) against `init_lm_params`' under the
    # same seed
    out["ssm"]["parity"] = family_parity(torch, dev, cfg, prompts, packed)
    del packed
    torch.cuda.empty_cache()
    # (e) jamba over one period, packed: prefill and 5 decode steps
    full = configs.get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS,
                              capacity_factor=float(full.num_experts))
    torch.cuda.reset_peak_memory_stats(dev)
    packed, init_s = packed_init(cfg)
    _zero(launch.KERNELS)
    with torch.no_grad():
        logits, cache = prefill(cfg, packed, prompts, max_len=LM_MAX_LEN,
                                mode="w1a8_eval")
        pre_counts = launch.launch_counts()
        _zero(launch.KERNELS)
        for _ in range(TF_STEPS):
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, cache = decode_step(cfg, packed, cache, tok,
                                        mode="w1a8_eval")
        torch.cuda.synchronize()
    step_counts = launch.launch_counts()
    want = {k: v * TF_STEPS for k, v in lm_launches_per_step(cfg).items()}
    got = {k: float(v) for k, v in step_counts.items() if v}
    if got != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{HYBRID_ARCH} decode: launches {got}, want "
                             f"{want}, logits finite "
                             f"{bool(torch.isfinite(logits).all())}")
    out["launches"]["lm hybrid"] = {
        k: pre_counts.get(k, 0) + step_counts.get(k, 0)
        for k in set(pre_counts) | set(step_counts)}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[families hybrid] {HYBRID_ARCH} full width, {HYBRID_LAYERS} "
          f"layers, packed (init {init_s:.1f} s): prefill launches "
          f"{ {k: v for k, v in pre_counts.items() if v} }, {TF_STEPS} "
          f"decode steps launches {got} (want {want}), logits finite; "
          f"peak memory {peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    out["hybrid"] = {"arch": HYBRID_ARCH, "layers": HYBRID_LAYERS,
                     "init_s": init_s, "prefill_launches": pre_counts,
                     "decode_launches": step_counts,
                     "peak_memory_bytes": peak,
                     **time_decode_step(torch, cfg, packed, prompts, smi),
                     "decode_vs_forward": decode_vs_forward(torch, cfg,
                                                            packed, prompts)}
    del packed
    torch.cuda.empty_cache()
    # its packed prefill against the unpacked one over the period, the
    # experts cut to HYBRID_PARITY_EXPERTS
    out["hybrid"]["parity"] = family_parity(torch, dev, dataclasses.replace(
        cfg, num_experts=HYBRID_PARITY_EXPERTS), prompts)
    for key in ("ssm", "hybrid"):
        tf = out[key]["decode_vs_forward"]
        print(f"[families decode≡forward] {out[key]['arch']}: {TF_STEPS} "
              f"greedy steps against the teacher-forced forward, max_abs "
              f"{tf['max_abs_err']:.6g} of max|logit| "
              f"{tf['max_abs_logit']:.6g} (rel {tf['rel_err']:.3g}, tol "
              f"{TF_TOL}; {tf['codes_forced']} tie codes forced over "
              f"{tf['quantizer_calls']} quantizer calls; unforced max_abs "
              f"{tf['unforced_max_abs_err']:.6g}); argmax equal on "
              f"{tf['decided_tokens']} of {tf['tokens']} decided ({smi})",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 13: LM QAT training on the card, and the trained model served
# ---------------------------------------------------------------------------

LM_TRAIN_ARCH = "chatglm3-6b"  # at full width, depth cut
LM_TRAIN_LAYERS = 4            # 1.08 B params; AdamW's f32 params, grads and
                               # moments some 17 GB (28 layers: some 100 GB)
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 256
LM_TRAIN_MICRO, LM_TRAIN_STEPS, LM_TRAIN_LR = 2, 10, 3e-4
LM_STEP_PARITY = (1, 2, 32)    # (a): layers, B, S; card against the CPU
LM_STEP_LOSS_TOL, LM_STEP_GRAD_TOL = 1e-5, 1e-3
LM_LAUNCH_ARCH, LM_LAUNCH_STEPS = "mamba2-1.3b", 3
LM_CKPT_STEPS, LM_PREEMPT_AFTER = 8, 4
LM_RESUME_TOL = 1e-5


def _grad_errs(np, got: list, want: list, paths: list) -> dict:
    """{path: max|got − want| / max|want|}, both moved to the host."""
    out = {}
    for path, g, w in zip(paths, got, want):
        g = g.detach().double().cpu().numpy()
        w = w.detach().double().cpu().numpy()
        scale = float(np.abs(w).max())
        out[path] = (float(np.abs(g - w).max()) / scale if scale > 0
                     else float(np.abs(g).max()))
    return out


@contextlib.contextmanager
def tf32_on(torch):
    """cuBLAS and cuDNN TF32 on outside any `full_f32` block: an op that
    escapes it then lands some 1e-3 off, which the checks see."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def check_lm_train_step(torch, np, dev, smi: str) -> dict:
    """Phase 13a: one `lm_loss` + gradient of chatglm3-6b at full width,
    cut to one layer, B = 2, S = 32, ``w1a8_train``, on the card against
    the CPU from the same seeded params (drawn on the CPU) and the port's
    batch, with TF32 on globally and the codes that round across a tie on
    one side only forced to the CPU's (`train.ties`). Loss within
    LM_STEP_LOSS_TOL relative, each gradient leaf within
    LM_STEP_GRAD_TOL·max|g|. Also prints how far the same backward run
    outside `full_f32` lands (what the check would catch), and the card's
    remat gradients against its plain ones."""
    import dataclasses
    import functools

    from repro_torch import configs
    from repro_torch.data import pipeline as data
    from repro_torch.models import layers
    from repro_torch.models.transformer import (init_lm_params, tree_items,
                                                tree_map)
    from repro_torch.train import step as train_step
    from repro_torch.train import ties

    n_layers, b, s = LM_STEP_PARITY
    cfg = dataclasses.replace(configs.get_config(LM_TRAIN_ARCH),
                              num_layers=n_layers)
    t0 = time.perf_counter()
    params_c = init_lm_params(cfg, torch.Generator().manual_seed(SEED),
                              device="cpu")
    params_g = tree_map(lambda t: t.to(dev), params_c)
    ds = data.make_lm_dataset(cfg.vocab_size, s, b, seed=SEED)
    tokens, labels = data.lm_batch(ds, 0, device="cpu")
    batch_c = {"tokens": tokens, "labels": labels}
    batch_g = {k: v.to(dev) for k, v in batch_c.items()}
    paths = [p for p, _ in tree_items(params_c)]

    def loss_fn(remat):
        return functools.partial(train_step.lm_loss, cfg, mode="w1a8_train",
                                 remat=remat)
    with ties.record("lsq_fake_quant", module=layers) as recorded:
        loss_c, grads_c = train_step.loss_and_grads(loss_fn(False), params_c,
                                                    batch_c)
    cpu_s = time.perf_counter() - t0
    with tf32_on(torch):
        with ties.forced(recorded, "lsq_fake_quant", module=layers) as forced:
            loss_g, grads_g = train_step.loss_and_grads(loss_fn(False),
                                                        params_g, batch_g)
        # the same backward outside full_f32: TF32 wherever autograd runs
        leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                          params_g)
        flat = [x for _, x in tree_items(leaves)]
        with ties.forced(recorded, "lsq_fake_quant", module=layers):
            loss = loss_fn(False)(leaves, batch_g)
        tf32_grads = torch.autograd.grad(loss, flat)
        # remat on the card against the plain step (no forcing: the
        # recomputed forward calls the quantizer again)
        loss_r, grads_r = train_step.loss_and_grads(loss_fn(True), params_g,
                                                    batch_g)
        loss_p, grads_p = train_step.loss_and_grads(loss_fn(False), params_g,
                                                    batch_g)
    torch.cuda.synchronize()
    errs = _grad_errs(np, grads_g, grads_c, paths)
    loss_rel = abs(float(loss_g) / float(loss_c) - 1.0)
    worst = max(errs, key=errs.get)
    if loss_rel > LM_STEP_LOSS_TOL or errs[worst] > LM_STEP_GRAD_TOL:
        raise AssertionError(
            f"LM train step on the card vs the CPU: loss {float(loss_g)} vs "
            f"{float(loss_c)} (rel {loss_rel}), gradient leaves "
            f"{sorted(errs.items(), key=lambda kv: -kv[1])[:6]} (·max|g|), "
            f"{sum(forced)} inputs forced at ties and rails")
    tf32_errs = _grad_errs(np, tf32_grads, grads_c, paths)
    remat_errs = _grad_errs(np, grads_r, grads_p, paths)
    remat_exact = bool(torch.equal(loss_r, loss_p)) and all(
        torch.equal(x, y) for x, y in zip(grads_r, grads_p))
    if (abs(float(loss_r) / float(loss_p) - 1.0) > LM_STEP_LOSS_TOL
            or max(remat_errs.values()) > LM_STEP_GRAD_TOL):
        raise AssertionError(f"remat on the card: loss {float(loss_r)} vs "
                             f"{float(loss_p)}, gradient errors {remat_errs}")
    record = {"layers": n_layers, "batch": b, "seq": s,
              "loss_card": float(loss_g), "loss_cpu": float(loss_c),
              "loss_rel_err": loss_rel, "worst_leaf": worst,
              "max_grad_rel_err": errs[worst], "grad_rel_err": errs,
              "forced_codes": sum(forced), "quantizer_calls": len(forced),
              "tf32_backward_max_grad_rel_err": max(tf32_errs.values()),
              "remat_bit_for_bit": remat_exact,
              "remat_max_grad_rel_err": max(remat_errs.values()),
              "cpu_s": cpu_s}
    print(f"[lm train] (a) one step of {LM_TRAIN_ARCH} at full width, "
          f"{n_layers} layer, B={b} S={s}, card vs CPU (TF32 on outside "
          f"full_f32): loss {float(loss_g):.7g} vs {float(loss_c):.7g} (rel "
          f"{loss_rel:.3g}, limit {LM_STEP_LOSS_TOL}); worst gradient leaf "
          f"{worst} {errs[worst]:.3g}·max|g| (limit {LM_STEP_GRAD_TOL}); "
          f"{sum(forced)} inputs forced at ties and LSQ's rails over "
          f"{len(forced)} quantizer calls; a backward outside full_f32 would be "
          f"{record['tf32_backward_max_grad_rel_err']:.3g}·max|g| off; remat "
          f"vs none on the card: "
          f"{'bit for bit' if remat_exact else 'not bit for bit'} (worst "
          f"{record['remat_max_grad_rel_err']:.3g}·max|g|); CPU {cpu_s:.1f} "
          f"s ({smi})", flush=True)
    return record


def train_bound(n_params: int, tokens: int, state_bytes: int) -> tuple:
    """(bound ms, by): 8·N·T f32 operations (forward, remat's second
    forward, backward) at the f32 peak, against the bytes a step must move
    (params and AdamW moments read, and written back)."""
    t_ops = 8.0 * n_params * tokens / FP32_OPS_PER_S
    t_bytes = 2.0 * state_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def train_full_width(torch, dev, smi: str) -> tuple:
    """Phase 13b: chatglm3-6b at full width, LM_TRAIN_LAYERS layers,
    ``w1a8_train``, remat on, LM_TRAIN_BATCH × LM_TRAIN_SEQ a step in
    LM_TRAIN_MICRO microbatches, LM_TRAIN_STEPS AdamW steps through
    `run_train` under the launcher's schedule: the last loss must sit
    below the first, and each update must lower the loss of the batch it
    came from (a sharper test: over 10 steps at vocab 65024 the curve
    wanders by more than it falls). CUDA-event
    ms of each step, tokens/s, peak memory, the step's bound, and the device
    busy ms and idle share of one more step (torch.profiler). Returns
    (the trained params, the record)."""
    import dataclasses
    import math

    from repro_torch import configs
    from repro_torch.data import pipeline as data
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.transformer import (count_lm_params,
                                                init_lm_params, tree_items)
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train.loop import StepTimer, run_train
    from repro_torch.train.step import lm_loss, make_train_step

    cfg = dataclasses.replace(configs.get_config(LM_TRAIN_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_lm_params(cfg, gen, device=dev)
    n_params = count_lm_params(params)
    opt = adamw(cosine_schedule(LM_TRAIN_LR, max(LM_TRAIN_STEPS // 20, 1),
                                LM_TRAIN_STEPS))
    step_fn = make_train_step(cfg, opt, microbatches=LM_TRAIN_MICRO,
                              remat=True)
    ds = data.make_lm_dataset(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                              seed=SEED)
    batch_fn = make_batch_fn(cfg, ds, dev)
    timer, losses, after = StepTimer(dev), [], []

    def timed(p, s, batch):
        with timer:
            p, s, m = step_fn(p, s, batch)
        losses.append(m["loss"])
        # the same batch's loss under the updated params: the update must
        # lower it (outside the timed region)
        with torch.no_grad():
            after.append(lm_loss(cfg, p, batch, mode="w1a8_train"))
        return p, s, m
    state = opt[0](params)
    state_bytes = sum(int(x.numel()) * x.element_size() for _, x in
                      tree_items({"params": params, "opt_state": state}))
    t0 = time.perf_counter()
    params, state, _ = run_train(
        train_step=timed, params=params, opt_state=state, batch_fn=batch_fn,
        steps=LM_TRAIN_STEPS, log_every=1,
        print_fn=lambda line: print(f"[lm train] {line}", flush=True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    ms = timer.ms()
    losses = [float(x) for x in losses]
    after = [float(x) for x in after]
    if not all(a < b for a, b in zip(after, losses)) or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"LM train: an update did not lower its own "
                             f"batch's loss: before {losses}, after {after}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"LM train: the loss did not fall: {losses}")
    steady = statistics.median(ms[1:])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    bound_ms, bound_by = train_bound(n_params, tokens, state_bytes)

    live = {"p": params, "s": state}
    batch = batch_fn(LM_TRAIN_STEPS)

    def one_step():
        live["p"], live["s"], _ = step_fn(live["p"], live["s"], batch)
    prof = device_profile(torch, one_step, n=2)
    prof["idle_share"] = (None if prof["device_launches"] is None
                          else 1.0 - prof["device_busy_ms"] / prof["wall_ms"])
    del live
    record = {"arch": LM_TRAIN_ARCH, "layers": LM_TRAIN_LAYERS,
              "params": n_params, "batch": LM_TRAIN_BATCH,
              "seq": LM_TRAIN_SEQ, "microbatches": LM_TRAIN_MICRO,
              "steps": LM_TRAIN_STEPS, "lr": LM_TRAIN_LR, "losses": losses,
              "losses_after_update": after,
              "step_ms": ms, "ms_per_step": steady,
              "tokens_per_s": tokens / (steady / 1e3),
              "peak_memory_bytes": peak, "state_bytes": state_bytes,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "step_profile": prof, "wall_s": wall_s}
    print(f"[lm train] (b) {LM_TRAIN_ARCH} full width, {LM_TRAIN_LAYERS} "
          f"layers ({n_params / 1e9:.3f} B params), w1a8_train, remat, "
          f"B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ} in {LM_TRAIN_MICRO} "
          f"microbatches, {LM_TRAIN_STEPS} AdamW steps: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (each batch's after its update: "
          f"{[round(x, 4) for x in after]}, each lower); ms a step (CUDA "
          f"events) "
          f"{[round(x, 2) for x in ms]}, median after the first "
          f"{steady:.2f}; {record['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; device busy "
          f"{prof['device_busy_ms']:.2f} ms a step, profiled wall "
          f"{prof['wall_ms']:.2f} ms, idle share "
          f"{_num(prof['idle_share'], '.4f')}, "
          f"{_num(prof['device_launches'], '.0f')} device records "
          f"({prof['device_timing']}); bound {bound_ms:.2f} ms by "
          f"{bound_by} (8·N·T = {8 * n_params * tokens:.4g} f32 operations "
          f"at 67 T/s; {2 * state_bytes / 1e9:.2f} GB at 3.35 TB/s) ({smi})",
          flush=True)
    return params, cfg, record


def serve_trained(torch, dev, smi: str, params, cfg) -> dict:
    """Phase 13e: the trained params deployed (`deploy_lm`) and served.
    Packed prefill against the unpacked ``w1a8_eval`` one of the same
    trained tree, tie codes forced, within PARITY_TOL·max|logit|
    (`lm_prefill_parity`); `run_lm` on the trained tree (8 requests × 16
    tokens, slots 4) with every launch count zeroed before and read
    after: done-mask tokens equal to host-checked ones, per decode step
    exactly `lm_launches_per_step` popcount launches (7 × layers) and no
    other kernel; the decode step timed as phase 12's."""
    import argparse

    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import tree_items
    from repro_torch.serve import deploy_lm

    t0 = time.perf_counter()
    with torch.no_grad():
        packed = deploy_lm(params)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    if any(x.requires_grad or x.grad is not None
           for _, x in tree_items(packed)):
        raise AssertionError("deploy_lm: a packed leaf keeps a grad")
    prompts = torch.tensor([[2 + i, 11, 7 + i % 3] for i in range(LM_SLOTS)],
                           dtype=torch.int32, device=dev)
    parity = lm_prefill_parity(torch, params, packed, cfg, prompts,
                               tol=PARITY_TOL)
    print(f"[lm train] (e) trained {LM_TRAIN_ARCH}, {cfg.num_layers} layers, "
          f"deployed in {deploy_s:.2f} s: packed prefill logits vs unpacked "
          f"w1a8_eval max_abs {parity['max_abs_err']:.6g} of max|logit| "
          f"{parity['max_abs_logit']:.6g} (rel {parity['rel_err']:.3g}, tol "
          f"{PARITY_TOL}; {parity['codes_forced']} tie codes forced over "
          f"{parity['quantizer_calls']} quantizer calls; unforced max_abs "
          f"{parity['unforced_max_abs_err']:.6g}); greedy tokens equal on "
          f"{parity['decided_rows']} of {parity['rows']} decided rows",
          flush=True)
    args = argparse.Namespace(
        workload="lm", arch=LM_TRAIN_ARCH, reduced=False, packed=True,
        requests=LM_REQUESTS, max_new=LM_MAX_NEW, slots=LM_SLOTS,
        max_len=LM_MAX_LEN, temperature=0.0, stop_token=[], seed=SEED,
        device=str(dev))
    want = lm_launches_per_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(launch.KERNELS)
    with torch.no_grad():
        record = launch.run_lm(args, params=params, cfg=cfg)
    torch.cuda.synchronize()
    counts = launch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if record["kernel_launches_per_decode_step"] != want:
        raise AssertionError(f"trained model decode step: launches "
                             f"{record['kernel_launches_per_decode_step']}, "
                             f"want {want}")
    if set(n for name, n in counts.items() if name not in want) - {0}:
        raise AssertionError(f"trained model serve launched other kernels: "
                             f"{counts}")
    print(f"[lm train] (e) served packed through run_lm, {LM_REQUESTS} "
          f"requests x {LM_MAX_NEW} tokens, slots {LM_SLOTS}: done-mask "
          f"tokens equal host-checked; launches a decode step {want} "
          f"({record['decode_steps']} steps), in the run "
          f"{ {k: v for k, v in counts.items() if v} }; "
          f"{record['tok_per_s']:.2f} tok/s, tick p50 "
          f"{record['tick_p50_ms']:.3f} ms, p95 {record['tick_p95_ms']:.3f} "
          f"ms, peak memory {peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    step = time_decode_step(torch, cfg, packed, prompts, smi)
    return {"deploy_s": deploy_s, "parity": parity, "serve": record,
            "launches": counts, "per_decode_step": want,
            "peak_memory_bytes": peak, **step}


def run_launcher(smi: str) -> dict:
    """Phase 13c: ``python -m repro_torch.launch.train --arch
    LM_LAUNCH_ARCH --steps LM_LAUNCH_STEPS`` at its full published config
    (all layers, the default seq 128 and batch 8, AdamW, remat on), in a
    process of its own: exit 0, its loop lines and JSON line printed,
    finite losses."""
    import math
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LM_LAUNCH_ARCH, "--steps", str(LM_LAUNCH_STEPS)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    record = json.loads(lines[-1])
    if not (math.isfinite(record["first_loss"])
            and math.isfinite(record["last_loss"])
            and record["steps"] == LM_LAUNCH_STEPS):
        raise AssertionError(f"launcher run: {record}")
    for line in lines[:-1]:
        print(f"[lm train] (c) {line}", flush=True)
    print(f"[lm train] (c) {' '.join(cmd[1:])}: exit 0 in {wall_s:.1f} s; "
          f"{lines[-1]} ({smi})", flush=True)
    return {**record, "wall_s": wall_s}


def resume_on_card(torch, dev, smi: str, full_state_bytes: int) -> dict:
    """Phase 13d: reduced chatglm3-6b on the card through `run_train` into
    ``build/ckpt_phase13/``; the PREEMPT sentinel appears during step
    LM_PREEMPT_AFTER of LM_CKPT_STEPS, so the loop checkpoints there and
    stops. `resume_or_init` restores it (the template on ``meta``): equal
    to the saved state bit for bit. The resumed run's last loss against an
    uninterrupted run's: within LM_RESUME_TOL relative (printed whether bit
    for bit). The full-width state's checkpoint size is printed, not
    written."""
    import os
    import shutil

    from repro_torch import ckpt, configs
    from repro_torch.data import pipeline as data
    from repro_torch.models.transformer import init_lm_params, tree_items
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train.loop import resume_or_init, run_train
    from repro_torch.train.step import make_train_step

    cfg = configs.get_reduced(LM_TRAIN_ARCH)
    opt = adamw(cosine_schedule(3e-3, 1, LM_CKPT_STEPS))
    step_fn = make_train_step(cfg, opt, microbatches=2, remat=True)
    ds = data.make_lm_dataset(cfg.vocab_size, 16, 8, seed=SEED)
    d = ROOT / "build" / "ckpt_phase13"
    shutil.rmtree(d, ignore_errors=True)
    sentinel = d / "PREEMPT"

    def init_fn(device):
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED)
        params = init_lm_params(cfg, gen, device=device)
        return {"params": params, "opt_state": opt[0](params)}

    def run(state, start, ckpt_dir, preempt_at=None):
        losses = {}

        def batch_fn(i):
            if i == preempt_at:
                d.mkdir(parents=True, exist_ok=True)
                sentinel.touch()
            t, lab = data.lm_batch(ds, i, device=dev)
            return {"tokens": t, "labels": lab}

        def train_step(p, s, b):
            p, s, m = step_fn(p, s, b)
            losses[int(m["step"])] = m["loss"]
            return p, s, m
        p, s, n = run_train(train_step=train_step, params=state["params"],
                            opt_state=state["opt_state"], batch_fn=batch_fn,
                            steps=LM_CKPT_STEPS, start_step=start,
                            ckpt_dir=ckpt_dir, print_fn=lambda _: None)
        return {"params": p, "opt_state": s}, n, losses

    saved, stopped, _ = run(init_fn(dev), 0, str(d),
                            preempt_at=LM_PREEMPT_AFTER - 1)
    if stopped != LM_PREEMPT_AFTER or \
            ckpt.latest_step(str(d)) != LM_PREEMPT_AFTER:
        raise AssertionError(f"preemption: stopped at {stopped}, latest "
                             f"checkpoint {ckpt.latest_step(str(d))}")
    os.remove(sentinel)
    restored, start = resume_or_init(str(d), init_fn, device=dev,
                                     print_fn=lambda _: None)
    a, b = tree_items(restored), tree_items(saved)
    exact = [p for p, _ in a] == [p for p, _ in b] and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for (_, x), (_, y) in zip(a, b))
    if start != LM_PREEMPT_AFTER or not exact:
        raise AssertionError(f"restore at step {start}: not equal to the "
                             f"saved state")
    _, n, resumed = run(restored, start, str(d))
    _, _, straight = run(init_fn(dev), 0, None)
    last_r = float(resumed[LM_CKPT_STEPS])
    last_s = float(straight[LM_CKPT_STEPS])
    rel = abs(last_r / last_s - 1.0)
    if n != LM_CKPT_STEPS or rel > LM_RESUME_TOL or \
            ckpt.latest_step(str(d)) != LM_CKPT_STEPS:
        raise AssertionError(f"resume: step {n}, loss {last_r} vs "
                             f"uninterrupted {last_s}")
    bitwise = last_r == last_s
    print(f"[lm train] (d) reduced {LM_TRAIN_ARCH} on the card: preempted "
          f"by the sentinel after step {LM_PREEMPT_AFTER} of {LM_CKPT_STEPS}, "
          f"checkpointed, restored equal to the saved state bit for bit "
          f"(template on meta); step {LM_CKPT_STEPS} loss resumed "
          f"{last_r:.9g} vs uninterrupted {last_s:.9g} (rel {rel:.3g}, tol "
          f"{LM_RESUME_TOL}; {'bit for bit' if bitwise else 'not bit for bit'}"
          f"); a checkpoint of (b)'s full-width state would write "
          f"{full_state_bytes / 1e9:.2f} GB (not written) ({smi})",
          flush=True)
    return {"stopped_at": stopped, "restored_step": start,
            "restored_equal_saved": exact, "loss_resumed": last_r,
            "loss_uninterrupted": last_s, "rel_err": rel,
            "bit_for_bit": bitwise,
            "full_width_checkpoint_bytes": full_state_bytes}


def drive_lm_train(torch, np, dev, smi: str) -> dict:
    """Phase 13: (a) `check_lm_train_step`, (b) `train_full_width`, (e)
    `serve_trained` on (b)'s params, (c) `run_launcher`, (d)
    `resume_on_card`. Returns the record, with (e)'s serve launches as the
    path's."""
    out = {"card": smi}
    t0 = time.perf_counter()
    out["step_parity"] = check_lm_train_step(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    params, cfg, out["train"] = train_full_width(torch, dev, smi)
    out["serve"] = serve_trained(torch, dev, smi, params, cfg)
    out["launches"] = out["serve"]["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["launcher"] = run_launcher(smi)
    out["resume"] = resume_on_card(torch, dev, smi,
                                   out["train"]["state_bytes"])
    out["wall_s"] = time.perf_counter() - t0
    return out


def lm_train_summary(rec: dict) -> dict:
    """Phase 13's numbers for the kernels line."""
    train, serve = rec["train"], rec["serve"]
    return {
        "arch": train["arch"], "layers": train["layers"],
        "params": train["params"],
        "step_parity": {k: rec["step_parity"][k] for k in (
            "loss_rel_err", "worst_leaf", "max_grad_rel_err",
            "tf32_backward_max_grad_rel_err", "remat_bit_for_bit")},
        "loss_first": train["losses"][0], "loss_last": train["losses"][-1],
        "ms_per_step": train["ms_per_step"],
        "tokens_per_s": train["tokens_per_s"],
        "step_device_busy_ms": train["step_profile"]["device_busy_ms"],
        "step_idle_share": train["step_profile"]["idle_share"],
        "peak_memory_bytes": train["peak_memory_bytes"],
        "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
        "launcher": {k: rec["launcher"][k] for k in (
            "arch", "steps", "first_loss", "last_loss", "ms_per_step",
            "tokens_per_s", "peak_memory_bytes")},
        "resume": {k: rec["resume"][k] for k in (
            "restored_equal_saved", "rel_err", "bit_for_bit")},
        "serve": {"parity_rel_err": serve["parity"]["rel_err"],
                  "launches_per_decode_step": serve["per_decode_step"],
                  "tok_per_s": serve["serve"]["tok_per_s"],
                  "decode_step_ms": serve["step_ms"],
                  "decode_step_device_busy_ms":
                      serve["step_profile"]["device_busy_ms"],
                  "decode_step_idle_share":
                      serve["step_profile"]["idle_share"],
                  "decode_step_bound_ms": serve["step_bound_ms"]}}


# ---------------------------------------------------------------------------
# Phase 14: the distribution layer on one card (wires, NCCL, the pipeline)
# ---------------------------------------------------------------------------

WIRE_SHAPE = (4096, 13696)     # chatglm3-6b's MLP up-projection gradient
DIST_MICRO, DIST_LR = 2, 1e-2  # (c): 1F1B microbatches; SGD-M's lr
DIST_INT8_TOL = 0.03           # the reference's int8-wire envelope
DIST_TIMED_STEPS = 3           # (c): AdamW steps timed, the first a warm-up
LM_PHASE13_MS = 539.56         # phase 13's step, PERF.md (PR 25)
LAUNCH_PHASE13_MS = 888.25     # phase 13's mamba2-1.3b launcher step


def _tree_rel(torch, got: list, want: list) -> float:
    d = sum(float(torch.sum((g.double() - w.double()) ** 2))
            for g, w in zip(got, want))
    n = sum(float(torch.sum(w.double() ** 2)) for w in want)
    return (d / n) ** 0.5


def check_wires(torch, dev, smi: str) -> dict:
    """Phase 14a: `QTensor.quantize_s8`, `quantize_b1` (per tensor and
    per slice) and `pack_b1` of a seeded f32 tensor of WIRE_SHAPE on the
    card against the CPU: codes, words and scales bit for bit."""
    from repro_torch.core.qtensor import QTensor
    x_c = torch.randn(WIRE_SHAPE, generator=torch.Generator().manual_seed(
        SEED))
    x_g = x_c.to(dev)
    wires = {"s8": lambda x: QTensor.quantize_s8(x),
             "b1": lambda x: QTensor.quantize_b1(x),
             "b1_per_slice": lambda x: QTensor.quantize_b1(x, per_slice=True),
             "b1_packed_axis0": lambda x: QTensor.pack_b1(x, axis=0)}
    record = {"shape": list(WIRE_SHAPE), "f32_bytes": x_c.numel() * 4}
    for name, fn in wires.items():
        got, want = fn(x_g), fn(x_c)
        torch.cuda.synchronize()
        for what in ("data", "scale"):
            a, b = getattr(got, what).cpu(), getattr(want, what)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"wire {name}: {what} on the card is not "
                                     f"the CPU's bit for bit")
        ms = cuda_ms(torch, lambda fn=fn: fn(x_g), reps=3, n=5)
        record[name] = {"wire_bytes": got.wire_bytes(), "ms": ms}
    print(f"[dist] (a) wires at {WIRE_SHAPE} on the card = CPU bit for bit "
          f"(codes, words, scales): "
          + "; ".join(f"{k} {record[k]['wire_bytes']} B ({record[k]['ms']:.4f}"
                      f" ms)" for k in wires)
          + f" against {record['f32_bytes']} B of f32 ({smi})", flush=True)
    return record


def _recording_codes(coll):
    """Patches `collectives.s8_codes` to keep every code tensor it makes
    (the all-reduce's two legs, leaf by leaf); returns (restore, codes)."""
    real, codes = coll.s8_codes, []

    def recording(x, scale):
        out = real(x, scale)
        codes.append(out)
        return out
    coll.s8_codes = recording
    return (lambda: setattr(coll, "s8_codes", real)), codes


def _one_rank_group(torch, backend: str, name: str) -> None:
    """A one-rank process group over a FileStore under build/ (NCCL on
    the card's device 0)."""
    import torch.distributed as dist
    path = ROOT / "build" / f"store_{name}"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(str(path), 1),
                            rank=0, world_size=1)


def _pipeline_mesh(torch, backend: str, name: str):
    """`_one_rank_group` and its (data, stage) mesh."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    _one_rank_group(torch, backend, name)
    return make_pipeline_mesh(1, device="cuda" if backend == "nccl"
                              else "cpu")


def pipelined_step(torch, dev, mesh, smi: str) -> tuple:
    """Phase 14c: `make_pipeline_train_step` (1F1B, one stage, DIST_MICRO
    microbatches) on phase 13's model (LM_TRAIN_ARCH at full width,
    LM_TRAIN_LAYERS layers) from phase 13's seeded params and first batch,
    against the one-device `make_train_step` of the same row groups, SGD-M
    (its moment after a step is the clipped gradient), TF32 on outside
    `full_f32`. The f32 grad wire: loss within LM_STEP_LOSS_TOL, each
    gradient leaf within LM_STEP_GRAD_TOL·max|g|, the one-device run's tie
    codes forced in the pipeline's call order (`dist.pipeline.stage_calls`:
    the backward's recompute calls the quantizer again). The int8 wire:
    each leaf within DIST_INT8_TOL·max|g| (the wire's own bound at one data
    rank is max|g|/254) and off the f32 step. Then CUDA-event ms of
    DIST_TIMED_STEPS AdamW steps. Returns (record, {path: shape} of the
    gradients)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import pipeline as data
    from repro_torch.dist.pipeline import stage_calls
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_lm_params, tree_items
    from repro_torch.optim import adamw, sgdm
    from repro_torch.train import ties
    from repro_torch.train.step import make_pipeline_train_step, \
        make_train_step

    cfg = dataclasses.replace(configs.get_config(LM_TRAIN_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_lm_params(cfg, gen, device=dev)
    ds = data.make_lm_dataset(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                              seed=SEED)
    batch = make_batch_fn(cfg, ds, dev)(0)
    opt = sgdm(DIST_LR)
    one = make_train_step(cfg, opt, microbatches=DIST_MICRO, remat=False)
    with tf32_on(torch), ties.record("lsq_fake_quant",
                                     module=layers) as recorded:
        _, s_one, m_one = one(params, opt[0](params), batch)
    paths = [p for p, _ in tree_items(s_one["m"])]
    want = [x for _, x in tree_items(s_one["m"])]
    del s_one
    per_mb = len(recorded) // DIST_MICRO
    order = [x for m in stage_calls(1, DIST_MICRO, "1f1b", 0)
             for x in recorded[m * per_mb:(m + 1) * per_mb]]
    got, out = {}, {}
    for wire in ("fp32", "int8"):
        step = make_pipeline_train_step(cfg, opt, mesh=mesh,
                                        num_micro=DIST_MICRO, grad_wire=wire)
        with tf32_on(torch), ties.forced(order, "lsq_fake_quant",
                                         module=layers) as forced:
            _, s, m = step(params, opt[0](params), batch)
        got[wire] = [x for _, x in tree_items(s["m"])]
        out[wire] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "forced": sum(forced), "calls": len(forced)}
        del s
    del recorded, order
    loss_rel = abs(out["fp32"]["loss"] / float(m_one["loss"]) - 1.0)
    errs = {p: float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for p, g, w in zip(paths, got["fp32"], want)}
    worst = max(errs, key=errs.get)
    int8_errs = {p: float((g - w).abs().max())
                 / max(float(w.abs().max()), 1e-30)
                 for p, g, w in zip(paths, got["int8"], want)}
    int8_worst = max(int8_errs, key=int8_errs.get)
    int8_rel = _tree_rel(torch, got["int8"], want)
    int8_vs_fp32 = _tree_rel(torch, got["int8"], got["fp32"])
    if loss_rel > LM_STEP_LOSS_TOL or errs[worst] > LM_STEP_GRAD_TOL or \
            abs(out["int8"]["loss"] / float(m_one["loss"]) - 1.0) > \
            LM_STEP_LOSS_TOL or not 0.0 < int8_vs_fp32 or \
            int8_errs[int8_worst] > DIST_INT8_TOL:
        raise AssertionError(
            f"pipelined step vs one device: loss rel {loss_rel}, worst leaf "
            f"{worst} {errs[worst]}·max|g|, int8 worst leaf {int8_worst} "
            f"{int8_errs[int8_worst]}·max|g|, {int8_rel} of the tree "
            f"({int8_vs_fp32} off the f32 wire); {out}")
    shapes = {p: tuple(g.shape) for p, g in zip(paths, want)}
    del got, want

    # CUDA-event ms of AdamW steps, as phase 13's (no forcing)
    aopt = adamw(LM_TRAIN_LR)
    astep = make_pipeline_train_step(cfg, aopt, mesh=mesh,
                                     num_micro=DIST_MICRO)
    live = {"p": params, "s": aopt[0](params)}
    del params
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(DIST_TIMED_STEPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        live["p"], live["s"], _ = astep(live["p"], live["s"], batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated(dev)
    del live
    steady = statistics.median(ms[1:])
    record = {"arch": LM_TRAIN_ARCH, "layers": LM_TRAIN_LAYERS,
              "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
              "microbatches": DIST_MICRO, "schedule": "1f1b", "stages": 1,
              "loss_one_device": float(m_one["loss"]),
              "loss_rel_err": loss_rel, "worst_leaf": worst,
              "max_grad_rel_err": errs[worst],
              "int8_worst_leaf": int8_worst,
              "int8_max_grad_rel_err": int8_errs[int8_worst],
              "int8_tree_rel_err": int8_rel,
              "int8_vs_fp32_tree_rel": int8_vs_fp32, **{
                  f"{w}_{k}": v for w, r in out.items()
                  for k, v in r.items()},
              "adamw_step_ms": ms, "ms_per_step": steady,
              "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / (steady / 1e3),
              "peak_memory_bytes": peak}
    print(f"[dist] (c) make_pipeline_train_step (1f1b, 1 stage, M "
          f"{DIST_MICRO}) on {LM_TRAIN_ARCH} at full width, {LM_TRAIN_LAYERS} "
          f"layers, B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ}, NCCL: loss "
          f"{out['fp32']['loss']:.7g} vs one device {float(m_one['loss']):.7g}"
          f" (rel {loss_rel:.3g}, limit {LM_STEP_LOSS_TOL}); fp32 wire worst "
          f"leaf {worst} {errs[worst]:.3g}·max|g| (limit {LM_STEP_GRAD_TOL}),"
          f" {out['fp32']['forced']} inputs forced at ties and rails over "
          f"{out['fp32']['calls']} quantizer calls; int8 wire worst leaf "
          f"{int8_worst} {int8_errs[int8_worst]:.4f}·max|g| (limit "
          f"{DIST_INT8_TOL}), {int8_rel:.4f} of the tree, {int8_vs_fp32:.4f} "
          f"off the f32 wire; AdamW steps (CUDA events) "
          f"{[round(x, 2) for x in ms]} ms, {steady:.2f} after the first "
          f"(phase 13's one-device remat step: {LM_PHASE13_MS} ms), "
          f"{record['tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    return record, shapes


def allreduce_on_nccl(torch, dev, mesh, shapes: dict, smi: str) -> tuple:
    """Phase 14b on the card: `tree_quantized_allreduce` over a seeded
    unit-normal tree of (c)'s gradient shapes on the one-rank NCCL group,
    its two legs' codes kept; within DIST_INT8_TOL of the input (n = 1; the
    reference's envelope is for unit-normal gradients). CUDA-event ms a
    tree against an f32 `all_reduce` of every leaf. Returns (record, the
    tree, (output, codes)), the last two on the host."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tree = {p: torch.randn(s, generator=gen, device=dev)
            for p, s in shapes.items()}
    restore, codes = _recording_codes(coll)
    try:
        out = coll.tree_quantized_allreduce(tree, mesh, "data")
    finally:
        restore()
    torch.cuda.synchronize()
    rel = _tree_rel(torch, list(out.values()), list(tree.values()))
    if not 0.0 < rel <= DIST_INT8_TOL:
        raise AssertionError(f"int8 all-reduce on NCCL: {rel} of the tree")
    group = mesh.get_group("data")

    def f32_allreduce():
        for g in tree.values():
            dist.all_reduce(g.clone(), group=group)
    ms = cuda_ms(torch, lambda: coll.tree_quantized_allreduce(
        tree, mesh, "data"), reps=3, n=2)
    ms_f32 = cuda_ms(torch, f32_allreduce, reps=3, n=2)
    n = sum(int(g.numel()) for g in tree.values())
    # the least it must move: each f32 input read once, each output written
    bound = 1e3 * 8 * n / HBM_BYTES_PER_S
    record = {"leaves": len(tree), "elements": n, "tree_rel_err": rel,
              "ms": ms, "f32_allreduce_ms": ms_f32, "bound_ms": bound,
              "wire_bytes": coll.wire_bytes_saved(tree, 2)}
    card = ({k: v.cpu() for k, v in out.items()}, [c.cpu() for c in codes])
    return record, {k: v.cpu() for k, v in tree.items()}, card


def allreduce_on_gloo(torch, tree: dict, card: tuple, rec: dict,
                      smi: str) -> dict:
    """Phase 14b on the CPU: the same call over a one-rank gloo group; its
    codes on both legs and its output equal the card's bit for bit."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    mesh = _pipeline_mesh(torch, "gloo", "phase14_gloo")
    try:
        restore, codes = _recording_codes(coll)
        try:
            out = coll.tree_quantized_allreduce(tree, mesh, "data")
        finally:
            restore()
    finally:
        dist.destroy_process_group()
    card_out, card_codes = card
    same = len(codes) == len(card_codes) and all(
        torch.equal(a, b) for a, b in zip(codes, card_codes)) and all(
        torch.equal(out[k], card_out[k]) for k in out)
    if not same:
        raise AssertionError("int8 all-reduce: the card's (NCCL) codes or "
                             "output differ from the CPU's (gloo)")
    rec["codes_equal_cpu"] = True
    rec["code_tensors"] = len(codes)
    print(f"[dist] (b) tree_quantized_allreduce over a seeded unit-normal "
          f"tree of the {rec['leaves']} gradient shapes of (c)'s step "
          f"({rec['elements'] / 1e9:.3f} G elements) on a one-rank NCCL "
          f"group: both legs' int8 codes "
          f"({len(codes)} tensors) and the output equal a one-rank gloo "
          f"group's on the CPU bit for bit; {rec['tree_rel_err']:.4f} of the "
          f"tree off the input (limit {DIST_INT8_TOL}); {rec['ms']:.2f} ms a "
          f"tree (CUDA events) against {rec['f32_allreduce_ms']:.2f} for an "
          f"f32 all_reduce of each leaf and a bound of {rec['bound_ms']:.2f} "
          f"(8 bytes an element at 3.35 TB/s) ({smi})", flush=True)
    return rec


def run_pipelined_launcher(smi: str) -> dict:
    """Phase 14d: ``torchrun --nproc-per-node 1 -m repro_torch.launch.train
    --arch LM_LAUNCH_ARCH --pipeline 1f1b --pipeline-stages 1
    --microbatches 2 --grad-wire int8 --steps LM_LAUNCH_STEPS --ckpt-dir
    build/ckpt_phase14`` at the full published config: exit 0, the
    ``[pipeline]`` line, backend NCCL; then the one-device launcher
    restores its checkpoint (``--steps LM_LAUNCH_STEPS``: restored, no step
    to run). The checkpoint is removed after."""
    import math
    import os
    import shutil

    d = ROOT / "build" / "ckpt_phase14"
    shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
           "--arch", LM_LAUNCH_ARCH, "--pipeline", "1f1b",
           "--pipeline-stages", "1", "--microbatches", "2", "--grad-wire",
           "int8", "--steps", str(LM_LAUNCH_STEPS), "--ckpt-dir", str(d)]
    try:
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        wall_s = time.perf_counter() - t0
        if out.returncode:
            raise AssertionError(f"torchrun exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        lines = out.stdout.strip().splitlines()
        record = json.loads(lines[-1])
        banner = "[pipeline] 1f1b n=1 M=2 bubble=0.000 grad-wire=int8"
        if lines[0] != banner or record["backend"] != "nccl" or \
                record["steps"] != LM_LAUNCH_STEPS or not all(
                map(math.isfinite, (record["first_loss"],
                                    record["last_loss"]))):
            raise AssertionError(f"pipelined launcher: {lines}")
        for line in lines[:-1]:
            print(f"[dist] (d) {line}", flush=True)
        t0 = time.perf_counter()
        back = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             LM_LAUNCH_ARCH, "--steps", str(LM_LAUNCH_STEPS), "--ckpt-dir",
             str(d)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        restore_s = time.perf_counter() - t0
        if back.returncode:
            raise AssertionError(f"one-device restore exited "
                                 f"{back.returncode}: {back.stderr[-3000:]}")
        blines = back.stdout.strip().splitlines()
        restored = json.loads(blines[-1])
        if blines[0] != f"[resume] restored step {LM_LAUNCH_STEPS} from {d}" \
                or restored["start_step"] != LM_LAUNCH_STEPS:
            raise AssertionError(f"one-device restore: {blines}")
        ckpt_bytes = sum(f.stat().st_size for f in d.rglob("*.npy"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"[dist] (d) torchrun --nproc-per-node 1 {' '.join(cmd[6:])}: "
          f"exit 0 in {wall_s:.1f} s, backend {record['backend']}; "
          f"{_num(record['ms_per_step'], '.2f')} ms a step (phase 13's "
          f"one-device launcher: {LAUNCH_PHASE13_MS}), "
          f"{_num(record['tokens_per_s'], '.1f')} tokens/s, peak "
          f"{record['peak_memory_bytes'] / 2 ** 30:.2f} GiB; its checkpoint "
          f"({ckpt_bytes / 1e9:.2f} GB) restored by the one-device launcher "
          f"in {restore_s:.1f} s ({smi})", flush=True)
    return {**record, "wall_s": wall_s, "restore_s": restore_s,
            "checkpoint_bytes": ckpt_bytes}


def drive_dist(torch, dev, smi: str) -> dict:
    """Phase 14: (a) `check_wires`; on a one-rank NCCL group (c)
    `pipelined_step` and (b) `allreduce_on_nccl` at its gradients' shapes,
    then (b) `allreduce_on_gloo` against it; (d)
    `run_pipelined_launcher`."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    out = {"card": smi, "wires": check_wires(torch, dev, smi)}
    mesh = _pipeline_mesh(torch, "nccl", "phase14_nccl")
    try:
        out["step"], shapes = pipelined_step(torch, dev, mesh, smi)
        gc.collect()
        out["allreduce"], host, card = allreduce_on_nccl(torch, dev, mesh,
                                                         shapes, smi)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["allreduce"] = allreduce_on_gloo(torch, host, card,
                                         out["allreduce"], smi)
    del host, card
    gc.collect()
    out["launcher"] = run_pipelined_launcher(smi)
    out["wall_s"] = time.perf_counter() - t0
    return out


def dist_summary(rec: dict) -> dict:
    """Phase 14's numbers for the kernels line."""
    step, ar = rec["step"], rec["allreduce"]
    return {
        "wires": {k: v for k, v in rec["wires"].items()},
        "allreduce": {k: ar[k] for k in (
            "elements", "tree_rel_err", "ms", "f32_allreduce_ms",
            "bound_ms", "codes_equal_cpu")},
        "pipelined_step": {k: step[k] for k in (
            "arch", "layers", "loss_rel_err", "max_grad_rel_err",
            "int8_max_grad_rel_err", "int8_tree_rel_err", "fp32_forced",
            "ms_per_step",
            "tokens_per_s", "peak_memory_bytes")},
        "launcher": {k: rec["launcher"][k] for k in (
            "arch", "backend", "steps", "first_loss", "last_loss",
            "ms_per_step", "tokens_per_s", "peak_memory_bytes", "bubble")},
        "wall_s": rec["wall_s"]}


# ---------------------------------------------------------------------------
# Phase 15: the sharded model on one card (ShardCtx, EP MoE, SP decode)
# ---------------------------------------------------------------------------

SHARD_WAVES = 2                # (a): 8 requests through slots 4, 16 tokens
SHARD_SERVE_LAYERS = 8         # (a): mixtral cut from 32 layers to keep time
SHARD_TICKS = 4                # (a): sharded tick replays held against eager
SHARD_TRAIN_LAYERS = 2         # (b): mixtral at full width, 3.03 G params
SHARD_TIMED_STEPS = 3          # (b): sharded steps timed, the first a warm-up
SHARD_LR, SHARD_NO_CLIP = 1e-2, 1e9
SHARD_LOSS_TOL, SHARD_GRAD_TOL = 1e-5, 1e-3
SHARD_LAUNCH_STEPS = 2         # (c): the launcher's sharded run
SP_HEADS, SP_KV, SP_HD = 64, 8, 128   # jamba-1.5-large-398b's attention
SP_BATCH, SP_POSITIONS = 4, 32768     # one shard of long_500k's 512k / 16
SP_TOL = 1e-5


def _shard_mesh(torch, name: str):
    """A one-rank NCCL group (`_one_rank_group`) and its ('data',
    'model') = (1, 1) mesh."""
    from repro_torch.launch.mesh import make_test_mesh
    _one_rank_group(torch, "nccl", name)
    return make_test_mesh(1, 1, device="cuda")


def _wave_prompts(torch, dev, w: int):
    """Wave ``w``'s LM_SLOTS prompts of three tokens."""
    return torch.tensor([[2 + i + LM_SLOTS * w, 11, 7 + (i + w) % 3]
                         for i in range(LM_SLOTS)], dtype=torch.int32,
                        device=dev)


def _greedy_waves(torch, dev, cfg, params, ctx) -> tuple:
    """SHARD_WAVES waves of LM_SLOTS prompts, each a prefill and
    LM_MAX_NEW - 1 greedy decode steps: (every step's logits, tokens)."""
    from repro_torch.serve.engine import decode_step, prefill
    logits_all, toks_all = [], []
    with torch.no_grad():
        for w in range(SHARD_WAVES):
            prompts = _wave_prompts(torch, dev, w)
            logits, cache = prefill(cfg, params, prompts, max_len=LM_MAX_LEN,
                                    mode="w1a8_eval", ctx=ctx)
            for i in range(LM_MAX_NEW):
                logits_all.append(logits)
                toks_all.append(torch.argmax(logits, -1).to(torch.int32))
                if i < LM_MAX_NEW - 1:
                    logits, cache = decode_step(
                        cfg, params, cache, toks_all[-1][:, None],
                        mode="w1a8_eval", ctx=ctx)
    return torch.stack(logits_all), torch.stack(toks_all)


@contextlib.contextmanager
def _bf16_return_leg(torch, moe):
    """The local path with each MoE layer's expert outputs rounded
    through bf16, as the uint8 wire's return leg rounds them."""
    real = moe._expert_mm

    def rounded(p, name, *args, **kw):
        y = real(p, name, *args, **kw)
        return y.to(torch.bfloat16).to(y.dtype) if name == "down" else y
    moe._expert_mm = rounded
    try:
        yield
    finally:
        moe._expert_mm = real


def _decode_step_fn(torch, dev, cfg, params, ctx):
    """A packed decode step at M = LM_SLOTS after a prefill, under
    ``ctx``: a closure (its cache is written in place each call)."""
    from repro_torch.serve.engine import decode_step, prefill
    prompts = torch.tensor([[2 + i, 11, 7 + i % 3] for i in range(LM_SLOTS)],
                           dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, max_len=LM_MAX_LEN,
                                mode="w1a8_eval", ctx=ctx)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

    def step():
        with torch.no_grad():
            return decode_step(cfg, params, cache, tok, mode="w1a8_eval",
                               ctx=ctx)
    return step


def _sharded_generate(torch, dev, cfg, params, ctx, want_toks) -> dict:
    """Phase 15a: `generate(ctx=)` greedy over the SHARD_WAVES waves: one
    capture a wave (`engine.capture_tick` under ``ctx``), then one graph
    replay a token and no other `decode_step` call (the warm tick and the
    capture make the wave's two); the tokens ``want_toks`` (the eager
    waves', stacked as `_greedy_waves` stacks them) bit for bit. Returns
    the counts and the launches of the runs by kernel."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import engine

    _zero(launch.KERNELS)
    with torch.no_grad(), \
            counting_calls(engine, "decode_step") as calls, \
            counting_calls(engine, "capture_tick") as captures, \
            counting_calls(torch.cuda.CUDAGraph, "replay") as replays:
        got = torch.cat([engine.generate(
            cfg, params, _wave_prompts(torch, dev, w), max_new=LM_MAX_NEW,
            max_len=LM_MAX_LEN, mode="w1a8_eval", ctx=ctx).T
            for w in range(SHARD_WAVES)])
        torch.cuda.synchronize()
    launches = {k: v for k, v in launch.launch_counts().items() if v}
    if not torch.equal(got, want_toks) or captures[0] != SHARD_WAVES or \
            calls[0] != 2 * SHARD_WAVES or \
            replays[0] != SHARD_WAVES * (LM_MAX_NEW - 1):
        raise AssertionError(
            f"generate under a ShardCtx (wire {ctx.a2a_quant}): tokens "
            f"equal {torch.equal(got, want_toks)}, {captures[0]} captures, "
            f"{calls[0]} decode_step calls, {replays[0]} replays")
    return {"tokens_equal": True, "captures": captures[0],
            "decode_step_calls": calls[0], "graph_replays": replays[0],
            "launches": launches}


def _sharded_tick_parity(torch, dev, cfg, params, ctx, sampled: bool
                         ) -> dict:
    """Phase 15a: the tick under ``ctx`` captured once (`engine.
    capture_tick`; greedy, or TICK_TEMPS with a generator from SEED where
    ``sampled``) and replayed SHARD_TICKS times, each replay against an
    eager `decode_step(ctx=)` and `sample_tokens` on clones of the state
    and of the generator: ``last_tok`` and every cache leaf bit for bit,
    the generator where the eager draws leave its clone, and the replay's
    launches (what `_build.Graph` credits) the eager step's."""
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import tree_items, tree_leaves
    from repro_torch.serve.engine import (capture_tick, clone_generator,
                                          clone_state, decode_step, prefill,
                                          sample_tokens)

    temp = torch.tensor(TICK_TEMPS if sampled else (0.0,) * LM_SLOTS,
                        dtype=torch.float32, device=dev)
    gen = None
    if sampled:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
    compared, replay = 0, None
    with torch.no_grad():
        logits, cache = prefill(cfg, params, _wave_prompts(torch, dev, 0),
                                max_len=LM_MAX_LEN, mode="w1a8_eval",
                                ctx=ctx)
        state = {"cache": cache, "last_tok": sample_tokens(logits, temp, gen),
                 "temp": temp}
        graph = capture_tick(cfg, params, state, gen, mode="w1a8_eval",
                             ctx=ctx)
        for t in range(SHARD_TICKS):
            snap, twin = clone_state(state), clone_generator(gen)
            before = _symbol_counts(_build)
            logits, want = decode_step(cfg, params, snap["cache"],
                                       snap["last_tok"][:, None],
                                       mode="w1a8_eval", ctx=ctx)
            want_tok = sample_tokens(logits, snap["temp"], twin)
            torch.cuda.synchronize()
            eager = {k: n - before[k] for k, n in
                     _symbol_counts(_build).items() if n != before[k]}
            before = _symbol_counts(_build)
            graph.replay()
            torch.cuda.synchronize()
            replay = {k: n - before[k] for k, n in
                      _symbol_counts(_build).items() if n != before[k]}
            if replay != eager:
                raise AssertionError(f"sharded tick {t}: replay launches "
                                     f"{replay}, eager {eager}")
            pairs = list(zip(tree_items(state["cache"]), tree_leaves(want)))
            for (path, g), x in pairs + [(("last_tok", state["last_tok"]),
                                          want_tok)]:
                if not torch.equal(g, x):
                    raise AssertionError(f"sharded tick {t} (sampled "
                                         f"{sampled}): {path} differs from "
                                         f"the eager step")
                compared += 1
            if sampled and not torch.equal(gen.get_state(),
                                           twin.get_state()):
                raise AssertionError(f"sharded tick {t}: the generator "
                                     f"moved otherwise")
    return {"ticks": SHARD_TICKS, "tensors_compared": compared,
            "launches_per_replay": replay}


def _replay_fn(torch, dev, cfg, params, ctx):
    """The greedy tick under ``ctx`` (None: local) captured after a
    prefill of wave 0: a closure that replays its graph (each replay
    advances the state) and holds the state, whose tensors the graph
    reads and writes."""
    from repro_torch.serve.engine import capture_tick, prefill
    with torch.no_grad():
        logits, cache = prefill(cfg, params, _wave_prompts(torch, dev, 0),
                                max_len=LM_MAX_LEN, mode="w1a8_eval",
                                ctx=ctx)
        state = {"cache": cache,
                 "last_tok": torch.argmax(logits, -1).to(torch.int32),
                 "temp": torch.zeros((LM_SLOTS,), device=dev)}
        graph = capture_tick(cfg, params, state, None, mode="w1a8_eval",
                             ctx=ctx)

    def replay():
        graph.replay()
        return state
    return replay


def sharded_serve(torch, dev, mesh, smi: str) -> tuple:
    """Phase 15a: mixtral-8x7b at full width cut to SHARD_SERVE_LAYERS
    layers (phases 12 and 19 serve it at full depth), packed, served
    greedy (prefill and 15 decode steps, two waves of LM_SLOTS) under a
    `ShardCtx` on the (1, 1) mesh with the uint8 wire off and on, against
    the local path: off, every step's logits and tokens bit for bit; on,
    bit for bit against the local path with its expert outputs rounded
    through bf16. Launches counted over the sharded runs; a decode step's
    launches. For each wire, `generate(ctx=)` (`_sharded_generate`: a
    graph replay a token, the eager waves' tokens bit for bit) and the
    replayed tick greedy and sampled against the eager one
    (`_sharded_tick_parity`; a replay's launches an eager step's). The
    eager step's and the tick replay's CUDA-event ms local, wire off and
    on, in turns (local, its replay, off, its replay, on, its replay,
    then back). No torch.profiler trace: traces of the sharded step lost
    their device records on the card (every try)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve as launch
    from repro_torch.models import moe
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.serve import init_packed_lm

    cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                              num_layers=SHARD_SERVE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    packed = init_packed_lm(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    local = _greedy_waves(torch, dev, cfg, packed, None)
    with _bf16_return_leg(torch, moe):
        local_bf16 = _greedy_waves(torch, dev, cfg, packed, None)
    out = {"arch": MOE_ARCH, "layers": cfg.num_layers, "init_s": init_s,
           "steps": SHARD_WAVES * LM_MAX_NEW}
    counts, replay_counts = {}, {}
    steps = {"local": _decode_step_fn(torch, dev, cfg, packed, None),
             "local_replay": _replay_fn(torch, dev, cfg, packed, None)}
    for wire in (False, True):
        ctx = ShardCtx(mesh, ("data",), "model", "data", a2a_quant=wire)
        _zero(launch.KERNELS)
        logits, toks = _greedy_waves(torch, dev, cfg, packed, ctx)
        torch.cuda.synchronize()
        for k, v in launch.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        want_logits, want_toks = local_bf16 if wire else local
        if not (torch.equal(logits, want_logits) and
                torch.equal(toks, want_toks)):
            raise AssertionError(
                f"{MOE_ARCH} under a ShardCtx, wire {'on' if wire else 'off'}"
                f": logits off by {float((logits - want_logits).abs().max())}"
                f", tokens equal {bool(torch.equal(toks, want_toks))}")
        key = "wire_on" if wire else "wire_off"
        steps[key] = _decode_step_fn(torch, dev, cfg, packed, ctx)
        _zero(launch.KERNELS)
        steps[key]()
        torch.cuda.synchronize()
        per_step = {k: v for k, v in launch.launch_counts().items() if v}
        if per_step.get(GROUPED) != 3 * cfg.num_layers:
            raise AssertionError(f"{MOE_ARCH} sharded decode step: {per_step}"
                                 f", want {3 * cfg.num_layers} grouped")
        gen_rec = _sharded_generate(torch, dev, cfg, packed, ctx,
                                    want_toks)
        for k, v in gen_rec.pop("launches").items():
            replay_counts[k] = replay_counts.get(k, 0) + v
        parity = {name: _sharded_tick_parity(torch, dev, cfg, packed, ctx,
                                             name == "sampled")
                  for name in ("greedy", "sampled")}
        per_replay = parity["greedy"]["launches_per_replay"]
        if per_replay != per_step:
            raise AssertionError(f"{MOE_ARCH} sharded tick replay: "
                                 f"{per_replay}, an eager step {per_step}")
        out[key] = {"launches_per_decode_step": per_step,
                    "launches_per_replay": per_replay,
                    "generate": gen_rec, "tick_parity": parity}
        steps[key + "_replay"] = _replay_fn(torch, dev, cfg, packed, ctx)
    order = ("local", "local_replay", "wire_off", "wire_off_replay",
             "wire_on", "wire_on_replay")
    ms = {key: [] for key in steps}
    for key in order + order[::-1]:
        ms[key].append(cuda_ms(torch, steps[key], reps=3, n=3))
    for key in ("local", "wire_off", "wire_on"):
        out.setdefault(key, {}).update(decode_step_ms=ms[key],
                                       replay_ms=ms[key + "_replay"])
    # the replays' device busy (a trace of the eager sharded step loses its
    # device records); the popcount records a replay: 2-D and grouped
    popcount = int(sum(v for k, v in out["wire_off"][
        "launches_per_replay"].items() if k != DECODE))
    for key in ("local", "wire_off", "wire_on"):
        prof = step_profile(torch, steps[key + "_replay"], popcount)
        out[key]["replay_profile"] = {k: prof[k] for k in (
            "device_busy_ms", "wall_ms", "idle_share", "device_records",
            "device_timing")}
    wire_gap = float((local_bf16[0] - local[0]).abs().max())
    del packed, steps
    gc.collect()
    torch.cuda.empty_cache()

    def timed(key, what="decode_step_ms"):
        return " and ".join(f"{m:.3f}" for m in out[key][what])

    print(f"[sharded] (a) {MOE_ARCH} full width, {cfg.num_layers} layers, "
          f"packed (init {init_s:.1f} s), under a ShardCtx on (data 1, "
          f"model 1), {out['steps']} greedy steps at slots {LM_SLOTS}: wire "
          f"off = local path bit for bit (logits, tokens); wire on = local "
          f"path with bf16 expert outputs bit for bit (it moves the logits "
          f"up to {wire_gap:.6g} from the unrounded path); a decode step "
          f"{out['wire_off']['launches_per_decode_step']}; decode step ms "
          f"(CUDA events, in turns) local {timed('local')}, wire off "
          f"{timed('wire_off')}, wire on {timed('wire_on')} ({smi})",
          flush=True)
    local_busy = out["local"]["replay_profile"]["device_busy_ms"]
    for key in ("wire_off", "wire_on"):
        rec = out[key]
        print(f"[sharded] (a) {MOE_ARCH} as one CUDA graph replay a tick "
              f"under the ShardCtx, {key.replace('_', ' ')}: generate's "
              f"{SHARD_WAVES} waves x {LM_MAX_NEW} tokens equal the eager "
              f"waves' bit for bit ({rec['generate']['captures']} captures,"
              f" {rec['generate']['graph_replays']} CUDAGraph.replay calls,"
              f" {rec['generate']['decode_step_calls']} decode_step calls); "
              f"the replayed tick greedy and sampled == the eager tick on "
              f"clones bit for bit ({SHARD_TICKS} ticks each, "
              f"{rec['tick_parity']['greedy']['tensors_compared']} + "
              f"{rec['tick_parity']['sampled']['tensors_compared']} "
              f"tensors: last_tok and every cache leaf); launches a replay "
              f"{rec['launches_per_replay']} == an eager step's; tick "
              f"replay ms {timed(key, 'replay_ms')} against eager "
              f"{timed(key)} and the local replay "
              f"{timed('local', 'replay_ms')} (CUDA events, in turns); "
              f"device busy a replay "
              f"{_num(rec['replay_profile']['device_busy_ms'], '.4f')} ms "
              f"against the local replay's {_num(local_busy, '.4f')}, "
              f"{_num(rec['replay_profile']['device_records'], '.1f')} "
              f"records ({rec['replay_profile']['device_timing']}) ({smi})",
              flush=True)
    out["wire_logit_gap"] = wire_gap
    return out, counts, replay_counts


def sharded_train_step_check(torch, np, dev, mesh, smi: str) -> dict:
    """Phase 15b: mixtral-8x7b at full width cut to SHARD_TRAIN_LAYERS
    layers, ``w1a8_train``, B LM_TRAIN_BATCH × S LM_TRAIN_SEQ, SGD-M with
    no clip (its moment after a step is the gradient): the one-device
    `make_train_step` first, its quantizer inputs recorded and its
    gradients moved to the host, then `make_train_step(ctx=)` on the (1, 1)
    mesh from `shard_tree` of the same params, codes forced to the first
    run's (`train.ties`): loss within SHARD_LOSS_TOL relative, every leaf
    within SHARD_GRAD_TOL·max|g|; then SHARD_TIMED_STEPS sharded steps
    timed (CUDA events) and the peak memory."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import pipeline as data
    from repro_torch.dist import sharding
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import layers, moe
    from repro_torch.models.transformer import (ShardCtx, count_lm_params,
                                                init_lm_params, tree_items)
    from repro_torch.optim import sgdm
    from repro_torch.train import ties
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                              num_layers=SHARD_TRAIN_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_lm_params(cfg, gen, device=dev)
    n_params = count_lm_params(params)
    ds = data.make_lm_dataset(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                              seed=SEED)
    batch = make_batch_fn(cfg, ds, dev)(0)
    opt = sgdm(SHARD_LR)
    paths = [p for p, _ in tree_items(params)]
    one = make_train_step(cfg, opt, remat=False, max_grad_norm=SHARD_NO_CLIP)
    with contextlib.ExitStack() as stack:
        recs = [stack.enter_context(ties.record("lsq_fake_quant",
                                                module=mod))
                for mod in (layers, moe)]
        stepped, state, metrics = one(params, opt[0](params), batch)
    want_loss = float(metrics["loss"])
    want = [g.cpu() for _, g in tree_items(state["m"])]
    del stepped, state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    ctx = ShardCtx(mesh, ("data",), "model", "data")
    p = sharding.shard_tree(params, cfg, mesh)   # at (1, 1): the tree itself
    del params
    s = sharding.shard_tree(opt[0](p), cfg, mesh)
    step = make_train_step(cfg, opt, remat=False, max_grad_norm=SHARD_NO_CLIP,
                           ctx=ctx)
    with contextlib.ExitStack() as stack:
        counts = [stack.enter_context(ties.forced(rec, "lsq_fake_quant",
                                                  module=mod))
                  for rec, mod in zip(recs, (layers, moe))]
        p, s, metrics = step(p, s, batch)
    del recs
    loss = float(metrics["loss"])
    errs = {}
    for path, (_, g), w in zip(paths, tree_items(s["m"]), want):
        w = w.to(dev)               # one leaf back on the card at a time
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        errs[path] = err / scale if scale > 0 else err
    del want, w
    worst = max(errs, key=errs.get)
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    if not (loss_rel <= SHARD_LOSS_TOL and errs[worst] <= SHARD_GRAD_TOL):
        raise AssertionError(f"sharded step: loss rel {loss_rel}, worst leaf "
                             f"{worst} {errs[worst]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(SHARD_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p, s, metrics = step(p, s, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    del p, s, metrics
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"arch": MOE_ARCH, "layers": SHARD_TRAIN_LAYERS,
           "params": n_params, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "loss": loss, "loss_rel_err": loss_rel, "worst_leaf": worst,
           "max_grad_rel_err": errs[worst],
           "codes_forced": sum(map(sum, counts)),
           "quantizer_calls": sum(map(len, counts)),
           "ms_per_step": ms[1:], "tokens_per_s": tokens / (
               statistics.mean(ms[1:]) / 1e3),
           "peak_memory_bytes": peak}
    print(f"[sharded] (b) {MOE_ARCH} full width, {SHARD_TRAIN_LAYERS} "
          f"layers ({n_params / 1e9:.3f} G params), B {LM_TRAIN_BATCH} x S "
          f"{LM_TRAIN_SEQ}, SGD-M: make_train_step(ctx=) on (1, 1) against "
          f"the one-device step: loss rel {loss_rel:.3g} (tol "
          f"{SHARD_LOSS_TOL}), worst leaf {worst} {errs[worst]:.3g}·max|g| "
          f"(tol {SHARD_GRAD_TOL}); {rec['codes_forced']} codes forced over "
          f"{rec['quantizer_calls']} quantizer calls; sharded steps "
          f"{', '.join(f'{m:.2f}' for m in ms[1:])} ms (CUDA events), "
          f"{rec['tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    return rec


def sharded_launcher(torch, dev, mesh, smi: str) -> dict:
    """Phase 15c: ``--arch mixtral-8x7b --reduced --production-mesh
    --steps SHARD_LAUNCH_STEPS --ckpt-dir build/ckpt_phase15`` through
    `launch.train.train(args, dev, mesh)` on the (1, 1) mesh; its
    checkpoint restored whole and elastically onto the mesh, bit for bit;
    the one-device launcher resumes it (``--steps 3``). Then ``torchrun
    --nproc-per-node 1 -m repro_torch.launch.train --production-mesh``
    must exit non-zero naming the 256 ranks it needs."""
    import os
    import shutil

    from repro_torch import configs
    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.dist import sharding
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import init_lm_params, tree_items

    d = ROOT / "build" / "ckpt_phase15"
    shutil.rmtree(d, ignore_errors=True)
    base = ["--arch", MOE_ARCH, "--reduced", "--ckpt-dir", str(d)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        record = launch_train.train(launch_train.parse_args(
            base + ["--production-mesh", "--steps",
                    str(SHARD_LAUNCH_STEPS)]), dev, mesh)
        if not (record["sharded"] and record["backend"] == "nccl" and
                record["steps"] == SHARD_LAUNCH_STEPS and
                latest_step(str(d)) == SHARD_LAUNCH_STEPS):
            raise AssertionError(f"sharded launcher: {record}")
        cfg = configs.get_reduced(MOE_ARCH)
        meta = init_lm_params(cfg, None, device="meta")
        template = {"params": meta,
                    "opt_state": launch_train.OPTIMIZERS["adamw"](0.1)[0](
                        meta)}
        whole, _ = restore_checkpoint(str(d), SHARD_LAUNCH_STEPS, template,
                                      device=dev)
        held, _ = restore_checkpoint(
            str(d), SHARD_LAUNCH_STEPS, template, device=dev,
            shardings=sharding.tree_shardings(template, cfg, mesh),
            mesh=mesh)
        if not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_items(whole), tree_items(held))):
            raise AssertionError("elastic restore onto (1, 1) differs from "
                                 "the whole restore")
        again = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *base,
             "--steps", str(SHARD_LAUNCH_STEPS + 1)], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        lines = again.stdout.strip().splitlines()
        if again.returncode or lines[0] != (
                f"[resume] restored step {SHARD_LAUNCH_STEPS} from {d}") or \
                json.loads(lines[-1])["start_step"] != SHARD_LAUNCH_STEPS:
            raise AssertionError(f"one-device resume: {again.returncode} "
                                 f"{lines} {again.stderr[-2000:]}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    refused = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
         "--arch", MOE_ARCH, "--reduced", "--production-mesh", "--steps",
         "1"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    said = refused.stdout + refused.stderr
    if refused.returncode == 0 or "needs 256 ranks" not in said:
        raise AssertionError(f"torchrun --production-mesh on one rank: exit "
                             f"{refused.returncode}: {said[-2000:]}")
    print(f"[sharded] (c) launcher --production-mesh on (1, 1) via train("
          f"args, dev, mesh): {SHARD_LAUNCH_STEPS} steps, backend "
          f"{record['backend']}, {_num(record['ms_per_step'], '.2f')} ms a "
          f"step; checkpoint restored whole = elastic onto the mesh bit for "
          f"bit; the one-device launcher resumed it at step "
          f"{SHARD_LAUNCH_STEPS}; torchrun --nproc-per-node 1 "
          f"--production-mesh exit {refused.returncode}, naming 256 ranks "
          f"({smi})", flush=True)
    return {**record, "refused_exit": refused.returncode}


def sp_check(torch, dev, mesh, smi: str) -> dict:
    """Phase 15d: `sp_decode_attention` over the mesh's 'data' axis at
    jamba-1.5-large-398b's attention shapes, B SP_BATCH, one shard of
    SP_POSITIONS positions, against a plain full-softmax attention within
    SP_TOL; a cur_pos before the shard's first position gives finite
    zeros; CUDA-event ms against the bytes bound of reading K and V."""
    import math

    from repro_torch.device import full_f32
    from repro_torch.serve.sp import sp_decode_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    q = torch.randn((SP_BATCH, SP_HEADS, SP_HD), generator=gen, device=dev)
    kv = (SP_BATCH, SP_POSITIONS, SP_KV, SP_HD)
    k = torch.randn(kv, generator=gen, device=dev)
    v = torch.randn(kv, generator=gen, device=dev)
    pos = torch.arange(SP_POSITIONS, dtype=torch.int32,
                       device=dev).expand(SP_BATCH, -1)
    cur = torch.tensor([SP_POSITIONS - 1, 20000, 5, 32000],
                       dtype=torch.int32, device=dev)

    def plain(cur_pos):
        g = SP_HEADS // SP_KV
        with full_f32():
            qg = q.reshape(SP_BATCH, SP_KV, g, SP_HD)
            logits = torch.einsum("bkgd,btkd->bkgt", qg, k) / torch.tensor(
                math.sqrt(SP_HD), device=dev)
            valid = pos <= cur_pos[:, None]
            logits = torch.where(valid[:, None, None, :], logits, -math.inf)
            probs = torch.softmax(logits, dim=-1)
            return torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(
                SP_BATCH, SP_HEADS, SP_HD)

    with torch.no_grad():
        got = sp_decode_attention(mesh, "data", q, k, v, pos, cur)
        err = float((got - plain(cur)).abs().max())
        early = sp_decode_attention(mesh, "data", q, k, v, pos + SP_POSITIONS,
                                    torch.full_like(cur, 100))
        ms = cuda_ms(torch, lambda: sp_decode_attention(
            mesh, "data", q, k, v, pos, cur), reps=5, n=10)
    if not (err <= SP_TOL and bool(torch.isfinite(early).all())
            and not bool(early.any())):
        raise AssertionError(f"sp_decode_attention: {err} off the plain "
                             f"attention; empty shard finite zeros "
                             f"{bool(torch.isfinite(early).all())}")
    nbytes = 2 * k.numel() * 4 + pos.numel() * 4 + q.numel() * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    del q, k, v, pos
    torch.cuda.empty_cache()
    print(f"[sharded] (d) sp_decode_attention at {SP_HEADS} heads, {SP_KV} "
          f"KV heads, head dim {SP_HD}, B {SP_BATCH}, {SP_POSITIONS} "
          f"positions a shard: max_abs {err:.3g} against the plain attention"
          f" (tol {SP_TOL}); a shard past cur_pos gives finite zeros; "
          f"{ms:.4f} ms (CUDA events), bound {bound_ms:.4f} ms (bytes at "
          f"3.35 TB/s) ({smi})", flush=True)
    return {"max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
            "positions": SP_POSITIONS, "batch": SP_BATCH}


def drive_sharded(torch, np, dev, smi: str) -> dict:
    """Phase 15: on a one-rank NCCL group's (1, 1) mesh, (a)
    `sharded_serve`, (b) `sharded_train_step_check`, (c)
    `sharded_launcher`, (d) `sp_check`."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh = _shard_mesh(torch, "phase15_nccl")
    try:
        out = {"card": smi}
        out["serve"], out["launches"], out["replay_launches"] = \
            sharded_serve(torch, dev, mesh, smi)
        out["train_step"] = sharded_train_step_check(torch, np, dev, mesh,
                                                     smi)
        out["launcher"] = sharded_launcher(torch, dev, mesh, smi)
        out["sp"] = sp_check(torch, dev, mesh, smi)
    finally:
        dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t0
    return out


def sharded_summary(rec: dict) -> dict:
    """Phase 15's numbers for the `sharded` line and the JSON line."""
    serve, step = rec["serve"], rec["train_step"]
    return {
        "serve": {"arch": serve["arch"], "layers": serve["layers"],
                  "steps": serve["steps"],
                  **{k: serve[k]["decode_step_ms"]
                     for k in ("local", "wire_off", "wire_on")},
                  **{k + "_replay": serve[k]["replay_ms"]
                     for k in ("local", "wire_off", "wire_on")},
                  **{k + "_replay_busy": serve[k]["replay_profile"][
                      "device_busy_ms"]
                     for k in ("local", "wire_off", "wire_on")},
                  "launches_per_decode_step":
                      serve["wire_off"]["launches_per_decode_step"],
                  "launches_per_replay":
                      serve["wire_off"]["launches_per_replay"]},
        "train_step": {k: step[k] for k in (
            "arch", "layers", "params", "loss_rel_err", "max_grad_rel_err",
            "codes_forced", "ms_per_step", "tokens_per_s",
            "peak_memory_bytes")},
        "launcher": {k: rec["launcher"][k] for k in (
            "steps", "backend", "ms_per_step", "refused_exit")},
        "sp": rec["sp"], "wall_s": rec["wall_s"]}


# ---------------------------------------------------------------------------
# Phase 16: the tooling on the card (tables, examples, the dry run's counts)
# ---------------------------------------------------------------------------

TABLES_PATH = "tables"
CAL_MEM_RANGE = (0.5, 2.0)      # predicted / measured peak memory
DRY_CELL = ("mixtral-8x7b", "decode_32k")   # a production cell, (16, 16)


def tables_kernels(torch, smi: str) -> tuple:
    """Phase 16a: `launch.tables.kernels` on the card, every launch count
    zeroed before and read after; returns (its rows, its launches)."""
    from repro_torch.launch import serve as launch
    from repro_torch.launch import tables
    _zero(launch.KERNELS)
    rows = tables.kernels("cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch.launch_counts().items() if v}
    want = (tables.CUDA_ITERS + 1) * len(tables.KERNEL_SHAPES)
    if counts != {"w1a8_matmul_popcount": want}:
        raise AssertionError(f"kernel suite launches {counts}, want "
                             f"{want} popcount matmuls")
    for tag, value, note in rows:
        print(f"[tooling] (a) {tag},{value},\"{note}\"", flush=True)
    return rows, counts


def run_example(module: str, smi: str, *args) -> tuple:
    """``python -m repro_torch.launch.<module>`` in a process of its own
    on the card: exit 0; (its JSON line, wall s)."""
    import os
    cmd = [sys.executable, "-m", f"repro_torch.launch.{module}", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"{module} exited {out.returncode}: "
                             f"{out.stdout[-2000:]} {out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"[tooling] (b) {module}: {line}", flush=True)
    return json.loads(lines[-1]), wall_s


def examples(smi: str) -> dict:
    """Phase 16b: quickstart and serve_lm on the card; quickstart's two
    compare rows inside their envelopes, serve_lm's greedy requests' tokens
    equal to the same script's on the CPU."""
    from repro_torch.launch import serve_lm
    qs, qs_s = run_example("quickstart", smi)
    if not (qs["linear_in_envelope"] and qs["detector_in_envelope"]
            and qs["lm_finite"]):
        raise AssertionError(f"quickstart outside its envelopes: {qs}")
    card, lm_s = run_example("serve_lm", smi)
    cpu = serve_lm.run(device="cpu")
    for rid in card["greedy"]:
        got, want = card["requests"][str(rid)], cpu["requests"][rid]
        if got != want:
            raise AssertionError(f"serve_lm request {rid}: card {got}, "
                                 f"cpu {want}")
    print(f"[tooling] (b) quickstart exit 0 in {qs_s:.1f} s: linear "
          f"within 1 LSB of {0.05} {qs['linear']['within_1lsb']:.4f}, "
          f"detector within 1 LSB of {0.02} "
          f"{qs['detector']['within_1lsb']:.4f}; serve_lm exit 0 in "
          f"{lm_s:.1f} s, {len(card['greedy'])} greedy requests equal to "
          f"the CPU's ({smi})", flush=True)
    return {"quickstart": {k: qs[k] for k in (
        "linear", "detector", "lm_logits_shape", "wall_s")},
        "quickstart_process_s": qs_s, "serve_lm_process_s": lm_s,
        "serve_lm_tokens": card["tokens"], "serve_lm_wall_s": card["wall_s"]}


def calibrate(torch, dev, smi: str, kind: str) -> dict:
    """Phase 16c, one cell on the local path: phase 13's train step or
    phase 10's packed decode step, traced by the dry run's `Counter` on
    ``meta`` and under ``FakeTensorMode``, then run on the card under the
    same counter: FLOPs by dtype equal; the predicted peak within
    CAL_MEM_RANGE of ``max_memory_allocated``; the costs bound (each
    dtype's FLOPs at its peak, `launch.costs.analytic_bytes` at the HBM
    rate) at most the CUDA-event ms."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import costs
    from repro_torch.launch import dryrun as dr

    if kind == "train":
        arch = LM_TRAIN_ARCH
        cfg = dataclasses.replace(configs.get_config(arch),
                                  num_layers=LM_TRAIN_LAYERS)
        spec = ShapeSpec("phase13", "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH)
        micro = LM_TRAIN_MICRO

        def build(device, generator=None):
            return dr.build_train_cell(arch, spec, None, microbatches=micro,
                                       cfg=cfg, optimizer="adamw",
                                       device=device, generator=generator)
    else:
        arch = LM_ARCH
        cfg = configs.get_config(arch)
        spec = ShapeSpec("phase10", "decode", LM_MAX_LEN, LM_SLOTS)
        micro = 1

        def build(device, generator=None):
            return dr.build_decode_cell(arch, spec, None, cfg=cfg,
                                        dtype=torch.float32, device=device,
                                        generator=generator)
    t0 = time.perf_counter()
    meta_cell, meta, _ = dr.trace(build)
    _, fake, _ = dr.trace(build, fake=True)
    trace_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        cell = build(dev, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    card, _ = dr.count(cell)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    ms = cuda_ms(torch, cell.run, reps=3, n=2)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    if not meta.flops == fake.flops == card.flops:
        raise AssertionError(f"{kind}: FLOPs by dtype meta {meta.flops}, "
                             f"fake {fake.flops}, card {card.flops}")
    ana = costs.analytic_bytes(cfg, spec, meta_cell.params, 1,
                               microbatches=micro, model_axis=1)
    terms = dr.roofline_terms(meta.flops, ana, 0.0)
    bound_ms = 1e3 * max(terms["t_compute_s"], terms["t_memory_s"])
    ratio = meta.peak / peak
    print(f"[tooling] (c) {kind} ({arch}, {cfg.num_layers} layers, "
          f"{spec.global_batch} × {spec.seq_len}): FLOPs by dtype "
          f"{meta.flops} traced on meta and fake = the card's; peak "
          f"predicted {meta.peak / 2 ** 30:.3f} GiB "
          f"{dict(sorted(meta.peak_by.items()))}, measured "
          f"{peak / 2 ** 30:.3f} GiB (ratio {ratio:.4f}); bound "
          f"{bound_ms:.4f} ms ({terms['bottleneck']}) against "
          f"{ms:.2f} ms measured (CUDA events; bound/measured "
          f"{bound_ms / ms:.4f}); traced in {trace_s:.1f} s ({smi})",
          flush=True)
    if not CAL_MEM_RANGE[0] <= ratio <= CAL_MEM_RANGE[1]:
        raise AssertionError(f"{kind}: predicted peak {meta.peak} against "
                             f"{peak} measured")
    if bound_ms > ms:
        raise AssertionError(f"{kind}: bound {bound_ms} ms above the "
                             f"measured {ms} ms")
    return {"arch": arch, "layers": cfg.num_layers,
            "flops_by_dtype": meta.flops,
            "predicted_peak_bytes": meta.peak,
            "predicted_by_category": meta.peak_by,
            "measured_peak_bytes": peak, "memory_ratio": ratio,
            "bound_ms": bound_ms, "bound_by": terms["bottleneck"],
            "ms": ms, "bound_over_measured": bound_ms / ms,
            "trace_s": trace_s}


def dry_cell(smi: str) -> dict:
    """Phase 16d: the dry run's production cell DRY_CELL on the (16, 16)
    mesh, traced on this machine's host."""
    from repro_torch.launch import dryrun as dr
    t0 = time.perf_counter()
    rec = dr.run_cell(*DRY_CELL, multi_pod=False)
    wall = time.perf_counter() - t0
    if rec["status"] != "ok" or not rec["cost"]["flops"]:
        raise AssertionError(f"dry run of {DRY_CELL}: {rec}")
    print(f"[tooling] (d) {' '.join(DRY_CELL)} at 16x16: trace_s "
          f"{rec['trace_s']} ({wall:.1f} s with the build), FLOPs "
          f"{rec['cost']['flops_by_dtype']}, peak "
          f"{rec['memory']['peak_bytes'] / 2 ** 30:.2f} GiB, fits "
          f"{rec['fits']}, reference layout "
          f"{rec['reference_layout_bytes'] / 2 ** 30:.2f} GiB, "
          f"{rec['roofline']['bottleneck']}-bound (host of {smi})",
          flush=True)
    return {k: rec[k] for k in ("trace_s", "fits", "reference_layout_bytes",
                                "roofline")} | {
        "peak_bytes": rec["memory"]["peak_bytes"], "wall_s": wall}


def drive_tooling(torch, dev, smi: str) -> dict:
    """Phase 16: (a) `tables_kernels`, (b) `examples`, (c) `calibrate`
    the train and decode cells, (d) `dry_cell`."""
    t0 = time.perf_counter()
    out = {"card": smi}
    out["kernels_suite"], out["launches"] = tables_kernels(torch, smi)
    out["examples"] = examples(smi)
    out["calibration"] = {kind: calibrate(torch, dev, smi, kind)
                          for kind in ("train", "decode")}
    out["dry_cell"] = dry_cell(smi)
    out["wall_s"] = time.perf_counter() - t0
    return out


def tooling_summary(rec: dict) -> dict:
    """Phase 16's numbers for the `tooling` line and the JSON line."""
    return {"kernels_suite": [list(r) for r in rec["kernels_suite"]],
            "launches": rec["launches"], "examples": rec["examples"],
            "calibration": {k: {key: v[key] for key in (
                "flops_by_dtype", "predicted_peak_bytes",
                "measured_peak_bytes", "memory_ratio", "bound_ms", "ms",
                "bound_over_measured")}
                for k, v in rec["calibration"].items()},
            "dry_cell": rec["dry_cell"], "wall_s": rec["wall_s"]}


# ---------------------------------------------------------------------------
# Phase 17: the production layout (tensor parallelism) on the card
# ---------------------------------------------------------------------------

TP_ARCH = "chatglm3-6b"        # (a) and (b): its packed projections, train_4k
TP_MODEL = 16                  # |model| of the production meshes
TP_CELL = ("chatglm3-6b", "train_4k", "16x16")  # the dry run's record
TP_HBM = 80e9                  # one card's memory, the dry run's fits bound
TP_SUM_ROUNDINGS = 32          # 16 partial outputs and 15 f32 additions
TP_PLAN_ARCH = "mixtral-8x7b"  # (c): phase 15's arch at |model| = 1
# the cell's peak with every non-MoE leaf gathered whole for the step, the
# layout before tensor parallelism (PERF.md §6)
TP_OLD_PEAK_GIB = 89.2


class _RankMesh:
    """A shape-only stand-in of a ('data', 'model') mesh at one rank's
    coordinates: `dist.sharding.shard_tree` reads the axis sizes and the
    rank's coordinate on each axis, nothing else."""

    def __init__(self, sizes: tuple, coords: tuple):
        self.axis_names = tuple(a for a, _ in sizes)
        self.shape = dict(sizes)
        self.coords = dict(zip(self.axis_names, coords))

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]


def tp_block_check(torch, np, dev, smi: str) -> list:
    """Phase 17a: chatglm3-6b's packed projections at |model| = 16, M =
    LM_SLOTS, through the port's tensor-parallel entry: one layer drawn
    from SEED and deployed (`serve.packed.deploy_lm`), rank r's blocks cut
    by `dist.sharding.shard_tree` at (data 0, model r), each run by
    `layers.packed_linear(tp=)` under rank r's `TPPlan` over a one-rank
    group (its sum over the group is the rank's partial). A column block
    is bit for bit the same columns of the whole call; a row block's
    int32 sums (the kernel on the block's codes and words, steps and α at
    1) add up over the 16 blocks to the whole's exactly, and the 16
    partial outputs sum to the whole's within TP_SUM_ROUNDINGS roundings
    of Σ|y_r|; a projection the plan keeps whole is ``down`` alone, its
    block the whole leaf. The kernel call of rank 0's block and of the
    whole, CUDA-event and device ms, beside the block's bound. These
    launches compare, so they are not counted on a path."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core.quant import quantize_act
    from repro_torch.dist.sharding import TPPlan, shard_tree
    from repro_torch.core import packing
    from repro_torch.device import full_f32
    from repro_torch.kernels.w1a8_matmul import geometry
    from repro_torch.kernels.w1a8_matmul import ref as mm_ref
    from repro_torch.kernels.w1a8_matmul.ops import fold_operands, w1a8_matmul
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.tile_sweep import pr15_route
    from repro_torch.models.layers import POPCOUNT, packed_linear
    from repro_torch.models.transformer import init_lm_params, stage
    from repro_torch.serve.packed import deploy_lm

    cfg = dataclasses.replace(configs.get_config(TP_ARCH), num_layers=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    whole_tree = deploy_lm(init_lm_params(cfg, gen, device=dev))
    sizes = (("data", TP_MODEL), ("model", TP_MODEL))
    blocks_of = [shard_tree(whole_tree, cfg, _RankMesh(sizes, (0, r)))
                 for r in range(TP_MODEL)]

    def leaves(tree, name: str) -> dict:
        slot = stage(tree["slots"], 0)[0]
        return slot["attn" if name.startswith("w") else "mlp"][name]

    def kernel(pp: dict, codes, kk: int):
        st = pp["act_step"][:kk]
        return lambda: w1a8_matmul(codes, pp["w_packed"], st, pp["alpha"],
                                   torch.zeros_like(pp["alpha"]), k=kk,
                                   config=POPCOUNT)
    rng = np.random.default_rng(SEED)
    m, rows = LM_SLOTS, []
    floor = floor_graph_ms(torch, dev)

    def kernel_alone(torch, pp: dict, codes, kk: int) -> dict:
        """The block's launch alone (codes folded once, Div carrying the
        step): bit for bit with its plain version; device ms from graph
        replays in turns with the PR-15 tile, the plain version's and f32
        ``torch.matmul``'s ms, the floor."""
        folded, dv = fold_operands(codes, pp["act_step"][:kk], pp["alpha"])
        zeros = torch.zeros_like(pp["alpha"])

        def run():
            return w1a8_matmul(folded, pp["w_packed"], None, dv, zeros, k=kk,
                               config=POPCOUNT)

        def plain():
            return mm_ref.w1a8_matmul_popcount_ref(folded, pp["w_packed"],
                                                   kk, dv, zeros)
        _exact(torch, run(), plain(), "TP block alone")
        xq = folded.to(torch.float32)
        signs = packing.unpack_signs(pp["w_packed"], kk, dtype=torch.float32)

        def library():
            with full_f32():
                return torch.matmul(xq, signs)
        new, old = turns_ms(torch, run, pr15_route)
        return {"route": "decode" if geometry.decodes(m, kk) else "pr15",
                "kernel_device_ms": new, "pr15_device_ms": old,
                "plain_ms": cuda_ms(torch, plain, reps=2, n=2),
                "library_ms": cuda_ms(torch, library),
                "library_device_ms": graph_ms(torch, library),
                "floor_device_ms": floor}
    with dr.fake_world(1):
        plans = [TPPlan(cfg, sizes, "model", dist.group.WORLD, TP_MODEL, r)
                 for r in range(TP_MODEL)]
        for name, (k, n) in lm_projections(cfg).items():
            p = leaves(whole_tree, name)
            ps = [leaves(h, name) for h in blocks_of]
            projs = [plan.proj(name, k, n, packed=True) for plan in plans]
            kind = projs[0].kind
            if any(t.kind != kind for t in projs):
                raise AssertionError(f"{name}: the ranks' plans differ")
            # codes over the whole grid and both rails
            x = torch.from_numpy(rng.uniform(-16.0, 272.0, (m, k)).astype(
                np.float32)).to(dev) * p["act_step"]
            codes = quantize_act(x, p["act_step"]).to(torch.uint8)
            y = packed_linear(p, x)
            if kind == "whole":
                if name != "down" or any(
                        q["w_packed"].shape != p["w_packed"].shape
                        for q in ps):
                    raise AssertionError(f"{name} runs whole at |model| 16")
                rows.append({"what": name, "kind": kind, "whole": [m, k, n]})
                continue
            if kind == "col":
                kb, nb, err = k, n // TP_MODEL, 0.0
                for r in range(TP_MODEL):
                    got = packed_linear(ps[r], x, projs[r])
                    if ps[r]["w_packed"].shape[-1] != nb or not torch.equal(
                            got, y[:, r * nb:(r + 1) * nb]):
                        raise AssertionError(f"{name} column block {r} "
                                             f"differs from the whole call")
                block = kernel(ps[0], codes, k)
                blk = (ps[0], codes, k)
            else:
                kb, nb = k // TP_MODEL, n
                cs = [codes[:, r * kb:(r + 1) * kb].contiguous()
                      for r in range(TP_MODEL)]
                ones = {key: torch.ones_like(p[key])
                        for key in ("act_step", "alpha")}
                ints = kernel({**p, **ones}, codes, k)()
                total = torch.stack([kernel({**ps[r], **ones}, cs[r], kb)()
                                     for r in range(TP_MODEL)]).to(
                    torch.int64).sum(0)
                if not torch.equal(total, ints.to(torch.int64)):
                    raise AssertionError(f"{name}: the row blocks' int32 "
                                         f"sums do not add up to the whole's")
                ys = torch.stack([packed_linear(
                    ps[r], x[:, r * kb:(r + 1) * kb], projs[r])
                    for r in range(TP_MODEL)])
                err = float((ys.sum(0) - y).abs().max())
                tol = TP_SUM_ROUNDINGS * 2.0 ** -24 * float(
                    ys.abs().sum(0).max())
                if err > tol:
                    raise AssertionError(f"{name}: the row blocks' f32 sum "
                                         f"is {err} off the whole, above "
                                         f"{tol}")
                block = kernel(ps[0], cs[0], kb)
                blk = (ps[0], cs[0], kb)
            whole = kernel(p, codes, k)
            alone = kernel_alone(torch, *blk)
            nbytes = m * kb + 4 * (kb // 32) * nb + 8 * nb + 4 * m * nb
            bound_ms, bound_by = bound(nbytes, 2 * m * nb * kb,
                                       INT8_OPS_PER_S)
            rows.append({
                "what": name, "kind": kind, "whole": [m, k, n],
                "block": [m, kb, nb], "max_abs_err": err,
                "ms": cuda_ms(torch, block),
                "whole_ms": cuda_ms(torch, whole),
                "device_ms": device_profile(torch, block, tries=2)[
                    "device_busy_ms"],
                "whole_device_ms": device_profile(torch, whole, tries=2)[
                    "device_busy_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by, **alone})
    del whole_tree, blocks_of
    gc.collect()
    torch.cuda.empty_cache()
    for r in rows:
        if r["kind"] == "whole":
            print(f"[tp] (a) {TP_ARCH} {r['what']} {r['whole']}: whole by "
                  f"the plan (its sign words do not split over "
                  f"{TP_MODEL})", flush=True)
            continue
        held = ("bit for bit the whole call" if r["kind"] == "col" else
                f"int32 sums add up exactly, f32 sum off "
                f"{r['max_abs_err']:.3g}")
        print(f"[tp] (a) {TP_ARCH} {r['what']} {r['kind']}-parallel "
              f"through packed_linear(tp=), block {r['block']} of "
              f"{r['whole']}: {held}; block {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}) against the whole "
              f"{r['whole_ms']:.4f} ms (device "
              f"{r['whole_device_ms']:.4f}); the block's launch alone, "
              f"{r['route']} route, device "
              f"{' '.join(f'{x:.5f}' for x in r['kernel_device_ms'])} "
              f"against the PR-15 tile "
              f"{' '.join(f'{x:.5f}' for x in r['pr15_device_ms'])} "
              f"(turns), plain {r['plain_ms']:.3f} ms, f32 torch.matmul "
              f"device {r['library_device_ms']:.5f}, floor "
              f"{r['floor_device_ms']:.5f}; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}) ({smi})", flush=True)
    return rows


def tp_decode(torch, dev, smi: str, blocks: list) -> dict:
    """Phase 17a': rank 0 of the (16, 16) mesh serving chatglm3-6b packed
    for real on the card (phase 10's LM_SLOTS rows a rank, max_len
    LM_MAX_LEN, f32), torch's ``fake`` backend standing in for the other
    255 ranks. Counts zeroed before a decode step and read after: each
    projection of the plan one popcount launch on the rank's block (of
    them the decode route's share, from the blocks' K in ``blocks``,
    phase 17a's records). Then the rank's tick on the cell's params,
    cache and ctx captured as one CUDA graph (`engine.capture_tick`): a
    replay's launches those of the eager step; the replay's and the eager
    step's CUDA-event ms in turns (replay, eager, eager, replay).

    No value is compared, of the step or of the replay: the ``fake``
    backend's collectives launch nothing and leave their outputs as they
    were allocated, so the TP sums and the vocabulary gather hand on
    whatever memory held, and only the rank's launches and times are the
    card's."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.dist.sharding import dp_axes
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.serve.engine import capture_tick

    spec = ShapeSpec("phase17", "decode", LM_MAX_LEN, LM_SLOTS * TP_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with dr.fake_world(TP_MODEL * TP_MODEL):
        mesh = make_production_mesh(device="cuda")
        cell = dr.build_decode_cell(TP_ARCH, spec, mesh, dtype=torch.float32,
                                    device=dev, generator=gen)
        cell.run()
        torch.cuda.synchronize()
        _zero(launch.KERNELS)
        cell.run()
        torch.cuda.synchronize()
        per_step = {k: v for k, v in launch.launch_counts().items() if v}
        # the cell's own tree, cache and ctx (`build_decode_cell`'s)
        params, cache = cell.held[0][0], cell.held[1][0]
        rows = cache["lengths"].shape[0]
        state = {"cache": cache,
                 "last_tok": torch.zeros((rows,), dtype=torch.int32,
                                         device=dev),
                 "temp": torch.zeros((rows,), device=dev)}
        graph = capture_tick(cell.cfg, params, state, None,
                             mode="w1a8_eval",
                             ctx=dr.make_ctx(cell.cfg, mesh, dp_axes(mesh)))
        _zero(launch.KERNELS)
        graph.replay()
        torch.cuda.synchronize()
        per_replay = {k: v for k, v in launch.launch_counts().items() if v}
        replay_ms = [cuda_ms(torch, graph.replay, reps=3, n=3)]
        eager_ms = [cuda_ms(torch, cell.run, reps=3, n=3) for _ in range(2)]
        replay_ms.append(cuda_ms(torch, graph.replay, reps=3, n=3))
        popcount = int(sum(v for k, v in per_step.items() if k != DECODE))
        prof = {"replay": step_profile(torch, graph.replay, popcount),
                "eager": step_profile(torch, cell.run, popcount)}
        _zero(launch.KERNELS)
        del cell, graph, state, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(TP_ARCH)
    ks = [(r["whole"] if r["kind"] == "whole" else r["block"])[1]
          for r in blocks] * cfg.num_layers
    want = with_decode_share({"w1a8_matmul_popcount": float(len(ks))}, ks)
    if per_step != want or per_replay != per_step:
        raise AssertionError(f"{TP_ARCH} TP decode step: {per_step}, a "
                             f"replay {per_replay}, want {want}")
    print(f"[tp] (a') {TP_ARCH} packed, rank 0 of (16, 16) on the card "
          f"(fake backend for the other ranks), {LM_SLOTS} rows: a decode "
          f"step {per_step} on the rank's blocks, a tick replay the same; "
          f"CUDA-event ms in turns: replay {replay_ms[0]:.3f}, eager "
          f"{eager_ms[0]:.3f}, eager {eager_ms[1]:.3f}, replay "
          f"{replay_ms[1]:.3f}; device busy replay "
          f"{_num(prof['replay']['device_busy_ms'], '.4f')} ms, eager "
          f"{_num(prof['eager']['device_busy_ms'], '.4f')} "
          f"({prof['replay']['device_timing']}, "
          f"{prof['eager']['device_timing']}) ({smi})", flush=True)
    return {"launches_per_decode_step": per_step,
            "launches_per_replay": per_replay, "decode_step_ms": eager_ms,
            "replay_ms": replay_ms,
            **{f"{k}_profile": {f: p[f] for f in (
                "device_busy_ms", "wall_ms", "idle_share", "device_records",
                "device_timing")} for k, p in prof.items()}}


def tp_train(torch, dev, smi: str) -> dict:
    """Phase 17b: rank 0 of the (16, 16) mesh training chatglm3-6b's
    train_4k cell for real on the card: full depth (28 layers), the
    rank's 16 rows × 4096 tokens in 8 microbatches, f32 AdamW, remat,
    every leaf the rank's block (drawn a leaf at a time), the ``fake``
    backend for the other 255 ranks (its all-gathers leave their outputs
    as allocated; only memory and time are read). Measured peak memory
    against the regenerated dry run's prediction for the cell and
    TP_HBM; one step's CUDA-event ms against the cell's t_compute."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape, mesh_name = TP_CELL
    recs = json.loads((ROOT / "src" / "repro_torch" / "results" /
                       "dryrun.json").read_text())
    rec = next(r for r in recs if (r["arch"], r["shape"], r["mesh"]) ==
               TP_CELL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with dr.fake_world(TP_MODEL * TP_MODEL):
        mesh = make_production_mesh(device="cuda")
        t0 = time.perf_counter()
        cell = dr.build_train_cell(arch, shape, mesh, device=dev,
                                   generator=gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cell.run()                                   # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cell.run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated(dev) - before
        del cell
    gc.collect()
    torch.cuda.empty_cache()
    predicted = rec["memory"]["peak_bytes"]
    t_compute_ms = 1e3 * rec["roofline"]["t_compute_s"]
    old = TP_OLD_PEAK_GIB
    print(f"[tp] (b) {arch} {shape} at {mesh_name}, rank 0 for real on the "
          f"card (28 layers, 16 rows × 4096 tokens, 8 microbatches, f32 "
          f"AdamW, remat; built in {build_s:.1f} s): peak "
          f"{peak / 2 ** 30:.2f} GiB measured against "
          f"{predicted / 2 ** 30:.2f} GiB predicted by the dry run (ratio "
          f"{peak / predicted:.3f}; {old} GiB in the old layout), under "
          f"{TP_HBM:.0e} B: {peak < TP_HBM}; a step {ms:.1f} ms (CUDA "
          f"events) against t_compute {t_compute_ms:.1f} ms ({smi})",
          flush=True)
    if peak >= TP_HBM:
        raise AssertionError(f"{arch} {shape}: peak {peak} B on one card")
    return {"cell": list(TP_CELL), "peak_bytes": peak,
            "predicted_peak_bytes": predicted,
            "peak_over_predicted": peak / predicted, "fits": peak < TP_HBM,
            "step_ms": ms, "t_compute_ms": t_compute_ms,
            "step_over_t_compute": ms / t_compute_ms, "build_s": build_s}


def tp_plan_one_rank() -> dict:
    """Phase 17c: the plan phase 15's ShardCtx ran at |model| = 1: each
    projection of mixtral-8x7b column- or row-parallel (its blocks the
    whole leaves), none whole, so phase 15's holds ran the new code."""
    from repro_torch import configs
    from repro_torch.dist.sharding import TPPlan

    cfg = configs.get_config(TP_PLAN_ARCH)
    plan = TPPlan(cfg, (("data", 1), ("model", 1)), "model", None, 1, 0)
    kinds = {name: plan.proj(name, k, n, packed).kind
             for packed in (False, True)
             for name, (k, n) in lm_projections(cfg).items()
             if name not in ("up", "gate", "down")}
    if set(kinds.values()) != {"col", "row"}:
        raise AssertionError(f"{TP_PLAN_ARCH} at |model| 1: {kinds}")
    print(f"[tp] (c) {TP_PLAN_ARCH} at |model| 1 (phase 15's mesh): "
          f"{kinds}, so phase 15 ran the plan's column- and row-parallel "
          f"paths on whole blocks", flush=True)
    return kinds


def drive_tp(torch, np, dev, smi: str) -> dict:
    """Phase 17: (a) `tp_block_check`, (a') `tp_decode`, (b) `tp_train`,
    (c) `tp_plan_one_rank`."""
    t0 = time.perf_counter()
    out = {"card": smi, "blocks": tp_block_check(torch, np, dev, smi)}
    out["decode"] = tp_decode(torch, dev, smi, out["blocks"])
    out["train"] = tp_train(torch, dev, smi)
    out["one_rank_plan"] = tp_plan_one_rank()
    out["wall_s"] = time.perf_counter() - t0
    return out


def tp_summary(rec: dict) -> dict:
    """Phase 17's numbers for the `tp` line and the JSON line."""
    return {"blocks": [{k: r.get(k) for k in (
        "what", "kind", "block", "ms", "device_ms", "whole_ms",
        "whole_device_ms", "bound_ms", "route", "kernel_device_ms",
        "pr15_device_ms", "plain_ms", "library_device_ms")}
        for r in rec["blocks"]],
        "decode": rec["decode"], "train": rec["train"],
        "wall_s": rec["wall_s"]}


# ---------------------------------------------------------------------------
# Phase 18: the launchers' gates on the card
# ---------------------------------------------------------------------------

# each workload's launcher arguments, run twice with --gate-bench
GATE_RUNS = {
    "detect": ["--buckets", "320", "--requests", "16", "--slots", "4",
               "--depth", "2"],
    "multires": ["--buckets", "256,320", "--requests", "8", "--slots", "4"],
    "lm": ["--reduced", "--packed", "--arch", LM_ARCH],
    "compose": ["--reduced"],
}
# (workload, committed keys scaled, record keys changed, the failure's
# first words or None for a pass): doctored against a measured record
GATE_DOCTORED = (
    ("detect", {"img_per_s": 0.5}, {}, None),
    ("detect", {"img_per_s": 2.0}, {}, "img_per_s at depth=2 regressed"),
    ("detect", {"host_sync_bytes_per_tick": 0.5}, {},
     "host_sync_bytes_per_tick regressed"),
    ("multires", {"img_per_s": 0.5}, {}, None),
    ("multires", {"img_per_s": 2.0}, {}, "img_per_s at depth=2 regressed"),
    ("lm", {"host_sync_bytes_per_tick": 0.5}, {},
     "host_sync_bytes_per_tick regressed"),
    ("compose", {}, {"lost": 1}, "compose conservation"),
)


def gate_pair(launch, workload: str, path) -> tuple:
    """Phase 18: ``workload`` through the launcher twice with
    ``--gate-bench`` against ``path``, the committed img/s taken out
    between the runs; (first record, second record)."""
    argv = (["--workload", workload] + GATE_RUNS[workload]
            + ["--gate-bench", "--out", str(path)])
    first = launch.main(argv)
    data = json.loads(path.read_text())
    if data[workload] != json.loads(json.dumps(first)):
        raise AssertionError(f"gates: {workload}'s first run did not "
                             f"record itself")
    data[workload].pop("img_per_s", None)
    path.write_text(json.dumps(data))
    second = launch.main(argv)
    if workload in ("lm", "detect") and second["host_sync_bytes_per_tick"] \
            != first["host_sync_bytes_per_tick"]:
        raise AssertionError(f"gates: {workload}'s host sync bytes a tick "
                             f"moved: {first['host_sync_bytes_per_tick']} "
                             f"then {second['host_sync_bytes_per_tick']}")
    return first, second


def gate_doctored(launch, workload: str, record: dict, scale: dict,
                  change: dict, fails, path) -> str:
    """Phase 18: the launcher, its runner returning ``record`` updated by
    ``change``, against ``record`` committed with the keys of ``scale``
    scaled; raises unless it fails with ``fails`` leaving the file as it
    was, or passes (``fails`` None) writing the record. Returns what the
    gate said."""
    import io
    path.write_text(json.dumps({workload: {
        **record, **{k: record[k] * f for k, f in scale.items()}}}))
    before = path.read_bytes()
    served = {**record, **change}
    name = f"run_{workload}"
    run, out = getattr(launch, name), io.StringIO()
    setattr(launch, name, lambda args: served)
    try:
        with contextlib.redirect_stdout(out):
            launch.main(["--workload", workload, "--gate-bench", "--out",
                         str(path)])
        said = None
    except AssertionError as e:
        said = str(e)
    finally:
        setattr(launch, name, run)
    what = f"gates: {workload} committed x {scale}, record {change}"
    if fails is None:
        if said is not None or json.loads(path.read_text())[workload] != \
                json.loads(json.dumps(served)):
            raise AssertionError(f"{what}: {said or 'record not written'}")
        return [line for line in out.getvalue().splitlines()
                if line.startswith("[gate]")][-1]
    if said is None or not said.startswith(fails):
        raise AssertionError(f"{what}: expected {fails!r}, got {said!r}")
    if path.read_bytes() != before:
        raise AssertionError(f"{what}: the failed gate wrote the file")
    return said


def drive_gates(smi: str) -> dict:
    """Phase 18: `gate_pair` for each of GATE_RUNS, then `gate_doctored`
    for each of GATE_DOCTORED over the second runs' records."""
    import tempfile
    from repro_torch.launch import serve as launch
    t0 = time.perf_counter()
    out = {"card": smi, "runs": {}, "doctored": []}
    second = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "BENCH_serve_gate.json"
        for workload in GATE_RUNS:
            first, second[workload] = gate_pair(launch, workload, path)
            out["runs"][workload] = {
                k: [first.get(k), second[workload].get(k)] for k in (
                    "host_sync_bytes_per_tick", "img_per_s", "lost",
                    "duplicated")}
        reduction = second["detect"]["sync_bytes_reduction_vs_raw_wire"]
        if not reduction >= 10.0:
            raise AssertionError(f"gates: detect's device-NMS wire only "
                                 f"{reduction:.2f}x smaller")
        out["detect_reduction_vs_raw_wire"] = reduction
        for workload, scale, change, fails in GATE_DOCTORED:
            said = gate_doctored(launch, workload, second[workload], scale,
                                 change, fails,
                                 path.with_name("doctored.json"))
            out["doctored"].append({"workload": workload, "scale": scale,
                                    "change": change, "said": said})
            print(f"[gates] {workload} committed x {scale}, record "
                  f"{change}: {said}", flush=True)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[gates] record then enforce: {out['runs']}; detect's device-NMS "
          f"wire {reduction:.2f}x smaller a sync than the raw wire's at 320 "
          f"({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 19: the LM decode tick as one CUDA graph replay
# ---------------------------------------------------------------------------

TICKS = 16                     # (a): ticks held replay against eager
TICK_TEMPS = (0.0, 0.0, 0.8, 0.8)  # the sampled variants' rows
TICK_GENERATE_NEW = 8          # (a'): generate's tokens a prompt


def tick_backend(cfg, params, dev, *, done_mask: bool, sampled: bool):
    """An `LMBackend` on ``params`` (packed) at LM_SLOTS, LM_MAX_LEN, seed
    SEED, every slot admitted with a prompt of LM_PROMPT tokens and room
    for LM_MAX_LEN new ones; two rows sample at 0.8 where ``sampled``."""
    from repro_torch.serve import LMBackend, SamplingParams, ServeRequest
    backend = LMBackend(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                        mode="w1a8_eval", seed=SEED, done_mask=done_mask,
                        device=dev)
    backend.admit([(i, ServeRequest(
        rid=i, prompt=[2 + i, 11, 7 + i % 3], sampling=SamplingParams(
            max_new=LM_MAX_LEN,
            temperature=TICK_TEMPS[i] if sampled else 0.0)))
        for i in range(LM_SLOTS)])
    return backend


def eager_tick(torch, np, backend, snap: dict, gen) -> dict:
    """The eager step a tick of ``backend`` stands for, on ``snap`` (a
    clone of its state) with the host's per-row inputs: `decode_step` and
    `sample_tokens`, or `decode_step_donemask`. Returns its outputs under
    the state's keys."""
    from repro_torch.serve.engine import (decode_step, decode_step_donemask,
                                          sample_tokens)
    dev, cfg, params = backend.device, backend.cfg, backend.params
    temp = torch.from_numpy(backend.temp.copy()).to(dev)
    if not backend.done_mask:
        logits, cache = decode_step(cfg, params, snap["cache"],
                                    snap["last_tok"][:, None],
                                    mode=backend.mode)
        return {"cache": cache,
                "last_tok": sample_tokens(logits, temp, gen)}
    cache, tok, tok_buf, n_gen, done = decode_step_donemask(
        cfg, params, snap["cache"], snap["last_tok"], snap["tok_buf"],
        snap["n_gen"], snap["done"],
        torch.from_numpy(backend._stops_pad.copy()).to(dev),
        torch.from_numpy(backend._max_new_host.astype(np.int32)).to(dev),
        temp, gen, mode=backend.mode)
    return {"cache": cache, "last_tok": tok, "tok_buf": tok_buf,
            "n_gen": n_gen, "done": done}


@contextlib.contextmanager
def counting_calls(module, name: str):
    """Counts the calls of ``module.name`` inside (a list of one int)."""
    real, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _symbol_counts(_build) -> dict:
    return {k.symbol: k.launches for k in _build.KERNELS}


def tick_parity(torch, np, cfg, params, dev, smi: str) -> dict:
    """Phase 19a, b: for each tick variant (host-checked and done-mask,
    greedy and sampled), TICKS ticks of the backend against an eager
    `decode_step` (+ `sample_tokens`) or `decode_step_donemask` on clones
    of its state and of its generator, tick for tick: tokens, done bits,
    counts, the token buffer and every cache leaf equal bit for bit; each
    replay's launches (the backend's ``decode_launches``) equal the eager
    tick's; after the capturing tick no tick calls `decode_step` and each
    replays one CUDA graph. Returns (the record, the replays' launches
    summed by kernel symbol)."""
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import tree_items, tree_leaves
    from repro_torch.serve import engine
    from repro_torch.serve.engine import clone_generator, clone_state

    out, launches = {}, collections.Counter()
    for done_mask in (False, True):
        for sampled in (False, True):
            name = (f"{'done-mask' if done_mask else 'host-checked'} "
                    f"{'sampled' if sampled else 'greedy'}")
            t0 = time.perf_counter()
            backend = tick_backend(cfg, params, dev, done_mask=done_mask,
                                   sampled=sampled)
            eager_launches, replay_launches, compared = None, None, 0
            steps_called = replays = 0
            with torch.no_grad():
                for t in range(TICKS):
                    snap = clone_state(backend._state)
                    gen = clone_generator(backend._gen) if sampled else None
                    before = _symbol_counts(_build)
                    want = eager_tick(torch, np, backend, snap, gen)
                    torch.cuda.synchronize()
                    eager = {k: n - before[k] for k, n in
                             _symbol_counts(_build).items()
                             if n != before[k]}
                    done_before = dict(backend.decode_launches)
                    with counting_calls(engine, "decode_step") as calls, \
                            counting_calls(torch.cuda.CUDAGraph,
                                           "replay") as graph_replays:
                        backend.step()
                    torch.cuda.synchronize()
                    replay = {k: n - done_before.get(k, 0) for k, n in
                              backend.decode_launches.items()
                              if n != done_before.get(k, 0)}
                    if t > 0:
                        steps_called += calls[0]
                        replays += graph_replays[0]
                    if replay != eager:
                        raise AssertionError(f"tick {name} {t}: replay "
                                             f"launches {replay}, eager "
                                             f"{eager}")
                    eager_launches, replay_launches = eager, replay
                    launches.update(replay)
                    got = backend._state
                    for key, w in want.items():
                        pairs = (zip(tree_items(got["cache"]),
                                     tree_leaves(w)) if key == "cache"
                                 else [((key, got[key]), w)])
                        for (path, g), x in pairs:
                            if not torch.equal(g, x):
                                raise AssertionError(
                                    f"tick {name} {t}: {path} differs from "
                                    f"the eager step")
                            compared += 1
                    if sampled and not torch.equal(
                            backend._gen.get_state(), gen.get_state()):
                        raise AssertionError(f"tick {name} {t}: the "
                                             f"generator moved otherwise")
            wall = time.perf_counter() - t0
            if steps_called or replays != TICKS - 1:
                raise AssertionError(f"tick {name}: {steps_called} eager "
                                     f"decode_step calls and {replays} "
                                     f"graph replays over {TICKS - 1} ticks")
            sampled_rows = sum(t > 0 for t in backend.temp)
            print(f"[ticks] (a) {cfg.name} {name}: {TICKS} ticks, replay "
                  f"== eager on cloned state and generator bit for bit "
                  f"({compared} tensors; tokens, done, n_gen, tok_buf, "
                  f"every cache leaf), {sampled_rows} rows sampled; (b) "
                  f"launches a replay {replay_launches} == an eager "
                  f"tick's; after the capture {replays} CUDAGraph.replay "
                  f"calls and {steps_called} decode_step calls; {wall:.1f} s "
                  f"({smi})", flush=True)
            out[name] = {"ticks": TICKS, "tensors_compared": compared,
                         "launches_per_replay": replay_launches,
                         "launches_per_eager_tick": eager_launches,
                         "graph_replays": replays,
                         "eager_decode_step_calls": steps_called,
                         "wall_s": wall}
            del backend
    return out, dict(launches)


def generate_parity(torch, cfg, params, dev, smi: str) -> dict:
    """Phase 19a': `generate` on the card at ``ctx=None`` (greedy, and
    sampled at 0.8 from a seeded generator): one capture, then one graph
    replay a token and no `decode_step` call, its tokens equal to the
    eager loop's (`decode_step` then `sample_tokens` from a generator in
    the same state) bit for bit."""
    from repro_torch.serve import engine
    from repro_torch.serve.engine import (decode_step, generate, prefill,
                                          sample_tokens)

    prompts = torch.tensor([[2 + i, 11, 7 + i % 3] for i in range(LM_SLOTS)],
                           dtype=torch.int32, device=dev)
    out = {}
    for temperature in (0.0, 0.8):
        gens = []
        for _ in range(2):
            g = torch.Generator(device=dev)
            g.manual_seed(SEED)
            gens.append(g)
        with torch.no_grad(), \
                counting_calls(engine, "decode_step") as calls, \
                counting_calls(engine, "capture_tick") as captures, \
                counting_calls(torch.cuda.CUDAGraph, "replay") as replays:
            got = generate(cfg, params, prompts, max_new=TICK_GENERATE_NEW,
                           max_len=LM_MAX_LEN, mode="w1a8_eval",
                           temperature=temperature, generator=gens[0])
            torch.cuda.synchronize()
        # the warm tick and the capture each call decode_step once
        with torch.no_grad():
            logits, cache = prefill(cfg, params, prompts, max_len=LM_MAX_LEN,
                                    mode="w1a8_eval")
            temp = torch.full((LM_SLOTS,), temperature, device=dev)
            gen = gens[1] if temperature > 0 else None
            nxt, want = sample_tokens(logits, temp, gen), []
            for i in range(TICK_GENERATE_NEW):
                want.append(nxt)
                if i < TICK_GENERATE_NEW - 1:
                    logits, cache = decode_step(cfg, params, cache,
                                                nxt[:, None],
                                                mode="w1a8_eval")
                    nxt = sample_tokens(logits, temp, gen)
            want = torch.stack(want, dim=1)
        if not torch.equal(got, want) or captures[0] != 1 or \
                calls[0] != 2 or replays[0] != TICK_GENERATE_NEW - 1:
            raise AssertionError(
                f"generate at {temperature}: tokens equal "
                f"{torch.equal(got, want)}, {captures[0]} captures, "
                f"{calls[0]} decode_step calls, {replays[0]} replays")
        print(f"[ticks] (a') generate {cfg.name} at temperature "
              f"{temperature}: {TICK_GENERATE_NEW} tokens x {LM_SLOTS} "
              f"prompts equal to the eager loop's bit for bit; 1 capture "
              f"(its warm tick and capture the only 2 decode_step calls), "
              f"{replays[0]} CUDAGraph.replay calls ({smi})", flush=True)
        out[str(temperature)] = {"tokens": got.cpu().tolist(),
                                 "graph_replays": replays[0]}
    return out


def tick_timing(torch, cfg, params, dev, smi: str) -> dict:
    """Phase 19c: the done-mask greedy tick on ``params`` (packed, all
    LM_SLOTS rows live) as a graph replay and as an eager `decode_tick`
    on the same state: CUDA-event ms (`cuda_ms`) in turns (replay, eager,
    eager, replay), and each's device busy ms and idle share from
    `step_profile` (torch.profiler: the union of a call's device
    intervals against its profiled wall time), the clock of phases 10 and
    12's decode steps."""
    from repro_torch.serve.engine import decode_tick

    t0 = time.perf_counter()
    per = lm_launches_per_step(cfg)
    popcount = int(sum(v for name, v in per.items() if name != DECODE))
    backend = tick_backend(cfg, params, dev, done_mask=True, sampled=False)
    with torch.no_grad():
        backend.step()                              # captures the graph
        graph = backend._graphs[False]
        state = backend._state

        def eager():
            decode_tick(cfg, params, state, None, mode="w1a8_eval")
        replay_ms = [cuda_ms(torch, graph.replay, reps=3, n=3)]
        eager_ms = [cuda_ms(torch, eager, reps=3, n=3) for _ in range(2)]
        replay_ms.append(cuda_ms(torch, graph.replay, reps=3, n=3))
        prof = {"replay": step_profile(torch, graph.replay, popcount),
                "eager": step_profile(torch, eager, popcount)}
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "replay_ms": replay_ms, "eager_ms": eager_ms,
           **{f"{k}_device_busy_ms": p["device_busy_ms"]
              for k, p in prof.items()},
           **{f"{k}_idle_share": p["idle_share"] for k, p in prof.items()},
           # the traced busy time over the CUDA-event ms, no profiler on
           **{f"{k}_event_idle_share": None
              if p["device_timing"] != "torch.profiler" else
              1.0 - p["device_busy_ms"] / statistics.mean(ms)
              for (k, p), ms in zip(prof.items(), (replay_ms, eager_ms))},
           **{f"{k}_device_records": p["device_records"]
              for k, p in prof.items()},
           "device_timing": {k: p["device_timing"] for k, p in prof.items()},
           "launches_per_replay": {
               k.symbol: n for k, n in graph.launches.counts.items()},
           "wall_s": time.perf_counter() - t0}
    print(f"[ticks] (c) {cfg.name} ({cfg.num_layers} layers) done-mask "
          f"greedy tick at M = {LM_SLOTS}, CUDA-event ms in turns: replay "
          f"{replay_ms[0]:.3f}, eager {eager_ms[0]:.3f}, eager "
          f"{eager_ms[1]:.3f}, replay {replay_ms[1]:.3f}; device busy "
          f"replay {prof['replay']['device_busy_ms']:.4f} ms, eager "
          f"{prof['eager']['device_busy_ms']:.4f} ms; idle share replay "
          f"{_num(prof['replay']['idle_share'], '.4f')}, eager "
          f"{_num(prof['eager']['idle_share'], '.4f')} (torch.profiler: "
          f"union of device intervals over profiled wall; "
          f"{prof['replay']['device_timing']}, "
          f"{prof['eager']['device_timing']}), busy over the CUDA-event "
          f"ms replay {_num(rec['replay_event_idle_share'], '.4f')}, "
          f"eager {_num(rec['eager_event_idle_share'], '.4f')}; launches "
          f"a replay "
          f"{rec['launches_per_replay']}; {rec['wall_s']:.1f} s ({smi})",
          flush=True)
    del backend, graph, state
    return rec


def drive_ticks(torch, np, dev, smi: str, timing: dict) -> dict:
    """Phase 19: chatglm3-6b at full width, packed (`init_packed_lm` from
    SEED, which equals phase 10's `deploy_lm` of its seeded init leaf for
    leaf), slots LM_SLOTS, max_len LM_MAX_LEN: `tick_parity` (a, b) and
    `generate_parity` (a'); (c) is ``timing``, `tick_timing` by arch,
    taken where each tree was served (phase 10's chatglm3-6b, phase 12's
    mixtral-8x7b and mamba2-1.3b): late in the smoke a trace of replays
    loses its device records."""
    from repro_torch import configs
    from repro_torch.serve import init_packed_lm

    t0 = time.perf_counter()
    cfg = configs.get_config(LM_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        packed = init_packed_lm(cfg, gen, device=dev)
    parity, launches = tick_parity(torch, np, cfg, packed, dev, smi)
    out = {"card": smi, "arch": LM_ARCH, "parity": parity,
           "launches": launches,
           "generate": generate_parity(torch, cfg, packed, dev, smi),
           "timing": timing}
    del packed
    out["wall_s"] = time.perf_counter() - t0
    return out


def ticks_summary(rec: dict) -> dict:
    """Phase 19's numbers for the JSON lines."""
    return {"card": rec["card"], "arch": rec["arch"],
            "parity": {k: {f: v[f] for f in (
                "ticks", "tensors_compared", "graph_replays",
                "eager_decode_step_calls")}
                for k, v in rec["parity"].items()},
            "generate_replays": {k: v["graph_replays"]
                                 for k, v in rec["generate"].items()},
            "timing": {arch: {k: v for k, v in t.items()
                              if k not in ("launches_per_replay",)}
                       for arch, t in rec["timing"].items()},
            "wall_s": rec["wall_s"]}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import card_name
    from repro_torch.kernels import _build

    smi = card_name("cuda:0")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    entries = check_table()
    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernels built with nvcc in "
          f"{secs:.1f} s", flush=True)
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")
    sass = tensor_core_counts(_build)
    popcount_sass = popcount_globals(_build)


    t0 = time.perf_counter()
    layers, off_grid, errs = check_kernels(torch, np, dev)
    print(f"[check] {len(layers)} layer shapes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pc_layers, pc_errs = check_popcount_kernels(torch, np, dev)
    print(f"[popcount] {len(pc_layers)} kernel calls checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    one = torch.zeros(1, device=dev)
    floor_ms = device_profile(torch, lambda: torch.add(one, 1.0))[
        "device_busy_ms"]
    print(f"[floor] one-element torch.add: device {floor_ms:.4f} ms a call",
          flush=True)
    from repro_torch.kernels import config
    table_batch = json.loads(config.DEFAULT_TABLE.read_text())["batch"]
    winners = check_winners(torch, entries, table_batch)
    records, by_path = {}, {}
    for profile in PROFILES:
        records[profile], by_path[f"launcher {profile}"] = \
            drive_main_path(profile)
    record = records["tuned"]
    multires, by_path["launcher multires"] = drive_multires()
    dispatch_profiles = {p: profile_dispatch(p) for p in PROFILES}
    pc_record = drive_popcount(torch, np, dev)
    by_path["popcount forward and int call"] = pc_record["launches"]
    by_path["dot forward"] = pc_record["dot_launches"]
    per = {p: per_dispatch(records[p]["configs"]["320"]) for p in PROFILES}
    nms_record = check_graphs_and_postprocess(torch, np, dev)
    int_record = drive_int(torch, np, dev)
    by_path["int forward"] = int_record["launches"]
    t0 = time.perf_counter()
    qat_record = drive_qat(torch, np, dev, smi)
    print(f"[qat] phase 9 in {time.perf_counter() - t0:.1f} s", flush=True)
    by_path["qat pipeline"] = qat_record["launches"]
    t0 = time.perf_counter()
    lm_params, lm_record = drive_lm(torch, np, dev, smi)
    print(f"[lm] phase 10 in {time.perf_counter() - t0:.1f} s", flush=True)
    by_path["lm serve"] = lm_record["launches"]
    by_path["lm int call"] = lm_record["int_call_launches"]
    t0 = time.perf_counter()
    tiers = drive_tiers(torch, dev, smi, lm_params)
    del lm_params
    print(f"[tiers] phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    by_path.update(tiers["launches"])
    # what phases 10 and 11 left in reference cycles (their backends hold
    # chatglm3-6b's f32 params) goes before phase 12 measures peak memory
    before = torch.cuda.memory_allocated(dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[families] device memory allocated before phase 12: "
          f"{before / 2 ** 30:.2f} GiB, after collecting cycles "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    families = drive_families(torch, np, dev, smi)
    print(f"[families] phase 12 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    by_path.update(families["launches"])
    # phase 13 trains at full width: phase 12's trees go first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_train = drive_lm_train(torch, np, dev, smi)
    print(f"[lm train] phase 13 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    by_path["lm trained serve"] = lm_train["launches"]
    # phase 14 runs the distribution layer: phase 13's trees are gone
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_rec = drive_dist(torch, dev, smi)
    print(f"[dist] phase 14 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    sharded = drive_sharded(torch, np, dev, smi)
    by_path["sharded moe serve"] = sharded["launches"]
    by_path["sharded generate, tick replays"] = sharded["replay_launches"]
    print(f"[sharded] phase 15 in {sharded['wall_s']:.1f} s", flush=True)
    print("sharded " + json.dumps(sharded_summary(sharded)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    tooling = drive_tooling(torch, dev, smi)
    by_path[TABLES_PATH] = tooling["launches"]
    print(f"[tooling] phase 16 in {tooling['wall_s']:.1f} s", flush=True)
    print("tooling " + json.dumps(tooling_summary(tooling)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    tp = drive_tp(torch, np, dev, smi)
    by_path["tp decode, rank 0 of (16, 16)"] = tp["decode"][
        "launches_per_decode_step"]
    by_path["tp tick replay, rank 0 of (16, 16)"] = tp["decode"][
        "launches_per_replay"]
    print(f"[tp] phase 17 in {tp['wall_s']:.1f} s", flush=True)
    print("tp " + json.dumps(tp_summary(tp)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    gates = drive_gates(smi)
    print(f"[gates] phase 18 in {gates['wall_s']:.1f} s", flush=True)
    print("gates " + json.dumps(gates), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    ticks = drive_ticks(torch, np, dev, smi, {
        LM_ARCH: lm_record["tick"],
        **{families[key]["arch"]: families[key]["tick"]
           for key in ("moe", "ssm")}})
    by_path["lm tick replays"] = ticks["launches"]
    print(f"[ticks] phase 19 in {ticks['wall_s']:.1f} s", flush=True)
    print("ticks " + json.dumps(ticks_summary(ticks)), flush=True)
    # every driven path's launches: the three launcher runs, phase 5's
    # eager forwards (popcount on both pool routes, dot fused) and int
    # call, phase 7's integer forward, phase 9's QAT pipeline, phase 10's
    # LM serve and int call, phase 11's launcher fleet, real traffic and
    # compose, phase 12's MoE and SSM serves and hybrid decode, phase 13's
    # trained model served, phase 15's sharded serves, phase 16's kernel
    # suite, phase 17's tensor-parallel decode step and phase 19's tick
    # replays
    launches = {name: sum(path.get(name, 0) for path in by_path.values())
                for name in KERNELS}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        popcount = name not in DOT
        rows = [r for r in (pc_layers if popcount else layers)
                if r["kernel"] == name]
        peak = INT8_OPS_PER_S if popcount else BF16_OPS_PER_S
        t_ops = sum(r["ops"] / peak for r in rows)
        t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {path: counts.get(name, 0)
                                 for path, counts in by_path.items()},
            "launches_per_dispatch": {p: per[p].get(name, 0)
                                      for p in PROFILES}}
        if name == INT_PE:
            rows = int_record["layers"]
            t_ops = sum(r["ops"] / INT8_OPS_PER_S for r in rows)
            t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
            entry.update({
                "counterpart_of": "the numpy int64 yolo_forward_int (no "
                                  "Pallas kernel)",
                "max_abs_err": 0,
                "launches_per_forward": int_record["launches"][INT_PE],
                "tensor_core_instructions": sass[name],
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "layers": [r["layer"] for r in rows],
                "planes": [r["planes"] for r in rows],
                "ms_per_forward": int_record["ms_per_forward"],
                "device_ms_per_forward":
                    int_record["profile"]["device_busy_ms"],
                **{k: sum(r[k] for r in rows) for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_device_ms")}})
            if not entry["launches"]:
                raise AssertionError(f"{name}: no launch on its path")
            kernels.append(entry)
            continue
        if name == DECODE:
            rows = lm_record["decode_route"]
            t_ops = sum(r["ops"] / INT8_OPS_PER_S for r in rows)
            t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
            decode_globals = {g: rec for g, rec in popcount_sass.items()
                              if "decode_kernel" in g}
            entry.update({
                "share_of": "w1a8_matmul_popcount",
                "max_abs_err": 0.0,
                "tensor_core_instructions": {
                    op: sum(g[op] for g in decode_globals.values())
                    for op in TENSOR_CORE_OPS},
                "globals": decode_globals,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "shapes": [[r["what"], *r["shape"]] for r in rows],
                "launches_per_decode_step": {
                    LM_ARCH: lm_record["serve"][
                        "kernel_launches_per_decode_step"].get(name, 0),
                    **{families[key]["arch"]: lm_launches_per_step_of(
                        families[key]).get(name, 0)
                       for key in ("moe", "hybrid")},
                    f"{TP_ARCH} rank 0 of (16, 16)": tp["decode"][
                        "launches_per_decode_step"].get(name, 0)},
                **{k: sum(r[k] for r in rows) for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_device_ms")},
                "by_shape": {k: [r[k] for r in rows] for k in (
                    "ms", "decode_device_ms", "pr15_device_ms", "plain_ms",
                    "library_device_ms", "bound_ms")},
                "floor_device_ms": rows[0]["floor_device_ms"]})
            if not entry["launches"]:
                raise AssertionError(f"{name}: no launch on its path")
            kernels.append(entry)
            continue
        if name == GROUPED:
            rows = families["grouped"]
            t_ops = sum(r["ops"] / INT8_OPS_PER_S for r in rows)
            t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
            entry.update({
                "max_abs_err": 0.0,
                "tensor_core_instructions": sass[name],
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "shapes": [[r["arch"], r["what"], *r["shape"]]
                           for r in rows],
                "launches_per_decode_step": {
                    **{families[key]["arch"]: lm_launches_per_step_of(
                        families[key]).get(name, 0)
                       for key in ("moe", "hybrid")},
                    f"{MOE_ARCH} sharded": sharded["serve"]["wire_off"][
                        "launches_per_decode_step"].get(name, 0)},
                **{k: sum(r[k] for r in rows) for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_device_ms")},
                "by_shape": {k: [r[k] for r in rows] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_device_ms", "experts_holding_rows", "items",
                    "decode_device_ms", "pr15_device_ms")},
                "floor_device_ms": rows[0]["floor_device_ms"]})
            if not entry["launches"]:
                raise AssertionError(f"{name}: no launch on its path")
            kernels.append(entry)
            continue
        if name == "detect_postprocess":
            entry.update({
                "counterpart_of": "the jitted postprocess: decode_head and "
                                  "a lax.fori_loop NMS (no Pallas kernel)",
                "max_abs_err": 0.0, "library_device_ms": None,
                "tensor_core_instructions": sass[name],
                **{k: nms_record[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape", "nms_device_ms",
                    "decode_head_device_ms", "tiles")}})
            if not entry["launches"]:
                raise AssertionError(f"{name}: no launch on its path")
            kernels.append(entry)
            continue
        lm_rows = [r for r in lm_record["kernels"] if r["kernel"] == name]
        if lm_rows:
            # at the LM path's shapes, beside the detector's below
            entry["lm"] = {
                "shapes": [[r["what"], *r["shape"]] for r in lm_rows],
                "launches_per_decode_step":
                    lm_record["serve"]["kernel_launches_per_decode_step"]
                    .get(name, 0),
                "max_abs_err": lm_record["kernel_errs"][name],
                **{k: [r[k] for r in lm_rows] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms")}}
            entry["lm"]["kernel_device_ms"] = [
                r["kernel_device_ms"] for r in lm_rows]
        if name == "w1a8_matmul_popcount":
            # phase 17: the tensor-parallel blocks at |model| = 16
            entry["tp"] = {
                "arch": TP_ARCH, "model": TP_MODEL,
                "launches_per_decode_step":
                    tp["decode"]["launches_per_decode_step"].get(name, 0),
                "decode_step_ms": tp["decode"]["decode_step_ms"],
                "replay_ms": tp["decode"]["replay_ms"],
                "blocks": [{k: r.get(k) for k in (
                    "what", "kind", "block", "whole", "ms", "device_ms",
                    "whole_ms", "whole_device_ms", "bound_ms", "bound_by",
                    "max_abs_err", "route", "kernel_device_ms",
                    "pr15_device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "floor_device_ms")}
                    for r in tp["blocks"]]}
        if name in lm_train["serve"]["per_decode_step"]:
            # phase 13: the trained model, deployed and served
            entry["lm_trained"] = {
                "arch": LM_TRAIN_ARCH, "layers": LM_TRAIN_LAYERS,
                "launches_per_decode_step":
                    lm_train["serve"]["per_decode_step"][name],
                "launches": lm_train["launches"].get(name, 0)}
        if popcount:
            # every call is held bit for bit: the worst difference found
            entry["max_abs_err"] = pc_errs[name]
            if name in POPCOUNT:
                entry["launches_per_forward"] = {
                    route: r["launches"][name]
                    for route, r in pc_record["routes"].items()}
        else:
            e = errs[name]
            entry.update({
                # f32 error where the kernel has an f32 output; the pool
                # kernel writes codes only, so its error is in codes
                "max_abs_err": (e["f32"] if e["f32"] is not None
                                else e["codes"]),
                "max_codes_diff": e["codes"], "max_f32_err": e["f32"]})
        entry.update({
            "ms": sum(r["ms"] for r in rows),
            "device_ms": sum(r["device_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "library_device_ms": sum(r["library_device_ms"] for r in rows),
            "layers": [r["layer"] for r in rows]})
        entry["tensor_core_instructions"] = sass[name]
        if not entry["launches"]:
            raise AssertionError(f"{name}: no launch on its path")
        kernels.append(entry)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "layers": layers, "off_grid": off_grid,
         "popcount_layers": pc_layers,
         "kernels": kernels, "launchers": records, "multires": multires,
         "dispatch_profiles": dispatch_profiles, "winners": winners,
         "popcount_forward": pc_record, "nms": nms_record,
         "int_forward": int_record, "qat": qat_record, "lm": lm_record,
         "tiers": tiers, "families": families, "lm_train": lm_train,
         "dist": dist_rec, "sharded": sharded, "tooling": tooling,
         "tp": tp, "gates": gates, "ticks": ticks,
         "floor_device_ms": floor_ms,
         "popcount_globals": popcount_sass},
        indent=1))
    print(json.dumps({"kernels": kernels, "img_per_s": record["img_per_s"],
                      "requests": record["requests"],
                      "device_busy_ms_per_dispatch": {
                          p: r["device_busy_ms_per_dispatch"]
                          for p, r in dispatch_profiles.items()},
                      "popcount_forward": pc_record["routes"],
                      "dot_ms_per_forward": pc_record["dot_ms_per_forward"],
                      "dot_profile": pc_record["dot_profile"],
                      "int_ms_per_forward": int_record["ms_per_forward"],
                      "int_profile": int_record["profile"],
                      "qat": {k: qat_record["train"][k] for k in (
                          "ms_per_step", "img_per_s", "peak_memory_bytes",
                          "held_out_loss_before", "held_out_loss_after")},
                      "qat_step_device_busy_ms":
                          qat_record["step_profile"]["device_busy_ms"],
                      "qat_idle_share": qat_record["step_profile"][
                          "idle_share_of_step"],
                      "qat_final_raw": qat_record["final_raw"],
                      "qat_turns_ms_per_step": {
                          k: [r["ms_per_step"] for r in v] for k, v in
                          qat_record["turns"]["runs"].items()},
                      "qat_eager_step_device_busy_ms":
                          qat_record["turns"]["profile"]["eager"][
                              "device_busy_ms"],
                      "qat_replay_contract": {
                          k: v["contract"] for k, v in
                          qat_record["replay_parity"].items()
                          if k.endswith("cuDNN")},
                      "lm": {"arch": LM_ARCH, "packed": True,
                             **{k: lm_record["serve"][k] for k in (
                                 "tok_per_s", "tick_p50_ms", "tick_p95_ms",
                                 "kernel_launches_per_decode_step")},
                             "decode_step_ms": lm_record["step_ms"],
                             "decode_step_device_busy_ms":
                                 lm_record["step_profile"]["device_busy_ms"],
                             "decode_step_idle_share":
                                 lm_record["step_profile"]["idle_share"],
                             "decode_step_bound_ms":
                                 lm_record["step_bound_ms"],
                             "peak_memory_bytes":
                                 lm_record["peak_memory_bytes"],
                             "prefill_parity": lm_record["parity"]},
                      "tiers": tiers["summary"],
                      "families": families_summary(families),
                      "lm_train": lm_train_summary(lm_train),
                      "dist": dist_summary(dist_rec),
                      "sharded": sharded_summary(sharded),
                      "tooling": tooling_summary(tooling),
                      "tp": tp_summary(tp),
                      "gates": {k: gates[k] for k in (
                          "runs", "detect_reduction_vs_raw_wire",
                          "wall_s")},
                      "ticks": ticks_summary(ticks),
                      "trace_fallbacks": TRACE_FALLBACKS,
                      "floor_device_ms": floor_ms, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
