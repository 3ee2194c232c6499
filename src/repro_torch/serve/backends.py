"""The two `serve.api.Backend` implementations, and the detector's
dispatch window (counterpart of ``repro/serve/backends.py``).

`LMBackend` — autoregressive decode over the stage-stacked LM params: one
`engine.decode_tick` per tick for every pool row (on the card one CUDA
graph replay, as the reference's jitted tick), batched multi-row prefill
at admission (requests arriving together prefill as one batch per prompt
length, then scatter into the pool in place via `cache.write_rows`),
per-row temperature sampling. Two termination paths, token for token the
same:
host-checked (the sampled token row syncs to the host every tick) and
``done_mask=True`` (`engine.decode_step_donemask` keeps the token buffer
and the stop tests on the device; the host reads a (B,) bool a tick and
the tokens in bulk when a row finishes).

`DetectionBackend` — the paper's deployed workload. Batched image requests
go through the packed-W1A8 kernel path, head decode and NMS as ONE
fixed-width dispatch per resolution bucket: on the card one CUDA graph
replay, as the reference's one jitted executable. With ``depth=K`` the
backend keeps a K-deep in-flight window: tick t's batch is dispatched
asynchronously on the current CUDA stream and harvested up to K-1 ticks
later, strictly in dispatch order (`DispatchWindow`), so admission
overlaps device compute.
"""
from __future__ import annotations

import collections
import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import detection, yolo
from repro_torch.models.layers import ModelConfig
from repro_torch.models.transformer import tree_leaves
from repro_torch.serve import cache as cache_mod
from repro_torch.serve.api import Emission, ServeRequest
from repro_torch.serve.engine import (capture_tick, decode_tick, prefill,
                                      sample_tokens)


class DispatchWindow:
    """K-deep in-flight dispatch window with completion reordering.

    Batches push in dispatch order (each push takes a monotonically
    increasing ticket) and pop strictly in that order. `pop_due` implements
    the two-rule harvest schedule:

      * depth rule — after a tick's dispatches, at most ``depth - 1``
        batches stay resident; the oldest surplus batches block (harvest)
        now. depth=1 is single-shot; depth=2 is the classic double buffer.
      * drain rule — a tick that dispatched nothing harvests exactly one
        resident batch, so a drained queue surfaces trailing results one
        batch per tick.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._q: collections.deque = collections.deque()
        self._tickets = 0
        self._harvested = 0

    def __len__(self) -> int:
        return len(self._q)

    def push(self, item) -> int:
        ticket = self._tickets
        self._tickets += 1
        self._q.append((ticket, item))
        return ticket

    def pop_due(self, *, pushed: bool) -> list:
        due = []
        if not pushed and self._q:                 # drain rule
            due.append(self._pop())
        while len(self._q) >= self.depth:          # depth rule
            due.append(self._pop())
        return due

    def _pop(self):
        ticket, item = self._q.popleft()
        assert ticket == self._harvested, \
            "harvest must follow dispatch order"
        self._harvested = ticket + 1
        return item


class _Graph(_build.Graph):
    """One bucket's dispatch captured as a CUDA graph: its static input
    images (width, S, S, 3) f32, its outputs packed into one static byte
    buffer, and the kernel launches each replay makes."""

    def __init__(self, graph, images: torch.Tensor, packed: torch.Tensor,
                 launches: _build.Captured):
        super().__init__(graph, launches)
        self.images, self.packed = images, packed


class DetectionBackend:
    """Packed-W1A8 YOLO detection backend (one image per request).

    ``art`` is a `models.yolo.deploy_yolo_kernel` artifact on ``device``
    (default: the card; asking for it without one raises). Images are
    (S, S, 3) float in [0, 1] or uint8 raw pixels (divided by 256, the Q0.8
    convention), where S is one of the ``buckets`` (default: the
    artifact's, else 320).

    Each dispatch runs the whole forward (kernels → decode → NMS) at a
    fixed batch width (= ``slots``); partial batches zero-pad. ``profile``
    ("tuned" or "default", `models.yolo.PROFILES`) picks each layer's
    kernel config once per bucket (`configs`): "tuned" what the port's
    autotune table resolves, popcount layers included, "default" the
    heuristic dot configs on the unfused pool route. The default
    emission wire carries the raw head beside the NMS'd detections, for
    verification against the float reference; ``device_nms=True`` ships
    only the compact set (`models.detection.compact_detections`).

    On the card each bucket's forward, with the wire's outputs, is one
    CUDA graph (`_Graph`, in ``_graphs``, shared by `spawn`'s twins as the
    reference's twins share one executable). `warmup` captures it after
    one eager warm call on a side stream, or the bucket's first dispatch
    does; a capture that fails raises, and nothing runs eagerly on the
    card. A dispatch stacks its images on the host in page-locked memory,
    copies them to the card at once into the graph's static input,
    replays the graph, and copies its packed outputs to page-locked host
    memory at once, right behind the replay on the same stream, so the
    next replay cannot overwrite a dispatch still in the window. On the
    CPU the forward runs eagerly.

    Host-sync accounting: the per-dispatch payload is static (fixed width
    per bucket), so syncs and bytes are credited at the tick that
    dispatches a batch, not at the tick whose harvest blocks on it.
    """

    def __init__(self, art: dict, *, slots: int = 4, profile: str = "tuned",
                 depth: Optional[int] = None, device_nms: bool = False,
                 buckets: Optional[Sequence[int]] = None,
                 iou_thresh: float = 0.45, score_thresh: float = 0.25,
                 max_out: int = 50, device=None):
        self.device = resolve_device(device)
        packed = art["layers"][1]["w_packed"]
        if packed.device.type != self.device.type:
            raise ValueError(f"artifact lives on {packed.device}, backend "
                             f"on {self.device}")
        if depth is None:
            depth = 1
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if buckets is None:
            buckets = art.get("buckets") or (yolo.INPUT_SIZE,)
        self.buckets = tuple(dict.fromkeys(int(b) for b in buckets))
        for b in self.buckets:
            if b <= 0 or b % 32:
                raise ValueError(f"bucket sizes must be positive multiples "
                                 f"of 32 (5 pools), got {b}")
        self.art = art
        self.width = slots                        # device batch per dispatch
        self.depth = depth                        # K-deep dispatch window
        self.capacity = (depth - 1 + len(self.buckets)) * slots
        self.admit_width = len(self.buckets) * slots
        self.bucket_admit_width = slots           # per-bucket page per tick
        self.profile = profile
        # kernel configs resolved once per bucket at the dispatch width
        self._configs = {b: yolo.kernel_configs(art, b, slots, profile=profile)
                         for b in self.buckets}
        self.device_nms = device_nms
        self.post = dict(iou_thresh=iou_thresh, score_thresh=score_thresh,
                         max_out=max_out)
        self._staged: Dict[int, List[Tuple[int, ServeRequest]]] = {}
        self._window = DispatchWindow(depth)
        self._emissions: Dict[int, List[Emission]] = {}
        self.host_syncs = 0
        self.host_sync_bytes = 0
        self.completion_syncs = 0
        self._batch_bytes = {
            b: sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in self.output_specs(b))
            for b in self.buckets}
        self._layouts = {b: self._layout(b) for b in self.buckets}
        self._graphs: Dict[int, _Graph] = {}

    def configs(self, bucket: int) -> tuple:
        """The W1A8 layers' KernelConfigs this backend serves ``bucket``
        with, in layer order (`models.yolo.kernel_configs` under its
        profile), from which a caller derives a dispatch's launches."""
        return self._configs[bucket]

    def output_specs(self, bucket: int) -> list:
        """[(shape, dtype)] of one dispatch's outputs at ``bucket``: the
        payload is static, so its bytes are known without a transfer."""
        w, n, g = self.width, self.post["max_out"], bucket // 32
        if self.device_nms:
            return [((w, n, 4), torch.float16), ((w, n), torch.float16),
                    ((w, n), torch.int8), ((w,), torch.int32)]
        return [((w, g, g, 75), torch.float32), ((w, n, 4), torch.float32),
                ((w, n), torch.float32), ((w, n), torch.int32)]

    def _layout(self, bucket: int) -> tuple:
        """([(byte offset, shape, dtype)] of `output_specs` packed into one
        byte buffer, each 16-byte aligned; the buffer's bytes)."""
        layout, offset = [], 0
        for shape, dtype in self.output_specs(bucket):
            layout.append((offset, shape, dtype))
            offset += -(-int(np.prod(shape)) * dtype.itemsize // 16) * 16
        return layout, offset

    def _forward(self, imgs: torch.Tensor) -> tuple:
        raw = yolo.yolo_forward_kernel(self.art, imgs,
                                       configs=self._configs[imgs.shape[1]])
        boxes, scores, classes = detection.postprocess(raw, **self.post)
        if self.device_nms:
            return detection.compact_detections(boxes, scores, classes)
        return raw, boxes, scores, classes

    def _capture(self, bucket: int) -> _Graph:
        """Captures ``bucket``'s forward as a CUDA graph whose outputs land
        in one static byte buffer (`_layout`), after one eager warm call on
        a side stream, which loads the kernels, fills the decode constants
        and lets cuDNN pick its algorithms."""
        dev = self.device
        layout, nbytes = self._layouts[bucket]
        images = torch.zeros((self.width, bucket, bucket, 3),
                             dtype=torch.float32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            self._forward(images)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _build.capturing() as launches, torch.no_grad(), \
                torch.cuda.device(dev), torch.cuda.graph(graph):
            packed = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            for (offset, shape, dtype), out in zip(layout,
                                                   self._forward(images)):
                if out.shape != shape or out.dtype != dtype:
                    raise RuntimeError(f"output {tuple(out.shape)} "
                                       f"{out.dtype} is not {shape} {dtype}")
                size = out.numel() * dtype.itemsize
                packed[offset:offset + size].view(dtype).view(shape) \
                    .copy_(out)
        return _Graph(graph, images, packed, launches)

    def _dispatch(self, batch: torch.Tensor) -> tuple:
        """Enqueues one forward of a `_host_batch`; returns its outputs and
        an event recorded after them (None on the CPU, where the forward
        has already run). On the card the outputs are the graph's packed
        bytes in page-locked host memory, there once the event is."""
        if self.device.type != "cuda":
            if batch.dtype == torch.uint8:
                batch = batch.to(torch.float32) / 256.0
            with torch.no_grad():
                return self._forward(batch), None
        bucket = batch.shape[1]
        g = self._graphs.get(bucket)
        if g is None:
            g = self._graphs[bucket] = self._capture(bucket)
        if batch.dtype == torch.uint8:
            torch.div(batch.to(self.device, non_blocking=True), 256.0,
                      out=g.images)
        else:
            g.images.copy_(batch, non_blocking=True)
        g.replay()
        host = torch.empty(g.packed.shape, dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(g.packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _host_batch(self, images: Sequence) -> torch.Tensor:
        """``images`` stacked on the host and zero-padded to the width:
        uint8 where every image is uint8 (divided by 256 on the device),
        else float32 with any uint8 codes divided by 256 here; page-locked
        on the card's path, so one copy moves the batch."""
        ims = [torch.as_tensor(im) for im in images]
        codes = all(im.dtype == torch.uint8 for im in ims)
        batch = torch.empty((self.width,) + tuple(ims[0].shape),
                            dtype=torch.uint8 if codes else torch.float32,
                            pin_memory=self.device.type == "cuda")
        for i, im in enumerate(ims):
            if not codes:
                im = im.to(torch.float32) / 256.0 \
                    if im.dtype == torch.uint8 else im.to(torch.float32)
            batch[i] = im
        batch[len(ims):] = 0
        return batch

    def spawn(self, *, depth: Optional[int] = None) -> "DetectionBackend":
        """Fresh replica with independent slot/emission/sync state, sharing
        the artifact; ``depth`` re-sizes its window and slot pool."""
        twin = copy.copy(self)
        if depth is not None:
            if depth < 1:
                raise ValueError(f"depth must be >= 1, got {depth}")
            twin.depth = int(depth)
            twin.capacity = (twin.depth - 1 + len(self.buckets)) * self.width
        twin._staged = {}
        twin._window = DispatchWindow(twin.depth)
        twin._emissions = {}
        twin.host_syncs = 0
        twin.host_sync_bytes = 0
        twin.completion_syncs = 0
        return twin

    def bucket_of(self, req: ServeRequest) -> int:
        """Resolution bucket (= image side S) for a request, from its
        static `image_shape`, never the pixels."""
        shape = getattr(req, "image_shape", None)
        if shape is None and req.image is not None:
            shape = np.shape(req.image)
        if not shape:
            raise ValueError(f"request {req.rid}: detection needs an image")
        size = int(shape[0])
        if size not in self._batch_bytes:
            raise ValueError(
                f"request {req.rid}: image size {size} matches no "
                f"configured bucket {self.buckets}")
        return size

    def warmup(self) -> None:
        """Run every bucket's fixed-width dispatch once, so serving ticks
        exclude set-up: on the card the first builds the kernels and
        captures the bucket's graph, then replays it."""
        for b in self.buckets:
            _, event = self._dispatch(self._host_batch(
                [np.zeros((b, b, 3), np.float32)]))
            if event is not None:
                event.synchronize()

    def admit(self, assignments: Sequence[Tuple[int, ServeRequest]]) -> None:
        for slot, req in assignments:
            self._staged.setdefault(self.bucket_of(req), []).append(
                (slot, req))

    def step(self) -> None:
        staged, self._staged = self._staged, {}
        pushed = 0
        for bucket, group in staged.items():
            batch = self._host_batch([r.image for _, r in group])
            self._window.push(([slot for slot, _ in group], bucket,
                               self._dispatch(batch)))
            pushed += 1
            # credit the transfer to the tick that dispatched the batch
            self.host_syncs += 1
            self.host_sync_bytes += self._batch_bytes[bucket]
        for inflight in self._window.pop_due(pushed=bool(pushed)):
            self._emit(inflight)

    def _emit(self, inflight: tuple) -> None:
        slots_, bucket, (results, event) = inflight
        host = self._host_outputs(bucket, results, event)
        if self.device_nms:
            boxes, scores, classes, valid = host
            for i, slot in enumerate(slots_):
                # upcast host-side (lossless); the fp16/int8 forms are what
                # crossed the wire and what _batch_bytes counted
                payload = {"boxes": boxes[i].astype(np.float32),
                           "scores": scores[i].astype(np.float32),
                           "classes": classes[i].astype(np.int32),
                           "valid": int(valid[i])}
                self._emissions.setdefault(slot, []).append(
                    Emission(kind="detections", payload=payload, final=True))
            return
        raw, boxes, scores, classes = host
        for i, slot in enumerate(slots_):
            payload = {"boxes": boxes[i], "scores": scores[i],
                       "classes": classes[i], "raw": raw[i]}
            self._emissions.setdefault(slot, []).append(
                Emission(kind="raw_head", payload=payload, final=True))

    def _host_outputs(self, bucket: int, results, event) -> list:
        """A dispatch's outputs as numpy arrays, in `output_specs` order,
        once its event is done; the page-locked bytes are copied out, so
        the buffer goes back to the allocator."""
        if event is None:
            return [t.numpy() for t in results]
        event.synchronize()
        data = torch.from_numpy(results.numpy().copy())
        layout, _ = self._layouts[bucket]
        return [data[offset:offset + int(np.prod(shape)) * dtype.itemsize]
                .view(dtype).view(shape).numpy()
                for offset, shape, dtype in layout]

    def harvest(self) -> Dict[int, List[Emission]]:
        out, self._emissions = self._emissions, {}
        return out

    def release(self, slot: int) -> None:
        self._emissions.pop(slot, None)



class LMBackend:
    """Slot-pool LM decode backend (capacity = pool batch ``slots``).

    ``params`` (float, or packed by `serve.packed.deploy_lm`) live on
    ``device`` (default: the card; asking for it without one raises).
    Sampled rows draw from a `torch.Generator` on the device seeded by
    ``seed``; both termination paths consume it alike. ``decode_steps``
    counts the fused ticks and ``decode_launches`` the CUDA kernel
    launches they made, by kernel symbol.

    The decode state (the cache, the last tokens, the per-row temperature,
    stop tokens and max_new, and the done-mask path's token buffer,
    counts and done bits) lives in fixed tensors from the start: admission
    writes prefilled rows into them (`cache.write_rows`) and a tick writes
    its outputs back (`engine.decode_tick`). On the card each tick is one
    replay of a CUDA graph (`engine.capture_tick`), captured at the first
    tick that needs it, one for greedy ticks and one for sampled ones, as
    the reference jits one executable a ``use_key``; a replay adds the
    launches its capture recorded. On the CPU the tick runs eagerly. There
    is no switch between the two, and a capture that fails raises.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, mode: str = "float", seed: int = 17,
                 done_mask: bool = False, max_stop_tokens: int = 4,
                 device=None):
        self.device = dev = resolve_device(device)
        leaf = tree_leaves(params)[0]
        if leaf.device.type != dev.type:
            raise ValueError(f"params live on {leaf.device}, backend on "
                             f"{dev}")
        self.cfg, self.params = cfg, params
        self.capacity, self.max_len, self.mode = slots, max_len, mode
        self.done_mask = done_mask
        self.cache = cache_mod.init_cache(cfg, slots, max_len, device=dev)
        self.last_tok = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.temp = np.zeros((slots,), np.float32)
        # the tick's fixed tensors (`engine.decode_tick`)
        self._state = {"cache": self.cache, "last_tok": self.last_tok,
                       "temp": torch.zeros((slots,), dtype=torch.float32,
                                           device=dev)}
        self._graphs: Dict[bool, _build.Graph] = {}  # by "a row samples"
        self._active = np.zeros((slots,), bool)
        self._emissions: Dict[int, List[Emission]] = collections.defaultdict(
            list)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self.host_syncs = 0          # per-tick step/harvest-path transfers
        self.host_sync_bytes = 0     # bytes over those transfers
        self.completion_syncs = 0    # bulk token fetches (done-mask path)
        self.decode_steps = 0
        self.decode_launches: Dict[str, int] = collections.Counter()
        if done_mask:
            self.max_stop_tokens = max_stop_tokens
            # device-side decode state
            self.tok_buf = torch.zeros((slots, max_len), dtype=torch.int32,
                                       device=dev)
            self.n_gen = torch.zeros((slots,), dtype=torch.int32,
                                     device=dev)
            self.done = torch.ones((slots,), dtype=torch.bool, device=dev)
            self._state.update(
                tok_buf=self.tok_buf, n_gen=self.n_gen, done=self.done,
                stop_tokens=torch.full((slots, max_stop_tokens), -1,
                                       dtype=torch.int32, device=dev),
                max_new=torch.zeros((slots,), dtype=torch.int32,
                                    device=dev))
            # host mirrors — derivable from the admission record plus the
            # done-mask reads, so tracking them costs no extra transfers
            self._n_host = np.zeros((slots,), np.int64)
            self._done_host = np.ones((slots,), bool)
            self._stops_host: Dict[int, Tuple[int, ...]] = {}
            self._max_new_host = np.zeros((slots,), np.int64)
            self._stops_pad = np.full((slots, max_stop_tokens), -1, np.int32)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- admission: batched multi-row prefill --------------------------------
    def admit(self, assignments: Sequence[Tuple[int, ServeRequest]]) -> None:
        by_len: Dict[int, list] = collections.defaultdict(list)
        for slot, req in assignments:
            by_len[len(req.prompt)].append((slot, req))
            self.temp[slot] = req.sampling.temperature
        for group in by_len.values():
            rows = [slot for slot, _ in group]
            prompts = self._tensor(np.asarray(
                [list(r.prompt) for _, r in group], np.int32))
            logits, cache1 = prefill(self.cfg, self.params, prompts,
                                     max_len=self.max_len, mode=self.mode)
            cache_mod.write_rows(self.cache, cache1, rows)
            first = self._sample(logits, np.asarray(
                [r.sampling.temperature for _, r in group], np.float32))
            self.last_tok[self._tensor(np.asarray(rows, np.int64))] = \
                self._tensor(first)
            for i, (slot, req) in enumerate(group):
                tok = int(first[i])
                self._active[slot] = True
                if self.done_mask:
                    self._admit_done_mask(slot, req, tok)
                else:
                    self._emissions[slot].append(
                        Emission(kind="token", payload=tok))

    def _admit_done_mask(self, slot: int, req: ServeRequest,
                         tok: int) -> None:
        """Seed the device-side decode state for one admitted row. The
        prefill token is sampled host-side (shared path with host-checked
        mode), so its stop test runs here and folds into the initial done
        bit — a stop token in position 1 finishes the request this tick."""
        sp = req.sampling
        stops = tuple(sp.stop_tokens)
        if len(stops) > self.max_stop_tokens:
            raise ValueError(f"request {req.rid}: {len(stops)} stop tokens "
                             f"> backend cap {self.max_stop_tokens}")
        if sp.max_new > self.max_len:
            raise ValueError(f"request {req.rid}: max_new {sp.max_new} "
                             f"exceeds the device token buffer "
                             f"(max_len={self.max_len})")
        done0 = (tok in stops) or (1 >= sp.max_new)
        self.tok_buf[slot, 0] = tok
        self.n_gen[slot] = 1
        self.done[slot] = done0
        self._n_host[slot] = 1
        self._done_host[slot] = done0
        self._stops_host[slot] = stops
        self._max_new_host[slot] = sp.max_new
        self._stops_pad[slot] = -1
        self._stops_pad[slot, :len(stops)] = stops

    # -- one fused decode tick -----------------------------------------------
    def step(self) -> None:
        if not self._active.any():
            return
        use_gen = bool((self.temp > 0).any())          # same rule as _sample
        tick = self._tick(use_gen)
        before = {k.symbol: k.launches for k in _build.KERNELS}
        with torch.no_grad():
            tick()
        if self.done_mask:
            # rows live at dispatch grew by one token (mirrors device n_gen)
            self._n_host += (self._active & ~self._done_host)
        else:
            nxt = self.last_tok.cpu().numpy()          # token-row host sync
            self.host_syncs += 1
            self.host_sync_bytes += 4 * self.capacity  # (B,) int32 tokens
            for slot in np.flatnonzero(self._active):
                self._emissions[int(slot)].append(
                    Emission(kind="token", payload=int(nxt[slot])))
        self.decode_steps += 1
        for k in _build.KERNELS:
            if k.launches != before[k.symbol]:
                self.decode_launches[k.symbol] += \
                    k.launches - before[k.symbol]

    def _tick(self, use_gen: bool):
        """This tick, ready to run: the host's per-row inputs copied into
        their fixed tensors, then on the card the replay of the graph of
        ``use_gen`` (captured here the first time, which launches a warm
        tick on clones: not this tick's launches), on the CPU the tick."""
        state = self._state
        state["temp"].copy_(torch.from_numpy(self.temp))
        if self.done_mask:
            state["stop_tokens"].copy_(torch.from_numpy(self._stops_pad))
            state["max_new"].copy_(torch.from_numpy(
                self._max_new_host.astype(np.int32)))
        gen = self._gen if use_gen else None
        if self.device.type != "cuda":
            return lambda: decode_tick(self.cfg, self.params, state, gen,
                                       mode=self.mode)
        if use_gen not in self._graphs:
            self._graphs[use_gen] = capture_tick(
                self.cfg, self.params, state, gen, mode=self.mode)
        return self._graphs[use_gen].replay

    def harvest(self) -> Dict[int, List[Emission]]:
        if not self.done_mask:
            out = dict(self._emissions)
            self._emissions = collections.defaultdict(list)
            return out
        out: Dict[int, List[Emission]] = {}
        if not self._active.any():
            return out
        done_np = self.done.cpu().numpy()        # THE per-tick bitmask read
        self.host_syncs += 1
        self.host_sync_bytes += self.capacity    # (B,) bool bitmask
        newly = done_np & self._active
        self._done_host = done_np.copy()
        if newly.any():
            rows = np.flatnonzero(newly)
            toks = self.tok_buf[self._tensor(rows)].cpu().numpy()  # one gather
            self.completion_syncs += 1
            for i, slot in enumerate(rows):
                slot = int(slot)
                n = int(self._n_host[slot])
                seq = tuple(int(t) for t in toks[i, :n])
                reason = ("stop" if seq and seq[-1]
                          in self._stops_host.get(slot, ()) else "length")
                out[slot] = [Emission(kind="tokens", payload=seq,
                                      finish=reason, final=True)]
        return out

    def release(self, slot: int) -> None:
        self._active[slot] = False
        self.temp[slot] = 0.0        # stale temp would force sampling forever
        self._emissions.pop(slot, None)
        if self.done_mask:
            self.done[slot] = True
            self._done_host[slot] = True
            self._stops_host.pop(slot, None)

    # per-row temperature: greedy rows take argmax, sampled rows draw
    def _sample(self, logits: torch.Tensor, temp) -> np.ndarray:
        t = np.asarray(temp, np.float32)
        gen = self._gen if (t > 0).any() else None
        return sample_tokens(logits, self._tensor(t), gen).cpu().numpy()
