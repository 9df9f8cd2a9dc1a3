"""Slot-based continuous-batching schedulers (port of
``repro/serve/scheduler.py``: ``Request``, ``SlotScheduler`` over a dense
per-slot KV pool — the continuous engine — and ``PagedSlotScheduler`` over
the paged block pool, both with speculative decoding).

The decode batch is a fixed pool of ``n_slots`` rows. A request is admitted
by prefilling it ALONE (dense: one bucketed whole-prompt prefill spliced
into its slot row; paged: chunked prefill into blocks reserved from the
pool); from then on it rides the shared decode step. When a request hits
EOS or its token budget its slot is freed at once and the next queued
request admits on the following tick. Inactive rows keep decoding junk at
position 0 (paged: of the parking block). EOS, budget and activity
bookkeeping live on the host, which syncs every tick to stream tokens out.

Speculative decoding (``spec_draft=(api, params, arch)``, ``spec_k > 1``):
each round the draft model, in its own dense fp slot pool on the same slot
indices, decodes ``spec_k`` steps from the current token (its last
proposal is discarded), and the target verifies the ``spec_k``-wide window
(current token + ``spec_k - 1`` proposals) in one step. The accept rule —
keep the longest prefix of proposals that match the target's own greedy
choices, then always take the target's next token — makes greedy output
token for token that of target-only decode, for any draft. Rollback is
free: both caches are position-masked, so resetting the host's ``_pos``
makes a rejected window's writes unattendable, and the next round's
consecutive writes overwrite them before any query reaches them.
``spec_k == 1`` is the plain tick (no draft is built).

Observability, as the reference's (``obs/``): a ``tracer`` (default the
process-global one, ``NULL_TRACER`` unless a launcher installed one)
receives the ``submit``, ``admission_deferral``, ``prefix_hit`` /
``prefix_miss`` and ``spec_round`` events, each request's ``queued`` and
``request`` async spans and ``prefill`` / ``decode`` spans on its slot's
track — stamped with the same clock reads as ``RequestMetrics``, so
``queued + prefill`` is TTFT exactly — and a ``compile`` span for the first
tick. A ``registry`` is fed by ``RunMetrics.bind_registry`` with the labels
mode / engine / route. A ``profiler`` (``obs.profile.StepTimer``) splits
every Nth tick into ``admit`` / ``decode`` / ``host`` phases. All of it is
host-side: with the defaults (``NULL_TRACER``, no registry, ``NULL_TIMER``)
a tick pays a few attribute checks and adds no device operation and no
synchronise; the tick's one barrier stays the ``.tolist()`` of its tokens.
Spans are host-clock, so a ``decode`` phase or span holds the device time
of the tick because it ends after that barrier. ``replay_arrivals`` drives
a scheduler open-loop from timed arrivals.

Tensor parallelism: ``mesh=`` (+ ``rules=``) runs the scheduler as one
rank of the mesh's "model" axis (``distributed.tp``). Every rank runs the
same host loop on the same requests; its params are placed once from the
full serve tree (each rank keeps its shard), its pool holds its kv heads,
and every tick runs under the group, whose collectives give every rank
the same whole logits, so the ranks take the same decisions. Speculation
under a mesh raises, as in the reference; so does a mesh whose "data" axis
is larger than 1 (data parallelism comes with the training slice). Open-
loop arrivals (``replay_arrivals``) read each rank's clock, so they do not
keep ranks in step: drive a mesh scheduler closed loop (``run``).

Like the engine, a scheduler runs on CUDA unless ``device="cpu"`` is
passed, and raises without a GPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.tp import shard_serve_params, tp_group
from repro_torch.models.base import ArchConfig, ModelAPI
from repro_torch.obs.profile import NULL_TIMER, StepTimer
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.serve.compile_cache import BucketedPrefill, ChunkedPrefill
from repro_torch.serve.kv import KVSlotManager
from repro_torch.serve.metrics import RequestMetrics, RunMetrics
from repro_torch.serve.paged_kv import PagedKVManager

__all__ = ["PagedSlotScheduler", "Request", "SlotScheduler", "replay_arrivals",
           "scheduler_supports"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: Optional[np.ndarray] = None
    # streaming: called once per emitted token (including EOS), in order
    on_token: Optional[Callable[[int], None]] = None
    metrics: Optional[RequestMetrics] = None


def scheduler_supports(arch: ArchConfig) -> bool:
    """Non-MoE, non-SWA 'lm' models, as the reference: MoE capacity routing
    couples the rows of a batch (a junk row would take an expert's place),
    and a ring cache is shorter than the max_len rows the slot pool holds.
    Both go to the static engine."""
    return arch.family == "lm" and arch.n_experts == 0 and arch.window is None


@dataclasses.dataclass
class _SlotState:
    req: Request
    remaining: int  # tokens still allowed (after the prefill token)
    emitted: List[int]


class SlotScheduler:
    """The admit/decode/emit loop over a dense per-slot KV pool (the
    continuous engine). ``PagedSlotScheduler`` overrides the pool, prefill
    and tick hooks."""

    engine_name = "continuous"

    def __init__(
        self,
        api: ModelAPI,
        params,
        arch: ArchConfig,
        *,
        n_slots: int = 4,
        max_len: int = 256,
        quantized_kv: bool = False,
        device=None,
        clock: Callable[[], float] = time.monotonic,
        tracer: Optional[Tracer] = None,
        registry=None,
        profiler: Optional[StepTimer] = None,
        spec_draft=None,
        spec_k: int = 1,
        mesh=None,
        rules=None,
    ):
        if not scheduler_supports(arch):
            raise ValueError(
                f"SlotScheduler supports non-MoE, non-SWA 'lm' models; got family="
                f"{arch.family!r} n_experts={arch.n_experts} window={arch.window} "
                f"(use the static engine)"
            )
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if spec_draft is not None and spec_k > 1 and mesh is not None:
            raise ValueError("speculative decoding under a mesh is not implemented (the "
                             "draft pool and the verify round are not sharded)")
        self.mesh, self.rules = mesh, rules
        self.tp = tp_group(mesh, rules)
        self.api = api
        self.arch = arch
        self.n_slots = n_slots
        self.max_len = max_len
        self.clock = clock
        # an explicit tracer wins, else the process-global hook; the profiler
        # stays NULL_TIMER unless the caller opts in
        self.tracer = tracer if tracer is not None else get_tracer()
        self.profiler = profiler if profiler is not None else NULL_TIMER
        self._tick_ran = False  # the first tick carries the trace's compile span
        self.device = resolve_device(device)
        self.params = shard_serve_params(params, arch, self.tp)  # a placed tree passes
        self._init_kv_prefill(api, quantized_kv)
        self.metrics = RunMetrics(n_slots=n_slots)
        if registry is not None:
            self.metrics.bind_registry(registry, mode=arch.compute_mode, engine=self.engine_name,
                                       route=arch.paged_attn_route)
        self._stamp_kv_gauges()
        self._prefill_miss_base = self.prefill.misses
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self._slots: List[Optional[_SlotState]] = [None] * n_slots
        self._tok = np.zeros(n_slots, np.int32)  # last emitted token per slot
        self._pos = np.zeros(n_slots, np.int32)  # cache position of the NEXT write
        self.spec_k = spec_k
        self._spec_api = None
        if spec_draft is not None and spec_k > 1:
            self._init_spec(spec_draft)

    # -- dense-vs-paged hooks (PagedSlotScheduler overrides these) ----------

    def _init_kv_prefill(self, api, quantized_kv: bool) -> None:
        self.kv = KVSlotManager(api, n_slots=self.n_slots, max_len=self.max_len,
                                quantized=quantized_kv, device=self.device, mesh=self.mesh,
                                rules=self.rules)
        self.prefill = BucketedPrefill(api, max_len=self.max_len, quantized=quantized_kv,
                                       tracer=self.tracer, mesh=self.mesh, rules=self.rules)

    @property
    def _slots_available(self) -> int:
        return self.kv.n_free

    def _release_slot(self, slot: int) -> None:
        self.kv.free(slot)

    def _kv_pool_bytes(self) -> int:
        return self.kv.pool_bytes

    def _kv_bytes_per_token(self) -> float:
        return self._kv_pool_bytes() / (self.n_slots * self.max_len)

    def _decode_kv_bytes(self, active: List[int]) -> int:
        """Modeled KV bytes one decode tick reads: each active row's live
        context once."""
        bpt = self.metrics.kv_bytes_per_token
        return int(bpt * sum(int(self._pos[i]) + 1 for i in active))

    def _stamp_kv_gauges(self) -> None:
        self.metrics.kv_pool_bytes = self._kv_pool_bytes()
        self.metrics.kv_bytes_per_token = self._kv_bytes_per_token()

    def _host_tensors(self):
        dev = self.device
        return (torch.from_numpy(self._tok.copy()).to(dev),
                torch.from_numpy(self._pos.copy()).to(dev))

    def _run_tick(self) -> np.ndarray:
        tok, pos = self._host_tensors()
        logits, self.kv.cache = self.api.decode_step(self.params, tok[:, None], self.kv.cache,
                                                     pos)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        # repro: noqa-RPA001 -- the tick barrier: emitted tokens must reach
        # the host to route into per-request queues / detect EOS
        return np.array(nxt.tolist(), np.int32)

    def _admit_one(self, req: Request) -> bool:
        """Admit one request into a free slot (the dense pool always admits).
        ``t_admit`` is stamped when the slot is claimed, before the prefill."""
        slot = self.kv.alloc()
        assert slot is not None
        rm = req.metrics
        rm.t_admit = self.clock()
        logits, pcache = self.prefill(self.params, req.prompt)
        self.metrics.prefills += 1
        # repro: noqa-RPA001 -- admission emits the prefill token to the host
        t0 = int(torch.argmax(logits[0, -1]).item())
        plen = rm.prompt_len
        # decode writes go to plen .. plen+n-2; keep them inside the cache
        budget = min(req.max_new_tokens, self.max_len - plen + 1)
        st = _SlotState(req=req, remaining=budget, emitted=[])
        done = self._emit(st, t0)
        self._trace_admission(req, slot, bucket=self.prefill.bucket_for(plen))
        if done:
            self._finish(req, st, slot)
            self.kv.free(slot)
            return True
        self.kv.write_prefill(slot, pcache)
        self._slots[slot] = st
        self._tok[slot] = t0
        self._pos[slot] = plen
        self._spec_admit(slot, req)
        return True

    # -- speculative decoding -----------------------------------------------

    def _spec_verify_api(self):
        """The target's multi-token verify for this KV layout (paged
        overrides with ``decode_verify_paged``)."""
        return self.api.decode_verify

    def _spec_operands(self):
        """Extra operands of the verify step (paged: the live tables)."""
        return ()

    def _init_spec(self, spec_draft) -> None:
        """The draft side: the draft model rides the SAME slot indices as the
        target in its own dense fp KV pool, plus a bucketed prefill that
        seeds it at admission."""
        if self._spec_verify_api() is None:
            raise ValueError(
                f"speculative decoding needs a model family with a multi-token verify "
                f"path; {self.arch.family!r} has none"
            )
        dapi, dparams, darch = spec_draft
        if darch.window is not None or darch.n_experts:
            raise ValueError("draft model must be a non-MoE, non-SWA 'lm' model")
        self._spec_api = dapi
        self._spec_params = dparams
        self._spec_arch = darch
        self._spec_kv = KVSlotManager(dapi, n_slots=self.n_slots, max_len=self.max_len,
                                      quantized=False, device=self.device)
        self._spec_prefill = BucketedPrefill(dapi, max_len=self.max_len, quantized=False,
                                             tracer=self.tracer)

    def _run_spec_tick(self):
        """One round on the device: ``spec_k`` draft decode steps — consuming
        the current token, then its own proposals, so the draft's KV covers
        the window — and one target verify of the window. Returns (window
        (S, C), the target's greedy tokens (S, C)) on the host."""
        tok, pos = self._host_tensors()
        c = self.spec_k
        draft = self._spec_api.decode_step
        window = [tok]
        t = tok
        for j in range(c):  # step j consumes window token j at position pos + j
            logits, self._spec_kv.cache = draft(self._spec_params, t[:, None],
                                                self._spec_kv.cache, pos + j)
            t = torch.argmax(logits[:, -1], -1).to(torch.int32)
            if j + 1 < c:  # the last proposal lies beyond the window
                window.append(t)
        window = torch.stack(window, dim=1)
        logits, self.kv.cache = self._spec_verify_api()(self.params, window, self.kv.cache, pos,
                                                        *self._spec_operands())
        nxt = torch.argmax(logits, -1).to(torch.int32)  # (S, C) greedy
        # repro: noqa-RPA001 -- tick barrier: the accept rule compares draft
        # and target tokens on the host
        return window.cpu().numpy(), nxt.cpu().numpy()

    def _spec_admit(self, slot: int, req: Request) -> None:
        """Seed the draft's KV for a freshly admitted request (no-op when not
        speculating). The draft prefill's own logits are discarded: the
        target's admission token is what the first round drafts from."""
        if self._spec_api is None:
            return
        _logits, dcache = self._spec_prefill(self._spec_params, req.prompt)
        self._spec_kv.write_prefill(slot, dcache)

    def _spec_tick(self) -> bool:
        """One speculative round over the slot batch: emit each row's
        accepted prefix plus the target's correction. Per row the advance
        ``e`` is 1..spec_k tokens; ``_pos += e`` IS the rollback."""
        prof = self.profiler
        prof.tick()
        with prof.phase("admit"):
            self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return False
        with prof.phase("decode"):
            if not self._tick_ran and self.tracer.enabled:
                with self.tracer.span("compile", "scheduler", kind="spec_round",
                                      n_slots=self.n_slots, spec_k=self.spec_k):
                    window, nxt = self._run_spec_tick()
            else:
                window, nxt = self._run_spec_tick()
            prof.sync(nxt)
            self._tick_ran = True
        with prof.phase("host"):
            self.metrics.record_step(len(active), kv_bytes_read=self._decode_kv_bytes(active))
            c = self.spec_k
            drafted = accepted = 0
            for i in active:
                st = self._slots[i]
                w, g = window[i], nxt[i]
                # accept rule: the longest prefix of proposals equal to the
                # target's greedy choices (w[j] proposal j, g[j-1] the target's
                # token after window slot j-1), then always the target's g[a-1]
                a = 1
                while a < c and w[a] == g[a - 1]:
                    a += 1
                e = 0
                done = False
                for j in range(a):
                    e += 1
                    done = self._emit(st, int(g[j]))
                    if done:
                        break  # budget/EOS truncation: e <= a tokens used
                self._tok[i] = g[e - 1]
                self._pos[i] += e
                drafted += c - 1
                accepted += e - 1
                if done:
                    self._finish(st.req, st, i)
                    self._slots[i] = None
                    self._release_slot(i)
                    self._tok[i] = 0
                    self._pos[i] = 0
            self.metrics.record_spec_round(len(active), drafted, accepted)
            if self.tracer.enabled:
                # the same counts the metrics accumulate, one event a round
                self.tracer.event("spec_round", track="scheduler", rows=len(active),
                                  drafted=drafted, accepted=accepted)
        return True

    # -- queue --------------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def window_prefill_compiles(self) -> int:
        return self.prefill.misses - self._prefill_miss_base

    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"req {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"req {req.rid}: max_new_tokens must be >= 1")
        if plen >= self.max_len:
            raise ValueError(
                f"req {req.rid}: prompt length {plen} >= max_len {self.max_len} "
                f"leaves no room to generate"
            )
        req.metrics = RequestMetrics(rid=req.rid, prompt_len=plen, t_submit=self.clock())
        if self.tracer.enabled:
            self.tracer.event("submit", track="scheduler", rid=req.rid, prompt_len=plen)
        self.queue.append(req)

    # -- lifecycle ----------------------------------------------------------

    def _finish(self, req: Request, st: _SlotState, slot: int) -> None:
        req.output = np.asarray(st.emitted, np.int32)
        rm = req.metrics
        rm.t_done = self.clock()
        rm.n_tokens = len(st.emitted)
        self.metrics.finish_request(rm)
        self.completed.append(req)
        if self.tracer.enabled:
            # first token -> done on the slot's track: duration / (n_tokens
            # - 1) is this request's TPOT (the same stamps)
            self.tracer.add_span("decode", f"slot{slot}", rm.t_first_token, rm.t_done,
                                 rid=req.rid, n_tokens=rm.n_tokens, tpot_s=rm.tpot)
            # the whole lifecycle, async (requests overlap freely)
            self.tracer.add_span("request", "requests", rm.t_submit, rm.t_done,
                                 async_id=req.rid, rid=req.rid, prompt_len=rm.prompt_len,
                                 n_tokens=rm.n_tokens, ttft_s=rm.ttft)

    def _emit(self, st: _SlotState, token: int) -> bool:
        """Record one generated token; returns True when the request is done."""
        st.emitted.append(token)
        st.remaining -= 1
        req = st.req
        if req.metrics.t_first_token is None:
            req.metrics.t_first_token = self.clock()
        if req.on_token is not None:
            req.on_token(token)
        return st.remaining <= 0 or (req.eos_id is not None and token == req.eos_id)

    def _trace_admission(self, req: Request, slot: int, **extra) -> None:
        """Queued + prefill spans from the request's own clock stamps:
        queued.dur + prefill.dur == TTFT exactly (the same floats)."""
        if not self.tracer.enabled:
            return
        rm = req.metrics
        self.tracer.add_span("queued", "requests", rm.t_submit, rm.t_admit,
                             async_id=req.rid, rid=req.rid)
        self.tracer.add_span("prefill", f"slot{slot}", rm.t_admit, rm.t_first_token,
                             rid=req.rid, prompt_len=rm.prompt_len, **extra)

    def _admit(self) -> None:
        """FIFO admission: the queue head admits or defers; a deferral blocks
        everything behind it (deadlock-free: completions free blocks)."""
        while self.queue and self._slots_available:
            if not self._admit_one(self.queue[0]):
                break
            self.queue.pop(0)

    def tick(self) -> bool:
        """Admit waiting requests, then run one decode step (or one
        speculative round) over the slot batch. Returns False when there was
        nothing to do. The profiler samples every Nth tick into admit (queue
        + prefill), decode (the device step, up to its barrier) and host
        (emit + EOS bookkeeping) phases. Under a mesh the whole tick runs
        under the rank's tensor-parallel group."""
        with comm.use(self.tp):
            return self._tick()

    def _tick(self) -> bool:
        if self._spec_api is not None:
            return self._spec_tick()
        prof = self.profiler
        prof.tick()
        with prof.phase("admit"):
            self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return False
        with prof.phase("decode"):
            if not self._tick_ran and self.tracer.enabled:
                with self.tracer.span("compile", "scheduler", kind="decode_tick",
                                      n_slots=self.n_slots):
                    nxt = prof.sync(self._run_tick())
            else:
                nxt = prof.sync(self._run_tick())
            self._tick_ran = True
        with prof.phase("host"):
            self.metrics.record_step(len(active), kv_bytes_read=self._decode_kv_bytes(active))
            for i in active:
                st = self._slots[i]
                self._tok[i] = nxt[i]
                self._pos[i] += 1
                if self._emit(st, int(nxt[i])):
                    self._finish(st.req, st, i)
                    self._slots[i] = None
                    self._release_slot(i)
                    # park the freed row: its junk writes land in the parking block
                    self._tok[i] = 0
                    self._pos[i] = 0
        return True

    def run(self) -> List[Request]:
        """Drain queue + slots; returns finished requests in completion order."""
        if self.metrics.t_start is None:
            self.metrics.t_start = self.clock()
        while self.has_work:
            self.tick()
        self.metrics.t_end = self.clock()
        self.metrics.prefill_compiles = self.window_prefill_compiles()
        self.metrics.publish()
        done, self.completed = self.completed, []
        return done


class PagedSlotScheduler(SlotScheduler):
    """Slot scheduler over a paged KV block pool: chunked prefill,
    shared-prefix block reuse and block backpressure (admission reserves a
    request's whole span up front; when blocks run short the queue head
    defers)."""

    engine_name = "paged"

    def __init__(
        self,
        api: ModelAPI,
        params,
        arch: ArchConfig,
        *,
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        chunk: int = 32,
        **kw,
    ):
        self.block_size = block_size
        self._n_blocks_arg = n_blocks
        self.prefix_enabled = prefix_cache
        self.chunk = chunk
        super().__init__(api, params, arch, **kw)

    def _init_kv_prefill(self, api, quantized_kv: bool) -> None:
        self.kv = PagedKVManager(
            api, n_slots=self.n_slots, max_len=self.max_len,
            block_size=self.block_size, n_blocks=self._n_blocks_arg,
            prefix_cache=self.prefix_enabled, quantized=quantized_kv, device=self.device,
            tracer=self.tracer, mesh=self.mesh, rules=self.rules,
        )
        self.prefill = ChunkedPrefill(api, chunk=self.chunk, max_len=self.max_len,
                                      tracer=self.tracer, mesh=self.mesh, rules=self.rules)

    @property
    def _slots_available(self) -> int:
        return self.kv.n_free_slots

    def _release_slot(self, slot: int) -> None:
        self.kv.free_slot(slot)

    def _kv_pool_bytes(self) -> int:
        return self.kv.pool_bytes

    def _kv_bytes_per_token(self) -> float:
        return self.kv.bytes_per_token

    def _decode_kv_bytes(self, active: List[int]) -> int:
        """Modeled per-tick KV bytes: the fused kernel streams each row's live
        blocks once; the gather route reads the full table window, writes the
        gathered copy and reads it back (3x)."""
        bpb = self.kv.bytes_per_block
        bs = self.block_size
        if self.arch.paged_attn_route == "fused":
            return int(bpb * sum(-(-(int(self._pos[i]) + 1) // bs) for i in active))
        return int(3 * bpb * self.kv.blocks_per_slot * len(active))

    def _run_tick(self) -> np.ndarray:
        tok, pos = self._host_tensors()
        logits, self.kv.cache = self.api.decode_paged(
            self.params, tok[:, None], self.kv.cache, pos, self.kv.tables_tensor()
        )
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        # repro: noqa-RPA001 -- the tick barrier: emitted tokens must reach
        # the host to route into per-request queues / detect EOS
        return np.array(nxt.tolist(), np.int32)

    def _admit_one(self, req: Request) -> bool:
        slot = self.kv.alloc_slot()
        assert slot is not None
        plen = req.metrics.prompt_len
        # decode writes go to plen .. plen+n-2; keep them inside the cache
        budget = min(req.max_new_tokens, self.max_len - plen + 1)
        cached = self.kv.try_admit(slot, req.prompt, budget=budget, chunk=self.chunk)
        if cached is None:
            self.kv.free_slot(slot)  # owns no blocks yet; just re-parks
            self.metrics.admission_deferrals += 1
            if self.tracer.enabled:
                self.tracer.event("admission_deferral", track="scheduler", rid=req.rid,
                                  prompt_len=plen, blocks_free=self.kv.blocks_free)
            return False
        req.metrics.t_admit = self.clock()
        if self.tracer.enabled:
            self.tracer.event("prefix_hit" if cached else "prefix_miss", track="scheduler",
                              rid=req.rid, prompt_len=plen, cached_tokens=cached)
        logits, self.kv.cache, n_chunks = self.prefill(
            self.params, self.kv.cache, self.kv.tables[slot], req.prompt, cached,
            trace_track=f"slot{slot}", rid=req.rid,
        )
        self.metrics.prefills += 1
        self.metrics.prefill_chunks += n_chunks
        self.metrics.prefix_prompt_tokens += plen
        self.metrics.prefix_hit_tokens += cached
        self.metrics.prefix_evictions = self.kv.evictions
        self.metrics.record_blocks(self.kv.blocks_in_use, bytes_in_use=self.kv.kv_bytes_in_use)
        # publish this prompt's full blocks before any chance of freeing
        self.kv.register_prompt(slot, req.prompt)
        # repro: noqa-RPA001 -- admission emits the prefill token to the host
        t0 = int(torch.argmax(logits[0, -1]).item())
        st = _SlotState(req=req, remaining=budget, emitted=[])
        done = self._emit(st, t0)
        self._trace_admission(req, slot, cached_tokens=cached, n_chunks=n_chunks)
        if done:
            self._finish(req, st, slot)
            self.kv.free_slot(slot)
            return True
        self._slots[slot] = st
        self._tok[slot] = t0
        self._pos[slot] = plen
        self._spec_admit(slot, req)
        return True

    # -- speculative hooks --------------------------------------------------

    def _spec_verify_api(self):
        return self.api.decode_verify_paged

    def _spec_operands(self):
        # the LIVE tables at round time: admissions and releases between
        # rounds repoint rows, and a window overhanging a row's reserved span
        # lands in the parking block (tables default to it)
        return (self.kv.tables_tensor(),)


@torch.inference_mode()
def replay_arrivals(
    sched: SlotScheduler,
    timed_requests,
    *,
    submit: Optional[Callable[[Request, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Tuple[List[Request], float]:
    """Open-loop arrival replay: tick the scheduler, submitting each request
    the moment its arrival offset elapses (``launch/serve.py
    --arrival-rate``).

    ``timed_requests`` is ``[(arrival_offset_s, Request), ...]`` sorted by
    offset. ``submit(req, t_abs)`` (default ``sched.submit``) lets a caller
    stamp its own taps with the absolute arrival time before submission.
    When the scheduler is idle the loop sleeps until the next arrival.
    Returns ``(completed_requests, makespan_s)`` and stamps the scheduler's
    run metrics (t_start / t_end / prefill_compiles), as ``run`` does.
    """
    clock = sched.clock
    pending = list(timed_requests)
    t0 = clock()
    if sched.metrics.t_start is None:
        sched.metrics.t_start = t0
    while pending or sched.has_work:
        now = clock() - t0
        while pending and pending[0][0] <= now:
            t_arr, req = pending.pop(0)
            if submit is not None:
                submit(req, t0 + t_arr)
            else:
                sched.submit(req)
        if not sched.tick() and pending:
            sleep(max(0.0, pending[0][0] - (clock() - t0)))
    t_end = clock()
    sched.metrics.t_end = t_end
    sched.metrics.prefill_compiles = sched.window_prefill_compiles()
    sched.metrics.publish()
    done, sched.completed = sched.completed, []
    return done, t_end - t0
