"""Serving engines (port of ``repro/serve/engine.py``): the slot engines
and the static packed-batch engine.

``ServeEngine`` fronts three scheduling policies with one queue/submit/run
API:

- ``engine="continuous"``: a fixed decode batch of ``n_slots`` rows over a
  dense per-slot KV pool, bucketed whole-prompt prefill spliced into a
  slot, slots freed the moment a request finishes.
- ``engine="paged"``: the same loop over a paged KV block pool with
  shared-prefix reuse and chunked prefill. With fp KV it emits the same
  tokens as ``continuous`` (the reference's claim, checked by the tests).
- ``engine="static"``: the packed-batch drainer. Up to ``batch_size``
  requests are left-padded to a shared length, prefilled together and
  decoded greedily to completion before the next group is admitted. It
  serves what the slot schedulers cannot: mixture of experts (capacity
  routing couples the rows of a batch), sliding windows (a ring cache
  shorter than max_len), the recurrent families (hybrid, xlstm: their
  states are no KV slots; the left pads run through the recurrences, as in
  the reference) and the encoder-decoder family (its cross cache and the
  packed batch's ``extra_batch`` frames). It uses no part of the model
  but ``prefill`` and ``decode_step``, and the tree the family's
  ``layer_views`` makes. Its decode loop stops once every row is done and
  never writes past the cache's end. Speculation is rejected.
- ``engine="auto"`` resolves as the reference does: ``continuous`` when the
  architecture supports the slot scheduler, else ``static``.

``spec_draft=(draft_api, draft_params, draft_arch)`` with ``spec_k > 1``
turns on speculative decoding on either slot engine: greedy outputs stay
token for token those of target-only decode. ``from_trained`` also takes a
preset string ("dense", "bika", "bnn", "qnn8", "small"), resolved through
``serve.spec.build_draft_from_train``.

``ServeEngine.from_trained`` is the train->deploy step: every linear leaf
of a trained tree converts through its backend's ``to_serve``
(``core.convert.tree_to_serve``) and the serve-phase model is built around
the result.

Observability, as in the reference: ``tracer`` and ``registry`` go to the
scheduler (``obs/trace.py``, ``obs/registry.py``), and ``profile_sample >
0`` builds ``obs.profile.StepTimer(profile_sample, tracer=tracer)``, which
phase-times every Nth tick (``engine.profiler``; None when off). The
static engine has no scheduler, so no tracer events and no RunMetrics
(``engine.metrics`` is None), as in the reference. Its packed-batch extra
inputs (``run(extra_batch={"frames": ...})``, the encdec family's frame
embeddings) join every group's prefill batch, trimmed to the group's rows
as the reference trims them: only the rows beyond the group's size go, so
every group of a drain gets the same leading rows (an 8-request drain at
batch 4 gives both groups ``frames[:4]``), kept on purpose for token
parity with the reference. A family that reads no extra key ignores it.
A slot engine refuses ``extra_batch``.

``mesh=`` (+ optional ``rules=``) serves as one rank of a tensor-parallel
mesh (``distributed.tp``, on ``torch.distributed``): the params are placed
once from the full serve tree, each rank keeping its shard (q/k/v by
heads, gate/up by ffn columns, wo and down by d_model columns, the tied
embedding by vocab rows), the KV caches hold the rank's kv heads, and
every model call runs under the rank's group. Every rank runs the same
engine on the same requests; outputs are token for token those of one
process. The lm family without experts or a window is served so, on all
three engines; another architecture, speculation and a mesh whose "data"
axis is larger than 1 raise (ROADMAP Queue 1).

The engine runs on CUDA unless ``device="cpu"`` is passed; without a GPU
and without that request it raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.convert import tree_to_serve
from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.tp import shard_serve_params, tp_group
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig, ModelAPI, views_of
from repro_torch.obs.profile import StepTimer
from repro_torch.serve.scheduler import (
    PagedSlotScheduler,
    Request,
    SlotScheduler,
    scheduler_supports,
)

__all__ = ["Request", "ServeEngine", "serve_batch", "serve_params_from_train"]


def serve_params_from_train(train_params, spec):
    """Trained float params (any model tree) -> hardware serve form."""
    return tree_to_serve(train_params, spec)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class ServeEngine:
    def __init__(
        self,
        api: ModelAPI,
        params,
        arch: ArchConfig,
        *,
        batch_size: int = 4,
        max_len: int = 256,
        quantized_kv: bool = False,
        engine: str = "auto",
        n_slots: Optional[int] = None,
        kv_block_size: int = 16,
        kv_n_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        prefill_chunk: int = 32,
        tracer=None,
        registry=None,
        profile_sample: int = 0,
        spec_draft=None,
        spec_k: int = 1,
        device=None,
        mesh=None,
        rules=None,
    ):
        if engine not in ("auto", "static", "continuous", "paged"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "auto":
            engine = "continuous" if scheduler_supports(arch) else "static"
        if spec_draft is not None and engine not in ("continuous", "paged"):
            raise ValueError(
                f"spec_draft needs a slot-scheduler engine (continuous/paged); "
                f"got engine={engine!r}"
            )
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, rules
        self.tp = tp_group(mesh, rules)
        self.api = api
        self.arch = arch
        self.batch_size = batch_size
        self.max_len = max_len
        self.quantized_kv = quantized_kv
        self.engine = engine
        # the opt-in sampled step timer (0 = off: the scheduler keeps the
        # shared NULL_TIMER)
        self.profiler = (StepTimer(profile_sample, tracer=tracer)
                         if profile_sample and profile_sample > 0 else None)
        self.params = views_of(api, shard_serve_params(_to_device(params, self.device), arch,
                                                       self.tp))
        self.queue: List[Request] = []  # the static engine's
        if spec_draft is not None:
            dapi, dparams, darch = spec_draft
            spec_draft = (dapi, views_of(dapi, _to_device(dparams, self.device)), darch)
        common = dict(n_slots=n_slots or batch_size, max_len=max_len,
                      quantized_kv=quantized_kv, device=self.device, tracer=tracer,
                      registry=registry, profiler=self.profiler, spec_draft=spec_draft,
                      spec_k=spec_k, mesh=mesh, rules=rules)
        self.scheduler = None
        if engine == "paged":
            self.scheduler = PagedSlotScheduler(
                api, self.params, arch, block_size=kv_block_size, n_blocks=kv_n_blocks,
                prefix_cache=prefix_cache, chunk=prefill_chunk, **common)
        elif engine == "continuous":
            self.scheduler = SlotScheduler(api, self.params, arch, **common)

    @classmethod
    def from_trained(cls, train_params, arch: ArchConfig, *, batch_size: int = 4,
                     max_len: int = 256, quantized_kv: bool = False, **kw) -> "ServeEngine":
        """Build a serve-phase engine from a trained tree: convert every
        linear leaf through its registered backend's ``to_serve`` and
        instantiate the ``phase='serve'`` model around the result.
        ``spec_draft`` may be a preset string here: the SAME trained weights
        become the draft (``serve.spec.build_draft_from_train``)."""
        spec_draft = kw.get("spec_draft")
        if isinstance(spec_draft, str):
            from repro_torch.serve.spec import build_draft_from_train

            kw["spec_draft"] = build_draft_from_train(train_params, arch, spec_draft)
        api = build_model(arch, phase="serve")
        params = serve_params_from_train(train_params, arch.linear_spec())
        return cls(api, params, arch, batch_size=batch_size, max_len=max_len,
                   quantized_kv=quantized_kv, **kw)

    @property
    def metrics(self):
        """RunMetrics of the slot scheduler (None for static)."""
        return self.scheduler.metrics if self.scheduler is not None else None

    def submit(self, req: Request) -> None:
        if self.scheduler is not None:
            self.scheduler.submit(req)
            return
        if req.max_new_tokens < 1:
            raise ValueError(f"req {req.rid}: max_new_tokens must be >= 1")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"req {req.rid}: prompt length {len(req.prompt)} >= max_len "
                f"{self.max_len} leaves no room to generate"
            )
        self.queue.append(req)

    # -- static path --------------------------------------------------------

    def _pack(self, reqs: Sequence[Request]):
        """(B, S) tokens, each prompt left-padded with 0 to the longest (S
        >= 1): causal, so a pad only adds keys before the prompt, which its
        queries attend as the reference's do."""
        s = max(1, max(len(r.prompt) for r in reqs))
        toks = np.zeros((len(reqs), s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt
        return torch.from_numpy(toks).to(self.device), s

    @staticmethod
    def _slice_extra(extra_batch: Dict, n: int) -> Dict:
        """Trim batched extra inputs to the packed batch (the last group of
        a drain is smaller than batch_size): only rows beyond ``n`` go, so
        every group takes the same leading rows, as in the reference."""
        out = {}
        for k, v in extra_batch.items():
            if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] > n:
                v = v[:n]
            out[k] = v
        return out

    @torch.inference_mode()
    def step_batch(self, reqs: Sequence[Request], extra_batch: Optional[Dict] = None):
        """Static path: prefill and greedily decode one packed batch to
        completion; fills ``req.output``. ``extra_batch`` (the encdec
        family's frames) joins the prefill batch, trimmed by
        ``_slice_extra`` and moved to the engine's device. The host loop
        stops as soon as every row is finished (EOS or its budget), and
        decoding stops at the cache end (positions s .. max_len - 1) instead
        of overwriting its last row. Under a mesh it runs under the rank's
        group."""
        with comm.use(self.tp):
            return self._step_batch(reqs, extra_batch)

    def _step_batch(self, reqs: Sequence[Request], extra_batch: Optional[Dict]):
        tokens, s = self._pack(reqs)
        batch = {"tokens": tokens}
        if extra_batch:
            batch.update({k: torch.as_tensor(v).to(self.device) if hasattr(v, "shape") else v
                          for k, v in self._slice_extra(extra_batch, len(reqs)).items()})
        logits, cache = self.api.prefill(self.params, batch, max_len=self.max_len,
                                         quantized=self.quantized_kv)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        n_steps = max(r.max_new_tokens for r in reqs)
        n_steps = max(1, min(n_steps, self.max_len - s + 1))
        need = np.array([r.max_new_tokens for r in reqs])
        eos = np.array([-1 if r.eos_id is None else r.eos_id for r in reqs])
        # repro: noqa-RPA001 -- the host streams token ids: one sync a step (the
        # prefill's token); Queue 1 item 1 keeps the tokens on the device
        cur = tok[:, 0].cpu().numpy()
        outs = [cur]
        finished = (cur == eos) | (need <= 1)
        self._stream(reqs, cur, np.zeros(len(reqs), bool), 0, need)
        for t in range(1, n_steps):
            if finished.all():
                break
            logits, cache = self.api.decode_step(self.params, tok, cache, s + t - 1)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            cur = tok[:, 0].cpu().numpy()  # repro: noqa-RPA001 -- one sync a step; Queue 1 item 1
            self._stream(reqs, cur, finished, t, need)
            outs.append(cur)
            finished = finished | (cur == eos) | (t + 1 >= need)
        gen = np.stack(outs, axis=1)  # (B, <= n_steps)
        for i, r in enumerate(reqs):
            g = gen[i, : r.max_new_tokens]
            if r.eos_id is not None:
                hits = np.where(g == r.eos_id)[0]
                if hits.size:
                    g = g[: hits[0] + 1]
            r.output = g
        return reqs

    @staticmethod
    def _stream(reqs, cur, already_finished, t, need):
        for i, r in enumerate(reqs):
            if r.on_token is not None and not already_finished[i] and t < need[i]:
                r.on_token(int(cur[i]))

    @torch.inference_mode()
    def run(self, extra_batch: Optional[Dict] = None) -> List[Request]:
        """Drain every submitted request: through the slot scheduler, or
        (static) in groups of batch_size run to completion."""
        if self.scheduler is not None:
            if extra_batch is not None:
                raise ValueError(
                    "extra_batch is packed-batch-shaped and only supported by "
                    "the static engine (pass engine='static')"
                )
            return self.scheduler.run()
        done: List[Request] = []
        while self.queue:
            batch, self.queue = self.queue[: self.batch_size], self.queue[self.batch_size:]
            done.extend(self.step_batch(batch, extra_batch))
        return done


@torch.inference_mode()
def serve_batch(api: ModelAPI, params, prompts: torch.Tensor, *, max_new_tokens: int = 8,
                max_len: Optional[int] = None) -> torch.Tensor:
    """One-shot greedy decode of a (B, S) prompt batch (no padding, no
    early stop): (B, max_new_tokens) int32 tokens."""
    b, s = prompts.shape
    ml = max_len or (s + max_new_tokens)
    params = views_of(api, params)
    logits, cache = api.prefill(params, {"tokens": prompts}, max_len=ml)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks = [tok]
    for t in range(1, max_new_tokens):
        logits, cache = api.decode_step(params, tok, cache, s + t - 1)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1)
