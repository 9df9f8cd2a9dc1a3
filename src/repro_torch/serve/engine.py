"""Serving engine (port of ``repro/serve/engine.py``, slot engines).

``ServeEngine`` fronts the slot schedulers (serve/scheduler.py) with one
queue/submit/run API:

- ``engine="continuous"``: a fixed decode batch of ``n_slots`` rows over a
  dense per-slot KV pool, bucketed whole-prompt prefill spliced into a
  slot, slots freed the moment a request finishes.
- ``engine="paged"``: the same loop over a paged KV block pool with
  shared-prefix reuse and chunked prefill. With fp KV it emits the same
  tokens as ``continuous`` (the reference's claim, checked by the tests).
- ``engine="auto"`` resolves as the reference does: ``continuous`` when the
  architecture supports the slot scheduler. ``"static"`` (the reference's
  packed-batch drainer) is not ported and raises.

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
phase-times every Nth tick (``engine.profiler``; None when off).

The engine runs on CUDA unless ``device="cpu"`` is passed; without a GPU
and without that request it raises.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.convert import tree_to_serve
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig, ModelAPI
from repro_torch.models.lm import split_layers
from repro_torch.obs.profile import StepTimer
from repro_torch.serve.scheduler import (
    PagedSlotScheduler,
    Request,
    SlotScheduler,
    scheduler_supports,
)

__all__ = ["Request", "ServeEngine", "serve_params_from_train"]


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
        if engine == "static":
            raise NotImplementedError(
                "engine='static' is not ported; the port serves engine='continuous' or 'paged'"
            )
        self.device = resolve_device(device)
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
        self.params = split_layers(_to_device(params, self.device))
        if spec_draft is not None:
            dapi, dparams, darch = spec_draft
            spec_draft = (dapi, split_layers(_to_device(dparams, self.device)), darch)
        common = dict(n_slots=n_slots or batch_size, max_len=max_len,
                      quantized_kv=quantized_kv, device=self.device, tracer=tracer,
                      registry=registry, profiler=self.profiler, spec_draft=spec_draft,
                      spec_k=spec_k)
        if engine == "paged":
            self.scheduler = PagedSlotScheduler(
                api, self.params, arch, block_size=kv_block_size, n_blocks=kv_n_blocks,
                prefix_cache=prefix_cache, chunk=prefill_chunk, **common)
        else:
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
        return self.scheduler.metrics

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    @torch.inference_mode()
    def run(self) -> List[Request]:
        """Drain every submitted request through the slot scheduler."""
        return self.scheduler.run()
