"""Shape-bucketed and chunked prefill (port of
``repro/serve/compile_cache.py``: ``bucket_for``, ``BucketedPrefill``,
``ChunkedPrefill``).

The reference compiles one program per prompt-length bucket (continuous
engine) or ONE ``(1, chunk)`` program (paged engine) and counts its cache
misses. The port runs both eagerly: nothing is compiled. ``misses`` counts
the distinct shapes run (each bucket once; 0 for the chunk loop, whose one
shape has no program to build), so the bucketed count matches the
reference's compile count (CUDA graphs of these shapes come in a later
slice).

With ``mesh=`` (+ ``rules=``) each call runs under the mesh's
tensor-parallel group (``distributed.tp``): the params and the pool must
be this rank's, as the scheduler places them.
"""
from __future__ import annotations

from typing import Optional, Set

import numpy as np
import torch

from repro_torch.distributed import comm
from repro_torch.distributed.tp import tp_group
from repro_torch.obs.trace import NULL_TRACER

__all__ = ["BucketedPrefill", "ChunkedPrefill", "bucket_for"]


def bucket_for(prompt_len: int, max_len: int, *, min_bucket: int = 16) -> int:
    """Smallest power of two >= prompt_len (floored at min_bucket, capped at
    max_len: the terminal bucket is max_len itself, pow2 or not)."""
    if prompt_len > max_len:
        raise ValueError(f"prompt_len {prompt_len} exceeds max_len {max_len}")
    b = max(min_bucket, 1 << max(prompt_len - 1, 0).bit_length())
    return min(b, max_len)


class BucketedPrefill:
    """Whole-prompt prefill of one request, right-padded to its length
    bucket. Right padding is exact under causal attention: the pad tokens sit
    in the future of every real token, so the real prefix's K/V and the
    logits at ``prompt_len - 1`` equal an unpadded prefill's. The emitted
    cache covers the pool's full ``max_len`` (leaves ``(L, 1, max_len,
    ...)``), so the slot splice has one shape."""

    def __init__(self, api, *, max_len: int, quantized: bool = False, tracer=None,
                 mesh=None, rules=None):
        self.api = api
        self.max_len = max_len
        self.quantized = quantized
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._buckets: Set[int] = set()
        self._tp = tp_group(mesh, rules)

    @property
    def misses(self) -> int:
        """Distinct buckets run: the reference's compile count."""
        return len(self._buckets)

    def bucket_for(self, prompt_len: int) -> int:
        return bucket_for(prompt_len, self.max_len)

    def __call__(self, params, prompt: np.ndarray):
        """One un-padded int32 prompt -> ``(first_logits (1, 1, V), cache)``:
        the logits after the last real token and the max_len-long cache."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        bucket = self.bucket_for(plen)
        first = bucket not in self._buckets
        self._buckets.add(bucket)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = prompt  # right-pad: exact under causal attention
        dev = params["embed"]["table"].device
        t0 = self.tracer.clock() if self.tracer.enabled else 0.0
        with comm.use(self._tp):
            out = self.api.prefill(
                params, {"tokens": torch.from_numpy(toks).to(dev)}, max_len=self.max_len,
                quantized=self.quantized,
                last_index=torch.tensor([plen - 1], dtype=torch.int32, device=dev),
            )
        if self.tracer.enabled and first:
            self.tracer.add_span("compile", "scheduler", t0, self.tracer.clock(),
                                 kind="prefill_bucket", bucket=bucket, batch=1)
        return out


class ChunkedPrefill:
    """Append a prompt to the pool ``chunk`` tokens at a time through
    ``api.prefill_chunk``. Each chunk's queries attend the pool, so later
    chunks see earlier chunks' (and any shared prefix's) cached KV; the
    final chunk is right-padded, exact under causal attention."""

    def __init__(self, api, *, chunk: int, max_len: int, tracer=None, mesh=None, rules=None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.api = api
        self.chunk = chunk
        self.max_len = max_len
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._tp = tp_group(mesh, rules)
        self.misses = 0  # programs compiled: none, the chunk loop runs eagerly
        self._ran = False  # the first chunk ever run (the trace's compile span)

    def __call__(self, params, cache, table_row: np.ndarray, prompt: np.ndarray,
                 cached_len: int = 0, *, trace_track: Optional[str] = None,
                 rid: Optional[int] = None):
        """Append ``prompt[cached_len:]``; returns ``(last_logits (1,1,V),
        cache, n_chunks)`` with the logits after the prompt's final token.
        With ``trace_track`` (the admitting slot's track) each chunk becomes
        a ``prefill_chunk`` span there."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if not 0 <= cached_len <= plen - 1:
            raise ValueError(f"cached_len {cached_len} outside [0, {plen - 1}]")
        dev = cache["k"].device
        table = torch.from_numpy(np.ascontiguousarray(table_row, np.int32).reshape(1, -1)).to(dev)
        tracer = self.tracer
        trace = tracer.enabled and trace_track is not None
        logits = None
        n_chunks = 0
        start = cached_len
        while start < plen:
            end = min(start + self.chunk, plen)
            toks = np.zeros((1, self.chunk), np.int32)
            toks[0, : end - start] = prompt[start:end]
            last = (plen - 1 - start) if end == plen else (self.chunk - 1)
            t0 = tracer.clock() if trace else 0.0
            with comm.use(self._tp):
                logits, cache = self.api.prefill_chunk(
                    params, torch.from_numpy(toks).to(dev), cache, table,
                    torch.tensor([start], dtype=torch.int32, device=dev),
                    torch.tensor([last], dtype=torch.int32, device=dev),
                )
            if trace:
                t1 = tracer.clock()
                tracer.add_span("prefill_chunk", trace_track, t0, t1,
                                rid=rid, chunk=n_chunks, start=start, end=end)
                if not self._ran:
                    tracer.add_span("compile", "scheduler", t0, t1,
                                    kind="prefill_chunk", chunk_size=self.chunk)
            self._ran = True
            n_chunks += 1
            start = end
        return logits, cache, n_chunks
