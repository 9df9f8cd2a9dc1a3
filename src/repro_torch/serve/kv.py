"""KV slot manager for continuous batching (port of ``repro/serve/kv.py``).

Owns ONE device-resident dense KV cache shaped per the ``KVCacheLayout``
contract — every leaf ``(n_layers, n_slots, max_len, n_kv_heads,
head_dim)`` (fp, or int8 + scale) — and treats the batch axis as a pool of
request slots:

- ``alloc()`` / ``free(slot)``: host-side bookkeeping, a min-heap plus a
  membership set (lowest index first, double-free detection). Freeing does
  not zero the slot: a new request's prefill rewrites ``[0, max_len)`` of
  its row, and decode writes position ``p`` before any query attends it.
- ``write_prefill(slot, prefill_cache)``: splice a batch-1 prefill cache
  (leaves ``(n_layers, 1, max_len, ...)``) into the slot row, in place.

With ``mesh=`` (+ ``rules=``) the pool holds this tensor-parallel rank's
kv heads, per the layout contract's ``kv_heads`` axis
(``distributed.sharding.kv_cache_shardings``: a head count that does not
divide the model axis keeps every head, replicated): the slot splice and
per-row writes stay local to the rank.

Runs on CUDA unless ``device="cpu"`` is passed; raises without a GPU.
"""
from __future__ import annotations

import heapq
from typing import List, Optional

from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.tp import tp_group
from repro_torch.models.base import KVCacheLayout, kv_cache_layout

__all__ = ["KVSlotManager"]


class KVSlotManager:
    def __init__(self, api, *, n_slots: int, max_len: int, quantized: bool = False,
                 device=None, mesh=None, rules=None):
        self.n_slots = n_slots
        self.max_len = max_len
        self.quantized = quantized
        self.device = resolve_device(device)
        with comm.use(tp_group(mesh, rules)):
            self.cache = api.init_cache(n_slots, max_len, quantized=quantized,
                                        device=self.device)
        self.layout: KVCacheLayout = kv_cache_layout(self.cache)
        assert self.layout.n_slots == n_slots and self.layout.max_len == max_len, self.layout
        self._free_heap: List[int] = list(range(n_slots))
        self._free_set = set(self._free_heap)

    # -- slot bookkeeping ---------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free_set)

    @property
    def pool_bytes(self) -> int:
        """Bytes of the pool this process holds (a rank's heads under a mesh)."""
        return sum(leaf.numel() * leaf.element_size() for leaf in self.cache.values())

    def alloc(self) -> Optional[int]:
        """Claim a free slot (lowest index first); None when fully occupied."""
        if not self._free_set:
            return None
        slot = heapq.heappop(self._free_heap)
        self._free_set.discard(slot)
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self._free_set:
            raise ValueError(f"double free of slot {slot}")
        heapq.heappush(self._free_heap, slot)
        self._free_set.add(slot)

    # -- device ops ---------------------------------------------------------

    def write_prefill(self, slot: int, prefill_cache) -> None:
        """Copy a batch-1 prefill cache (leaves (L, 1, max_len, ...)) into row
        ``slot``, in place. The prefill must have been run with the pool's
        ``max_len`` and quantization, so leaf shapes and dtypes line up."""
        pl = kv_cache_layout(prefill_cache)
        if pl.n_slots != 1 or pl.max_len != self.max_len or set(prefill_cache) != set(self.cache):
            raise ValueError(f"prefill cache layout {pl} does not match pool {self.layout}")
        for name, buf in self.cache.items():
            buf[:, slot] = prefill_cache[name][:, 0].to(buf.dtype)
