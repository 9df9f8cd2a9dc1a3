"""Paged KV cache: block pool + block tables + shared-prefix reuse (port of
``repro/serve/paged_kv.py``; the host logic is the reference's line for
line).

``PagedKVManager`` owns ONE device-resident block pool per the
``models/base.PagedKVLayout`` contract — every leaf ``(n_layers,
n_phys_blocks, block_size, kv_heads, hd)`` — and gives each slot a
host-side block table naming which physical blocks hold its logical
positions ``[0, max_len)``:

- allocation is block-granular (heap free list); a request's whole span is
  reserved at admission, so decode never allocates mid-flight and
  backpressure is an admission-time "not yet" (``try_admit`` returns None
  and mutates nothing);
- prompts are content-hashed per full block with a chained SHA-256, so a
  hash hit guarantees the whole prefix matches; matching blocks attach with
  a refcount bump; the block holding the final prompt token stays private;
- copy-on-write: ``ensure_private`` copies a shared block into a fresh one
  (a tensor index copy across every layer) before the writer's table is
  repointed;
- LRU eviction over refcount-zero cached blocks.

With an enabled ``tracer`` an eviction emits a ``prefix_eviction`` event
and a copy-on-write a ``cow_copy`` event, as in the reference.

Physical block ``n_phys - 1`` is the reserved parking block that inactive
decode rows write junk into.

With ``mesh=`` (+ ``rules=``) the pool holds this tensor-parallel rank's kv
heads, exactly as the dense contract shards (``serve/kv.py``); the block
tables and every host decision are the same on every rank.
"""
from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import comm
from repro_torch.distributed.tp import tp_group
from repro_torch.models.base import PagedKVLayout, paged_kv_layout
from repro_torch.obs.trace import NULL_TRACER

__all__ = ["PagedKVManager", "hash_prompt_blocks"]


def hash_prompt_blocks(prompt: np.ndarray, block_size: int) -> List[bytes]:
    """Chained content hashes for each FULL block of ``prompt``: block i's
    digest commits to tokens [0, (i+1)*block_size)."""
    prompt = np.ascontiguousarray(prompt, np.int32)
    out: List[bytes] = []
    h = b""
    for i in range(len(prompt) // block_size):
        h = hashlib.sha256(h + prompt[i * block_size:(i + 1) * block_size].tobytes()).digest()
        out.append(h)
    return out


def _copy_block(cache, src: int, dst: int) -> None:
    """Copy physical block ``src`` -> ``dst`` on every leaf and layer, in
    place (the block axis is dim 1)."""
    for buf in cache.values():
        buf[:, dst].copy_(buf[:, src])


class PagedKVManager:
    def __init__(
        self,
        api,
        *,
        n_slots: int,
        max_len: int,
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        quantized: bool = False,
        device=None,
        tracer=None,
        mesh=None,
        rules=None,
    ):
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be a multiple of block_size {block_size}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = max_len // block_size
        self.n_blocks = n_blocks if n_blocks is not None else n_slots * self.blocks_per_slot
        if self.n_blocks < self.blocks_per_slot:
            raise ValueError(
                f"n_blocks {self.n_blocks} cannot cover one slot's "
                f"{self.blocks_per_slot} blocks — no request could ever admit"
            )
        self.prefix_cache = prefix_cache
        self.quantized = quantized
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # +1 physical row: the reserved parking block for inactive decode rows
        self.parking_block = self.n_blocks
        with comm.use(tp_group(mesh, rules)):
            self.cache = api.init_cache(self.n_blocks + 1, block_size, quantized=quantized,
                                        device=device)
        self.layout: PagedKVLayout = paged_kv_layout(self.cache)
        assert self.layout.n_phys_blocks == self.n_blocks + 1, self.layout
        assert self.layout.block_size == block_size, self.layout
        # -- host state --------------------------------------------------
        self._slot_free_heap: List[int] = list(range(n_slots))
        self._slot_free_set = set(self._slot_free_heap)
        self._free_heap: List[int] = list(range(self.n_blocks))
        self._free_set = set(self._free_heap)
        self._ref = np.zeros(self.n_blocks, np.int64)
        self._slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
        self.tables = np.full((n_slots, self.blocks_per_slot), self.parking_block, np.int32)
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # -- gauges ------------------------------------------------------
        self.evictions = 0
        self.cow_copies = 0

    # -- introspection ------------------------------------------------------

    @property
    def n_free_slots(self) -> int:
        return len(self._slot_free_set)

    @property
    def blocks_free(self) -> int:
        return len(self._free_set)

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - self.blocks_free

    @property
    def bytes_per_block(self) -> int:
        """Device bytes one physical block costs across every leaf and layer."""
        return sum(
            leaf.numel() * leaf.element_size() // self.layout.n_phys_blocks
            for leaf in self.cache.values()
        )

    @property
    def pool_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size() for leaf in self.cache.values())

    @property
    def kv_bytes_in_use(self) -> int:
        return self.bytes_per_block * self.blocks_in_use

    @property
    def bytes_per_token(self) -> float:
        return self.bytes_per_block / self.block_size

    # -- slot bookkeeping ---------------------------------------------------

    def alloc_slot(self) -> Optional[int]:
        if not self._slot_free_set:
            return None
        slot = heapq.heappop(self._slot_free_heap)
        self._slot_free_set.discard(slot)
        return slot

    def free_slot(self, slot: int) -> None:
        """Release a slot: owned blocks drop a ref; registered blocks at
        refcount zero go to the LRU, private ones to the free list."""
        if slot in self._slot_free_set:
            raise ValueError(f"double free of slot {slot}")
        for b in self._slot_blocks[slot]:
            self._unref(b)
        self._slot_blocks[slot] = []
        self.tables[slot, :] = self.parking_block
        heapq.heappush(self._slot_free_heap, slot)
        self._slot_free_set.add(slot)

    # -- block primitives ---------------------------------------------------

    def _unref(self, block: int) -> None:
        self._ref[block] -= 1
        assert self._ref[block] >= 0, f"refcount underflow on block {block}"
        if self._ref[block] == 0:
            if block in self._block_hash:
                self._lru[block] = None
            else:
                heapq.heappush(self._free_heap, block)
                self._free_set.add(block)

    def _unregister(self, block: int) -> None:
        h = self._block_hash.pop(block, None)
        if h is not None and self._hash_to_block.get(h) == block:
            del self._hash_to_block[h]

    def _alloc_block(self) -> int:
        """Claim a fresh block: free list first, then evict the LRU cached one."""
        if self._free_set:
            b = heapq.heappop(self._free_heap)
            self._free_set.discard(b)
        else:
            b, _ = self._lru.popitem(last=False)
            self._unregister(b)
            self.evictions += 1
            if self.tracer.enabled:
                self.tracer.event("prefix_eviction", block=b, blocks_cached=len(self._lru))
        self._ref[b] = 1
        return b

    # -- admission ----------------------------------------------------------

    def match_prefix(self, prompt: np.ndarray) -> List[int]:
        """Longest chain of cached blocks matching the prompt's full blocks,
        capped so the final prompt token is always recomputed."""
        if not self.prefix_cache:
            return []
        limit = (len(prompt) - 1) // self.block_size
        matched: List[int] = []
        for h in hash_prompt_blocks(prompt, self.block_size)[:limit]:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            matched.append(b)
        return matched

    def plan_span(self, prompt_len: int, budget: int, chunk: int, cached_len: int) -> int:
        """Last logical position + 1 this request will ever write."""
        n_chunks = -(-(max(prompt_len - cached_len, 1)) // chunk)
        chunk_end = min(cached_len + n_chunks * chunk, self.max_len)
        return max(chunk_end, min(prompt_len + budget - 1, self.max_len))

    def try_admit(self, slot: int, prompt: np.ndarray, *, budget: int,
                  chunk: int) -> Optional[int]:
        """Build ``slot``'s block table; returns the number of prompt tokens
        served from the prefix cache, or None (nothing mutated) when blocks
        run short."""
        assert slot not in self._slot_free_set and not self._slot_blocks[slot]
        matched = self.match_prefix(prompt)
        cached_len = len(matched) * self.block_size
        span = self.plan_span(len(prompt), budget, chunk, cached_len)
        n_total = -(-span // self.block_size)
        need = n_total - len(matched)
        matched_set = set(matched)
        evictable = sum(1 for b in self._lru if b not in matched_set)
        if need > len(self._free_set) + evictable:
            return None
        for b in matched:
            if self._ref[b] == 0:
                self._lru.pop(b)
            self._ref[b] += 1
        blocks = matched + [self._alloc_block() for _ in range(need)]
        self._slot_blocks[slot] = blocks
        self.tables[slot, :] = self.parking_block
        self.tables[slot, :n_total] = blocks
        return cached_len

    def register_prompt(self, slot: int, prompt: np.ndarray) -> int:
        """Publish the slot's full prompt blocks into the prefix map."""
        if not self.prefix_cache:
            return 0
        n = 0
        for i, h in enumerate(hash_prompt_blocks(prompt, self.block_size)):
            b = self._slot_blocks[slot][i]
            if h in self._hash_to_block or b in self._block_hash:
                continue
            self._hash_to_block[h] = b
            self._block_hash[b] = h
            n += 1
        return n

    # -- copy-on-write ------------------------------------------------------

    def ensure_private(self, slot: int, index: int) -> int:
        """Make table entry ``index`` of ``slot`` safe to mutate: a shared
        block is copied into a fresh one; an exclusively owned but published
        block is unregistered. Returns the (possibly new) block id."""
        b = self._slot_blocks[slot][index]
        if self._ref[b] > 1:
            if not self._free_set and not self._lru:
                raise RuntimeError("copy-on-write with no free or evictable block")
            nb = self._alloc_block()
            _copy_block(self.cache, b, nb)
            self._ref[b] -= 1
            self._slot_blocks[slot][index] = nb
            self.tables[slot, index] = nb
            self.cow_copies += 1
            if self.tracer.enabled:
                self.tracer.event("cow_copy", slot=slot, index=index, src_block=b, dst_block=nb)
            return nb
        if b in self._block_hash:
            self._unregister(b)
        return b

    def tables_tensor(self) -> torch.Tensor:
        """The host block tables as an int32 tensor on the pool's device."""
        return torch.from_numpy(self.tables.copy()).to(self.cache["k"].device)
