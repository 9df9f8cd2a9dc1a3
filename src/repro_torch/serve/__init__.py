"""repro_torch.serve — the serving runtime: continuous and paged slot
engines, the static packed-batch engine, speculative decoding, open-loop
arrival replay."""
from .compile_cache import BucketedPrefill, ChunkedPrefill, bucket_for
from .engine import Request, ServeEngine, serve_batch, serve_params_from_train
from .kv import KVSlotManager
from .metrics import RequestMetrics, RunMetrics
from .paged_kv import PagedKVManager, hash_prompt_blocks
from .scheduler import PagedSlotScheduler, SlotScheduler, replay_arrivals
from .spec import DRAFT_PRESETS, build_draft_from_train, draft_arch

__all__ = [
    "BucketedPrefill",
    "ChunkedPrefill",
    "DRAFT_PRESETS",
    "KVSlotManager",
    "PagedKVManager",
    "PagedSlotScheduler",
    "Request",
    "RequestMetrics",
    "RunMetrics",
    "ServeEngine",
    "SlotScheduler",
    "bucket_for",
    "build_draft_from_train",
    "draft_arch",
    "hash_prompt_blocks",
    "replay_arrivals",
    "serve_batch",
    "serve_params_from_train",
]
