"""Index lifecycle (counterpart of ``repro.index``): ``snapshot`` (the
versioned on-disk format), ``lifecycle.OnlineIndex`` (growth, free-slot
ledger, compaction, micro-batched ingest, save/load) and
``router.ShardedIndex`` (one catalog over S shards, and their collapse by
the divide-and-conquer merge)."""

from repro_torch.index import snapshot  # noqa: F401
from repro_torch.index.lifecycle import OnlineIndex  # noqa: F401
from repro_torch.index.router import ShardedIndex  # noqa: F401
