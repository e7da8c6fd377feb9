"""Index lifecycle (counterpart of ``repro.index``): ``snapshot`` (the
versioned on-disk format) and ``lifecycle.OnlineIndex`` (growth, free-slot
ledger, compaction, micro-batched ingest, save/load).  The sharded router
is not ported yet."""

from repro_torch.index import snapshot  # noqa: F401
from repro_torch.index.lifecycle import OnlineIndex  # noqa: F401
