"""The result cache of the port: content-addressed per-document results.

`results` holds the persistence layer (keying, one SQLite database of
entries read and written a run at a time, corrupt-entry-is-a-miss
loads); the validate wiring lives with its caller in `ops/backend.py`
(`_result_cache_setup`, `_replay_cached_doc`, `_result_cache_store`).
"""

from .results import (  # noqa: F401
    DB_NAME,
    RESULT_COUNTERS,
    RESULT_SCHEMA_VERSION,
    config_hash,
    doc_digest,
    load_entries,
    reset_result_cache_stats,
    result_cache_dir,
    result_cache_stats,
    result_key,
    set_delta_gauge,
    store_entries,
)
