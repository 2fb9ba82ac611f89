"""Cross-process helpers (single process for now: data parallelism is
not ported)."""
