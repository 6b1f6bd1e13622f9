"""Host-side pipelining (decode-ahead source, writer-thread sink)."""
