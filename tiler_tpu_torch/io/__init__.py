"""Host-side video ingest and export."""
