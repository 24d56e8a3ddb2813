"""Host-side video ingest."""
