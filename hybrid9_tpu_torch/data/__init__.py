"""Data ingest: synthetic generators, soil-property and forcing pipelines."""
