"""Input pipelines of the port (synthetic token streams)."""
