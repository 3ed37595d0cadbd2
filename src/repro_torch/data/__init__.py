"""Detection data sources (numpy only): port-owned copies of ``repro.data``."""
