"""Host-side utilities of the port: TOML writing."""
