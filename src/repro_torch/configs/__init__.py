"""Model configurations (one module per architecture)."""
