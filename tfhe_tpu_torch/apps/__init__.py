"""Applications built on the port's layers (FHE Trivium)."""
