"""Model numerics of the port (dense llama path)."""
