"""Model numerics of the port (the llama and gemma2 paths: dense, paged
and packed)."""
