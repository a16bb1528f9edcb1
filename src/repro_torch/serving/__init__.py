"""Serving stack of the port: Engine, the paged pool and its scheduler,
and LLMServer with its paged and fused backends."""
