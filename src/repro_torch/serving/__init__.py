"""Serving stack of the port: Engine, LLMServer and its fused backend."""
