"""Sampled per-query tracing (stdlib only): the engine and the executor
open ``plan``/``compile``/``execute`` spans under the current trace."""
