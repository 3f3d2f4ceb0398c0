"""Serving runtime (import `runtime.engine` directly)."""
