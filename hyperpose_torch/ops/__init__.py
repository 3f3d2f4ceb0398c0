"""Decoder ops and the CUDA kernels behind them (import the submodules
directly; nothing is built or loaded at import)."""
