"""Pose networks in PyTorch (import the submodules directly)."""
