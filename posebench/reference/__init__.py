"""The plain reference: plain PyTorch, float32 with TF32 off. It imports
nothing of the port."""
