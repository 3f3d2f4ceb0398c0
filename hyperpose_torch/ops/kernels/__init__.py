"""Hand-written CUDA kernels, each with its wrapper, its plain PyTorch
version and its launch count. Kernels are built at first use
(`build.py`)."""
