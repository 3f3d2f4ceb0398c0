"""hyperpose-torch: the PyTorch / CUDA port of hyperpose-tpu.

Runs the flagship serving path (TinyVGG Lightweight-OpenPose -> PAF decode ->
PoseEngine) on an NVIDIA GPU, with hand-written CUDA kernels for the decoder's
peak front end and line-integral gather. `hyperpose_tpu/` is the reference
it is checked against. Importing the package loads no submodule:

    from hyperpose_torch.runtime.engine import PoseEngine
"""

__version__ = "0.1.0"
