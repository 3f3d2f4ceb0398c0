"""hyperpose-torch: the PyTorch / CUDA port of hyperpose-tpu.

Runs the flagship serving path (TinyVGG Lightweight-OpenPose -> PAF decode ->
PoseEngine, and the StreamProcessor frame server on top) on an NVIDIA GPU, in
the three exact serving forms of the checkpoint, with hand-written CUDA
kernels for the decoder's peak front ends and line-integral gather and for
the fused stem's conv1+pool. `hyperpose_tpu/` is the reference it is checked
against. Importing the package loads no submodule:

    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.runtime.stream import StreamProcessor
"""

__version__ = "0.1.0"
