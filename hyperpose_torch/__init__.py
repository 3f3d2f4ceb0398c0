"""hyperpose-torch: the PyTorch / CUDA port of hyperpose-tpu.

Runs the flagship serving path (TinyVGG Lightweight-OpenPose -> PAF decode ->
PoseEngine) in the three exact serving forms of the checkpoint, PifPaf
serving (ResNet50 -> composite-field decode -> PoseEngine through
`fused_decode`), int8 serving of either (`quant.py`), and the
StreamProcessor frame server on top, on an NVIDIA GPU, with hand-written
CUDA kernels for the PAF decoder's peak front ends and line-integral gather,
the fused stem's conv1+pool, PifPaf's skeleton growth and the int8 convs'
GEMM. `hyperpose_tpu/` is the reference it is checked against. Importing
the package loads no submodule:

    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.runtime.stream import StreamProcessor
"""

__version__ = "0.1.0"
