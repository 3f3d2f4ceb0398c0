"""hyperpose-torch: the PyTorch / CUDA port of hyperpose-tpu.

Runs the flagship serving path (TinyVGG Lightweight-OpenPose -> PAF decode ->
PoseEngine) in the three exact serving forms of the checkpoint, the rest of
the OpenPose family on the same PAF step (Lightweight-OpenPose on its other
backbones, CMU OpenPose, MobileNet-Thin and -Small OpenPose), PifPaf and
PoseProposal serving (each through its `fused_decode`), int8 serving of any
of them (`quant.py`), and the StreamProcessor frame server on top, on an
NVIDIA GPU, with hand-written CUDA kernels for the PAF decoder's peak front
ends and limb scoring, the fused stem's conv1+pool, PifPaf's skeleton
growth, and the int8 convs (dense and depthwise). `hyperpose_tpu/` is the reference it is checked against. Importing
the package loads no submodule:

    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.runtime.stream import StreamProcessor
"""

__version__ = "0.1.0"
