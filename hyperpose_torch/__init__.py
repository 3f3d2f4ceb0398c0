"""hyperpose-torch: the PyTorch / CUDA port of hyperpose-tpu.

Runs the flagship serving path (TinyVGG Lightweight-OpenPose -> PAF decode ->
PoseEngine) in the three exact serving forms of the checkpoint, the rest of
the OpenPose family on the same PAF step (Lightweight-OpenPose on its other
backbones, CMU OpenPose, MobileNet-Thin and -Small OpenPose), PifPaf and
PoseProposal serving (each through its `fused_decode`), int8 serving of any
of them (`quant.py`), and the StreamProcessor frame server on top, on an
NVIDIA GPU, with hand-written CUDA kernels for the PAF decoder's peak front
ends and limb scoring, the fused stem's conv1+pool, PifPaf's skeleton
growth, and the int8 convs (dense and depthwise). `hyperpose_tpu/` is the reference it is checked against. The
JAX package's serving facade has its counterpart (`Config`, `Model`, the CLI
`python -m hyperpose_torch.cli`, `PoseEngine.save` / `load_executable`, the
TensorFlow `.pb` / `.tflite` exports of `utils/export.py`). Importing the
package loads no submodule; `Config`, `Model` and `Dataset` (the data
module `data/base.py`: `Dataset.get_dataset(config)`) load on first use:

    from hyperpose_torch import Config, Model, Dataset
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.runtime.stream import StreamProcessor
"""
import importlib

__version__ = "0.1.0"

_FACADE = {"Config": ".config", "Model": ".models", "Dataset": ".data.base"}


def __getattr__(name: str):
    """`Config`, `Model` and `Dataset`, the JAX package's names for the
    config, model and dataset modules, imported on first use (PEP 562)."""
    if name in _FACADE:
        return importlib.import_module(_FACADE[name], __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
