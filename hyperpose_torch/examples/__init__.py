"""The JAX package's example programs (`examples/*.py`, `python_demo.py`) on
the PyTorch port, one module each under the same name. Run them from the
repository root, for example:

    python -m hyperpose_torch.examples.tutorial_minimum image.jpg --device cpu

Each takes `--device` (cuda by default, cpu when asked). Without `--weights`
the networks get seeded random weights (`utils/weights.py`
`random_flax_weights`), where the JAX examples take flax's PRNGKey(0)
initialization, which PyTorch cannot reproduce.
"""
from __future__ import annotations

from hyperpose_torch import Model

POST_TO_MODEL = {"paf": "LightweightOpenpose", "ppn": "PoseProposal", "pifpaf": "Pifpaf"}


def engine_for(cfg, weights=None, device: str = "cuda", **kwargs):
    """The `PoseEngine` of a config: `Model.get_model`, the npz `weights` (or
    seeded random ones), the family's fused step and topology, on
    `device`."""
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.utils.weights import random_flax_weights

    model = Model.get_model(cfg)
    return PoseEngine(
        model, weights or random_flax_weights(model, seed=0),
        input_hw=(cfg.model.hin, cfg.model.win), topology=Model.get_topology(cfg),
        fused_decode=Model._fused_decode_for(cfg, model), device=device, **kwargs,
    )
