"""CMU OpenPose on VGG19, the plain reference (Cao et al., CVPR 2017,
arXiv:1611.08050; HyperPose's `MODEL.Openpose`), on flat flax weights.

VGG19's first ten 3x3 convs with bias and ReLU (64x2, pool, 128x2, pool,
256x4, pool, 512x2) on the image less the BGR means / 255 (the reference's
order, applied to RGB input as HyperPose does); `cpm1` (256) and `cpm2`
(128), 3x3 with ReLU; an initial stage and five refinement stages, each two
branches (19 confidence maps, 38 PAF maps) of convs with bias and PReLU:
initial 3x3 128 three times then 1x1 512, refinement 7x7 128 five times
then 1x1 128, each branch closed by a 1x1 conv and PReLU. A refinement
stage reads the concat of the CPM features and the previous stage's maps.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import Arith, conv, max_pool, nhwc

_VGG = ((64, 2), "pool", (128, 2), "pool", (256, 4), "pool", (512, 2))
_INIT = ((128, 3), (128, 3), (128, 3), (512, 1))
_REFINE = ((128, 7),) * 5 + ((128, 1),)
N_CONF, N_PAF, N_REFINE = 19, 38, 5
BGR_MEAN = np.array([103.939, 116.779, 123.68], np.float32) / 255.0


def _branches():
    """(key, input channels, plan, outputs) of every stage branch."""
    out = [("init_conf", 128, _INIT, N_CONF), ("init_paf", 128, _INIT, N_PAF)]
    for i in range(N_REFINE):
        cin = 128 + N_CONF + N_PAF
        out += [(f"ref{i}_conf", cin, _REFINE, N_CONF), (f"ref{i}_paf", cin, _REFINE, N_PAF)]
    return out


def param_shapes() -> dict:
    shapes = {}

    def conv_shape(key, k, cin, cout):
        shapes[f"params/{key}/kernel"] = (k, k, cin, cout)
        shapes[f"params/{key}/bias"] = (cout,)

    cin, b = 3, 0
    for item in _VGG:
        if item != "pool":
            f, n = item
            for _ in range(n):
                conv_shape(f"backbone/conv_{b}", 3, cin, f)
                cin, b = f, b + 1
    conv_shape("cpm1", 3, 512, 256)
    conv_shape("cpm2", 3, 256, 128)
    for key, cin, plan, n_out in _branches():
        for j, (f, k) in enumerate(plan):
            conv_shape(f"{key}/l{j}/conv", k, cin, f)
            shapes[f"params/{key}/l{j}/prelu/alpha"] = (f,)
            cin = f
        conv_shape(f"{key}/out/conv", 1, cin, n_out)
        shapes[f"params/{key}/out/prelu/alpha"] = (n_out,)
    return shapes


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha.view(1, -1, 1, 1) * x)


def forward(w: dict, x: torch.Tensor, arith: Arith, train: bool = False) -> dict:
    """x: NHWC float32 images in [0, 1] -> NHWC maps of every stage and of
    the last (`conf_map`, `paf_map`). The network has no BatchNorm, so
    `train` changes nothing."""
    del train
    mean = torch.as_tensor(BGR_MEAN, device=x.device).view(1, 3, 1, 1)
    h, b = x.permute(0, 3, 1, 2) - mean, 0
    for item in _VGG:
        if item == "pool":
            h = max_pool(h)
            continue
        for _ in range(item[1]):
            h = torch.relu(conv(h, w, f"backbone/conv_{b}", arith))
            b += 1
    feats = torch.relu(conv(torch.relu(conv(h, w, "cpm1", arith)), w, "cpm2", arith))

    def branch(key, plan, t):
        for j in range(len(plan)):
            t = _prelu(conv(t, w, f"{key}/l{j}/conv", arith), w[f"params/{key}/l{j}/prelu/alpha"])
        return _prelu(conv(t, w, f"{key}/out/conv", arith), w[f"params/{key}/out/prelu/alpha"])

    confs, pafs = [branch("init_conf", _INIT, feats)], [branch("init_paf", _INIT, feats)]
    for i in range(N_REFINE):
        z = torch.cat([feats, confs[-1], pafs[-1]], dim=1)
        confs.append(branch(f"ref{i}_conf", _REFINE, z))
        pafs.append(branch(f"ref{i}_paf", _REFINE, z))
    return {"conf_map": nhwc(confs[-1]), "paf_map": nhwc(pafs[-1]),
            "stage_confs": [nhwc(c) for c in confs], "stage_pafs": [nhwc(p) for p in pafs]}
