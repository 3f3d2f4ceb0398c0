"""Lightweight-OpenPose on TinyVGG, the plain reference (Osokin,
arXiv:1811.12004; HyperPose's `MODEL.LightweightOpenpose` with the Vggtiny
backbone), on the flat flax weights of the flagship checkpoint.

TinyVGG: ConvBN 32-64, pool, 128-128, pool, 200x3, pool, 384x2 (3x3, ReLU,
flax SAME, BN eps 1e-5). CPM: 1x1 conv (ReLU), three ConvBN 128 as a
residual tower, a 3x3 conv on the sum (ReLU). The initial stage: three 3x3
convs (ReLU) and the heads (1x1 to 512, ReLU, 1x1 to 19 confidence / 38
PAF). One refinement stage: five blocks of a 1x1 conv (ReLU) and two
ConvBN with a residual sum, on the concat of the CPM features and the
initial maps, then the heads. The served fused-stem form (block_0 on
pair-packed pixels and block_1 + pool1 in one kernel, BN folded) computes
this same function: the reference computes it from the checkpoint as
trained, not from the remapped weights.
"""
from __future__ import annotations

import torch

from .common import Arith, batchnorm, conv, max_pool, nhwc

_BACKBONE = (32, 64, "pool", 128, 128, "pool", 200, 200, 200, "pool", 384, 384)
N_CONF, N_PAF, C = 19, 38, 128


def param_shapes() -> dict:
    """Flax key -> shape of every weight (params and batch_stats)."""
    shapes = {}

    def conv_shape(key, k, cin, cout, bias=True):
        shapes[f"params/{key}/kernel"] = (k, k, cin, cout)
        if bias:
            shapes[f"params/{key}/bias"] = (cout,)

    def convbn(key, cin, cout):
        conv_shape(f"{key}/conv", 3, cin, cout, bias=False)
        for leaf in ("scale", "bias"):
            shapes[f"params/{key}/bn/{leaf}"] = (cout,)
        for leaf in ("mean", "var"):
            shapes[f"batch_stats/{key}/bn/{leaf}"] = (cout,)

    cin, i = 3, 0
    for item in _BACKBONE:
        if item != "pool":
            convbn(f"backbone/block_{i}", cin, item)
            cin, i = item, i + 1
    conv_shape("cpm/init", 1, 384, C)
    for m in ("m0", "m1", "m2"):
        convbn(f"cpm/{m}/cb", C, C)
    conv_shape("cpm/end", 3, C, C)
    for m in ("init_m0", "init_m1", "init_m2"):
        conv_shape(m, 3, C, C)

    def heads(key):
        conv_shape(f"{key}/conf1", 1, C, 512)
        conv_shape(f"{key}/conf2", 1, 512, N_CONF)
        conv_shape(f"{key}/paf1", 1, C, 512)
        conv_shape(f"{key}/paf2", 1, 512, N_PAF)

    heads("init_heads")
    cin = C + N_CONF + N_PAF
    for i in range(5):
        conv_shape(f"ref_b{i}/init", 1, cin, C)
        convbn(f"ref_b{i}/c1/cb", C, C)
        convbn(f"ref_b{i}/c2/cb", C, C)
        cin = C
    heads("ref_heads")
    return shapes


def forward(w: dict, x: torch.Tensor, arith: Arith, train: bool = False) -> dict:
    """x: NHWC float32 images in [0, 1]. Returns NHWC `stage_confs` and
    `stage_pafs` (the initial and the refinement stage) and `conf_map`,
    `paf_map` (the last stage). `train` takes BatchNorm's batch statistics."""
    relu = torch.relu

    def convbn(key, t):
        return relu(batchnorm(conv(t, w, f"{key}/conv", arith), w, f"{key}/bn", train))

    h, i = x.permute(0, 3, 1, 2), 0
    for item in _BACKBONE:
        if item == "pool":
            h = max_pool(h)
        else:
            h = convbn(f"backbone/block_{i}", h)
            i += 1
    f = relu(conv(h, w, "cpm/init", arith))
    y = convbn("cpm/m2/cb", convbn("cpm/m1/cb", convbn("cpm/m0/cb", f)))
    feats = relu(conv(f + y, w, "cpm/end", arith))
    y = feats
    for m in ("init_m0", "init_m1", "init_m2"):
        y = relu(conv(y, w, m, arith))

    def heads(key, t):
        c = conv(relu(conv(t, w, f"{key}/conf1", arith)), w, f"{key}/conf2", arith)
        p = conv(relu(conv(t, w, f"{key}/paf1", arith)), w, f"{key}/paf2", arith)
        return c, p

    conf0, paf0 = heads("init_heads", y)
    z = torch.cat([feats, conf0, paf0], dim=1)
    for i in range(5):
        z = relu(conv(z, w, f"ref_b{i}/init", arith))
        z = z + convbn(f"ref_b{i}/c2/cb", convbn(f"ref_b{i}/c1/cb", z))
    conf1, paf1 = heads("ref_heads", z)
    return {"conf_map": nhwc(conf1), "paf_map": nhwc(paf1),
            "stage_confs": [nhwc(conf0), nhwc(conf1)], "stage_pafs": [nhwc(paf0), nhwc(paf1)]}
