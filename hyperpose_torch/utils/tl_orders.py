"""Reference-build-order keys for the structural TL checkpoint importer.

A copy of `hyperpose_tpu/utils/tl_orders.py` (pure Python on paths): the
port's modules carry the flax module names, so the same keys order the
flax-name view of its state dict (`utils/weights_import.py`).

Each function maps a flax LAYER path (tuple of module names, leaf dropped)
to a sortable key such that sorting our layers by it reproduces the
reference TensorLayer model's build order — the order its npz_dict
checkpoints store weights in. The orders are transcriptions of the
reference model constructors:

  - LW-OpenPose: backbone, cpm (init, m0..m2, end), init stage (3 main
    convs, conf head, paf head), refinement stage (5 blocks of
    init+c1+c2, conf head, paf head)
    (reference: openpose/model/lw_openpose.py:33-191)
  - OpenPose (VGG19): backbone, cpm1, cpm2, init stage (conf block then
    paf block), 5 refinement stages (conf then paf), conv->PRelu pairs
    within every block (reference: openpose/model/openpose.py:14-199)
  - backbones: VGGtiny 9 conv+bn blocks (backbones.py:343-390),
    MobilenetDilated stem conv_block + 11 dw blocks (backbones.py:201-226),
    VGG19 10 plain convs (backbones.py:447+)
"""
from __future__ import annotations

_INF = (10**6,)


def _num_suffix(name: str, prefix: str) -> int:
    return int(name[len(prefix):])


def _conv_then_bn(leafdir: str) -> int:
    # within one reference block, conv weights precede its BN weights
    return {"conv": 0, "dwconv": 0, "bn": 1}.get(leafdir, 0)


def _res_group(head: str) -> tuple[int, int] | None:
    """'b3_2' -> (3, 2); None if not a resnet block name."""
    if head.startswith("b") and "_" in head[1:]:
        g, _, i = head[1:].partition("_")
        if g.isdigit() and i.isdigit():
            return int(g), int(i)
    return None


def _resnet50_block_suborder(path: tuple) -> tuple:
    """Resnet50 Basic_block: the reference constructs the DOWNSAMPLE LayerList
    BEFORE main_block (backbones.py:652-676), so npz order per block is
    ds_conv, ds_bn, conv1, bn1, conv2, bn2, conv3, bn3."""
    g, i = _res_group(path[0])
    sub = {"ds": 0, "cb1": 1, "cb2": 2, "cb3": 3}[path[1]]
    return (1, g, i, sub, _conv_then_bn(path[-1]))


def _resnet18_block_suborder(path: tuple) -> tuple:
    """Resnet18 Res_block: main_block (conv1,bn1,conv2,bn2) is constructed
    BEFORE down_sample (backbones.py:560-576) — the opposite of Resnet50."""
    g, i = _res_group(path[0])
    sub = {"cb1": 0, "cb2": 1, "ds": 2}[path[1]]
    return (1, g, i, sub, _conv_then_bn(path[-1]))


def _backbone_suborder(path: tuple, resnet: str = "r50") -> tuple:
    """path is the flax layer path minus the leading 'backbone'.

    resnet picks the res-block internal order ('r50': downsample-first,
    'r18': main-first) — the two reference constructors differ and the
    block names overlap, so the model-level order function must say which
    family its facade builds (LW-OpenPose ships Resnet50, PoseProposal
    ships Resnet18)."""
    head = path[0]
    if head == "stem":                     # conv+bn stem (mobilenets/resnets)
        return (0, 0, _conv_then_bn(path[-1]))
    if head.startswith("sep_"):            # dw, bn1, pw, bn2 per block
        n = _num_suffix(head, "sep_")
        sub = {"dw": 0, "bn1": 1, "pw": 2, "bn2": 3}[path[1]]
        return (1, n, sub)
    if head.startswith("block_"):          # VGGtiny conv+bn blocks
        return (0, _num_suffix(head, "block_"), _conv_then_bn(path[-1]))
    if head.startswith("conv_"):           # VGG19 plain convs
        return (0, _num_suffix(head, "conv_"), 0)
    if _res_group(head) is not None:       # resnet blocks
        if resnet == "r18":
            return _resnet18_block_suborder(path)
        return _resnet50_block_suborder(path)
    raise KeyError(f"unknown backbone layer {'/'.join(path)}")


def lw_openpose_order(path: tuple) -> tuple:
    """models.openpose.LightWeightOpenPose (any supported backbone)."""
    top = path[0]
    if top == "backbone":
        return (0,) + _backbone_suborder(path[1:])
    if top == "cpm":
        sub = {"init": 0, "m0": 1, "m1": 2, "m2": 3, "end": 4}[path[1]]
        return (1, sub, _conv_then_bn(path[-1]))
    if top.startswith("init_m"):
        return (2, _num_suffix(top, "init_m"), 0)
    if top == "init_heads":
        return (3, {"conf1": 0, "conf2": 1, "paf1": 2, "paf2": 3}[path[1]])
    if top.startswith("ref_b"):
        n = _num_suffix(top, "ref_b")
        sub = {"init": 0, "c1": 1, "c2": 2}[path[1]]
        return (4, n, sub, _conv_then_bn(path[-1]))
    if top == "ref_heads":
        return (5, {"conf1": 0, "conf2": 1, "paf1": 2, "paf2": 3}[path[1]])
    raise KeyError(f"unknown LightWeightOpenPose layer {'/'.join(path)}")


def openpose_order(path: tuple) -> tuple:
    """models.openpose.OpenPose (CMU VGG19 arch)."""
    top = path[0]
    if top == "backbone":
        return (0,) + _backbone_suborder(path[1:])
    if top in ("cpm1", "cpm2"):
        return (1, 0 if top == "cpm1" else 1)
    # stages: init_conf/init_paf then refN_conf/refN_paf; the reference
    # builds each stage's conf block fully, then its paf block
    if top.startswith("init_"):
        stage, branch = 0, top[5:]
    elif top.startswith("ref"):
        n, branch = top[3:].split("_", 1)
        stage = 1 + int(n)
    else:
        raise KeyError(f"unknown OpenPose layer {'/'.join(path)}")
    b = {"conf": 0, "paf": 1}[branch]
    sub = path[1]
    li = 100 if sub == "out" else _num_suffix(sub, "l")
    leaf = {"conv": 0, "prelu": 1}[path[2]]
    return (2, stage, b, li, leaf)


def ppn_order(path: tuple) -> tuple:
    """models.pose_proposal.PoseProposal (Resnet18 backbone; reference:
    pose_proposal/model.py:37-78 — backbone, add_block_1 (conv,bn),
    add_block_2 (conv,bn), add_block_3 conv)."""
    top = path[0]
    if top == "backbone":
        return (0,) + _backbone_suborder(path[1:], resnet="r18")
    if top in ("add1", "add2"):
        return (1, 0 if top == "add1" else 1, _conv_then_bn(path[-1]))
    if top == "head":
        return (2, 0, 0)
    raise KeyError(f"unknown PoseProposal layer {'/'.join(path)}")


def pifpaf_order(path: tuple) -> tuple:
    """models.pifpaf.Pifpaf (Resnet50 stride-16 backbone; reference:
    pifpaf/model.py:36-60,215-281 — backbone, PifHead conv, PafHead conv)."""
    top = path[0]
    if top == "backbone":
        return (0,) + _backbone_suborder(path[1:], resnet="r50")
    if top == "pif_head":
        return (1, 0)
    if top == "paf_head":
        return (1, 1)
    raise KeyError(f"unknown Pifpaf layer {'/'.join(path)}")


def _sep_stage_suborder(top: str, path: tuple) -> tuple:
    """Thin/small stage heads: each stage builds its conf block fully, then
    its paf block (mbv2_th_openpose.py:106-162, mbv2_sm_openpose.py:103-157).
    Thin blocks expand to dw/bn1/pw/bn2 member layers; small blocks are
    single SeparableConv layers."""
    if top.startswith("init_"):
        stage, branch = 0, top[5:]
    elif top.startswith("ref"):
        n, branch = top[3:].split("_", 1)
        stage = 1 + int(n)
    else:
        raise KeyError(f"unknown stage layer {top}")
    b = {"conf": 0, "paf": 1}[branch]
    li = 10**3 if path[1] == "out" else _num_suffix(path[1], "l")
    # thin blocks: dw -> bn1 -> pw -> bn2; small blocks: sep -> bn
    # (mbv2_sm_openpose.py:166-171 SeparableConv2d then BatchNorm2d).
    sub = ({"dw": 0, "bn1": 1, "pw": 2, "bn2": 3, "sep": 0, "bn": 1}[path[2]]
           if len(path) > 2 else 0)
    return (1, stage, b, li, sub)


def thin_small_openpose_order(path: tuple) -> tuple:
    """models.openpose.MobilenetThinOpenpose / MobilenetSmallOpenpose
    (reference: mbv2_th_openpose.py:14-45, mbv2_sm_openpose.py:14-45 —
    backbone, init_stage, refinement stages 1..n)."""
    top = path[0]
    if top == "backbone":
        return (0,) + _backbone_suborder(path[1:])
    return _sep_stage_suborder(top, path)


ORDER_KEYS = {
    "LightweightOpenpose": lw_openpose_order,
    "Openpose": openpose_order,
    "PoseProposal": ppn_order,
    "Pifpaf": pifpaf_order,
    "MobilenetThinOpenpose": thin_small_openpose_order,
    "MobilenetSmallOpenpose": thin_small_openpose_order,
}
