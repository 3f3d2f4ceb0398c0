"""The plain training step of the OpenPose family: the targets from the
keypoints, the network in train mode (BatchNorm on batch statistics), the
staged L2 loss, the L2 term of the kernels, and Adam, in float32 with TF32
off. Plain PyTorch; it imports nothing of the port.

Targets (HyperPose openpose/utils.py, put_heatmap and cal_vectormap):
  confidence  per part a Gaussian (sigma 7 input pixels) sampled at the
              output grid's points (stride x i + stride / 2 - 0.5), cut to 0
              where its exponent passes 4.6052, the maximum over people,
              then the background channel 1 - the maximum over parts,
              clipped to [0, 1];
  PAF         per limb the unit vector from its first part to its second,
              written at the output grid's integer points that lie on the
              segment (projection in [0, length]) within 1 grid cell of it,
              summed over people and divided by how many wrote each point.
Loss (HyperPose openpose cal_loss): for every stage, 0.5 x the sum of
((target - map) x mask)^2 for the confidence and the PAF maps; the mean of
those 2 x stages terms over the batch size; plus the weight decay times the
sum of squares of every conv kernel. Adam as optax's (b1 0.9, b2 0.999,
eps 1e-8, bias-corrected, the learning rate constant over the first
steps), from zero moments or from a given state of them.
"""
from __future__ import annotations

import torch

from .common import Arith, exact_float32
from .decode import COCO_LIMBS

SIGMA, CONF_CUTOFF = 7.0, 4.6052
B1, B2, EPS = 0.9, 0.999, 1e-8


def conf_targets(kpts, valid, in_hw, out_hw):
    """kpts [B, M, P, 2] input pixels, valid [B, M, P] -> [B, h, w, P + 1]."""
    (hin, win), (hout, wout) = in_hw, out_hw
    sy, sx = hin / hout, win / wout
    dev = kpts.device
    gy = torch.arange(hout, dtype=torch.float32, device=dev) * sy + sy / 2.0 - 0.5
    gx = torch.arange(wout, dtype=torch.float32, device=dev) * sx + sx / 2.0 - 0.5
    cx, cy = kpts[..., 0], kpts[..., 1]
    ok = valid & (cx >= 0) & (cy >= 0)
    arg = (((gy - cy[..., None]) ** 2)[..., :, None]
           + ((gx - cx[..., None]) ** 2)[..., None, :]) / (2.0 * SIGMA * SIGMA)
    g = torch.where((arg <= CONF_CUTOFF) & ok[..., None, None], torch.exp(-arg), 0.0)
    heat = g.amax(dim=1)
    bg = torch.clamp(1.0 - heat.amax(dim=1), 0.0, 1.0)
    return torch.cat([heat, bg[:, None]], dim=1).permute(0, 2, 3, 1)


def paf_targets(kpts, valid, in_hw, out_hw, width: float = 1.0):
    """-> [B, h, w, 2L], limb l in channels 2l (x) and 2l + 1 (y)."""
    (hin, win), (hout, wout) = in_hw, out_hw
    dev = kpts.device
    limbs = torch.tensor(COCO_LIMBS, dtype=torch.long, device=dev)
    scale = torch.tensor([win / wout, hin / hout], dtype=torch.float32, device=dev)
    src, dst = kpts[:, :, limbs[:, 0]] / scale, kpts[:, :, limbs[:, 1]] / scale
    ok = valid[:, :, limbs[:, 0]] & valid[:, :, limbs[:, 1]]
    vec = dst - src
    length = torch.sqrt((vec * vec).sum(-1))
    unit = vec / length.clamp(min=1e-8)[..., None]
    gy = torch.arange(hout, dtype=torch.float32, device=dev).view(1, 1, 1, hout, 1)
    gx = torch.arange(wout, dtype=torch.float32, device=dev).view(1, 1, 1, 1, wout)
    rx, ry = gx - src[..., 0][..., None, None], gy - src[..., 1][..., None, None]
    ux, uy = unit[..., 0][..., None, None], unit[..., 1][..., None, None]
    along = rx * ux + ry * uy
    band = ((along >= 0) & (along <= length[..., None, None]) & ((rx * uy - ry * ux).abs() <= width)
            & ok[..., None, None]).to(torch.float32)
    count = band.sum(1).clamp(min=1.0)
    paf = torch.stack([(band * ux).sum(1) / count, (band * uy).sum(1) / count], dim=2)
    b, n = paf.shape[:2]
    return paf.reshape(b, 2 * n, hout, wout).permute(0, 2, 3, 1)


def staged_loss(out: dict, gt_conf, gt_paf, mask):
    terms = []
    for conf, paf in zip(out["stage_confs"], out["stage_pafs"]):
        terms.append(0.5 * ((gt_conf - conf) * mask).square().sum())
        terms.append(0.5 * ((gt_paf - paf) * mask).square().sum())
    return torch.stack(terms).mean() / gt_conf.shape[0]


def train_steps(net, weights: dict, batches: list, in_hw, out_hw, lr: float,
                weight_decay: float, arith: Arith | None = None, device="cuda",
                moments: dict | None = None, count: int = 0, loss_rows: int | None = None) -> dict:
    """len(batches) Adam steps of `net` (a reference module) from `weights`
    (flax keys -> float32 tensors) and Adam's `moments` ({"mu": {key:
    tensor}, "nu": ...}, zero if None) after `count` updates. `loss_rows`
    takes the loss over the batch's first rows alone (a fault for the
    check's readings). Returns {"losses": [total loss of each step], "maps":
    step 1's final confidence and PAF maps, "grads": {key: step 1's
    gradient}, "start": {key: initial param}, "end": {key: param after the
    last step}}."""
    arith = arith or Arith()
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if k.startswith("params/")}
    stats = {k: v for k, v in weights.items() if not k.startswith("params/")}
    start = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: (moments["mu"][k].clone() if moments else torch.zeros_like(v)) for k, v in params.items()}
    nu = {k: (moments["nu"][k].clone() if moments else torch.zeros_like(v)) for k, v in params.items()}
    kernels = [k for k in params if k.endswith("/kernel")]
    losses, grads1, maps1 = [], None, None
    with exact_float32():
        for t, batch in enumerate(batches, start=count + 1):
            x = torch.as_tensor(batch["images"], device=device).to(torch.float32) / 255.0
            kpts = torch.as_tensor(batch["kpts"], device=device)[:, :, :18]
            valid = torch.as_tensor(batch["valid"], device=device)[:, :, :18]
            mask = torch.as_tensor(batch["mask"], device=device)
            gt_conf = conf_targets(kpts, valid, in_hw, out_hw)
            gt_paf = paf_targets(kpts, valid, in_hw, out_hw)
            out = net.forward({**params, **stats}, x, arith, train=True)
            n = loss_rows or len(x)
            cut = {k: [m[:n] for m in out[k]] for k in ("stage_confs", "stage_pafs")}
            loss = staged_loss(cut, gt_conf[:n], gt_paf[:n], mask[:n])
            loss = loss + weight_decay * sum(params[k].square().sum() for k in kernels)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if t == count + 1:
                grads1 = {k: g.detach().clone() for k, g in zip(params, grads)}
                maps1 = (out["conf_map"].detach(), out["paf_map"].detach())
            with torch.no_grad():
                c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
                for (k, p), g in zip(params.items(), grads):
                    mu[k].mul_(B1).add_(g, alpha=1.0 - B1)
                    nu[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                    p.sub_(lr * (mu[k] / c1) / ((nu[k] / c2).sqrt() + EPS))
    return {"losses": losses, "maps": maps1, "grads": grads1, "start": start,
            "end": {k: v.detach() for k, v in params.items()}}
