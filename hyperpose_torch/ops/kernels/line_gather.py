"""PAF line-integral scoring of the limb candidate pairs: the CUDA kernel,
its wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `hyperpose_tpu/ops/pallas/line_gather.py`
`fused_line_gather` and the decoder ops around it (JAX
`ops/paf_decode.py` `_limb_pair_scores`). For every limb and every pair of
its two parts' peaks the decoder samples the limb's two PAF channels at S
points along the segment and scores the pair (reference: src/paf.cpp:66-137).
On the TPU the lookup was a one-hot MXU contraction in VMEM, since the TPU
has no fast scattered gather, and the scoring ~40 XLA ops around it. The card
has one, so `csrc/line_gather.cu` (`hp_limb_scores`) scores each pair in one
thread and emits `cand_score` directly: one launch, no sample index or value
array in device memory. See the source for the design.

`limb_scores_plain` runs the same float32 operations in the same order, on
either device: the sample fraction i / S and the mean sum / S divide by a
0-dim tensor on the device (a true division: CUDA divides a tensor by a
Python scalar as a product with its reciprocal), 0.5 * H / norm is one true
division, and the S samples are summed left to right. So the kernel equals it
bit for bit. `line_gather_plain`, the gather inside it, keeps
`fused_line_gather`'s contract.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .library import define, device_table, tracing

_NEG = -1e30
MAX_LIMBS = 64    # csrc/line_gather.cu kMaxLimbs
MAX_SAMPLES = 32  # csrc/line_gather.cu kMaxSamples

_SIG = (
    [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
)


def line_gather_plain(
    paf_planes: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
    bf16: bool = True,
) -> torch.Tensor:
    """vals [B, L, 2, M] float32: vals[b,l,c,m] = paf_planes[b,l,c,ly,lx].

    bf16=True rounds the values to bfloat16 (round to nearest even) first.
    Indices outside the plane give 0, as the one-hot contraction does."""
    b, l, _, h, w = paf_planes.shape
    planes = paf_planes.to(torch.float32)
    if bf16:
        planes = planes.to(torch.bfloat16).to(torch.float32)
    ly = ly.long()
    lx = lx.long()
    inside = (ly >= 0) & (ly < h) & (lx >= 0) & (lx < w)
    flat = (ly.clamp(0, h - 1) * w + lx.clamp(0, w - 1))[:, :, None, :]
    vals = torch.gather(
        planes.reshape(b, l, 2, h * w), 3, flat.expand(b, l, 2, -1)
    )
    return torch.where(inside[:, :, None, :], vals, 0.0)


def limb_pairs(limbs) -> tuple[tuple[int, int], ...]:
    """An [L, 2] limb table (a sequence of pairs, an array or a CPU tensor) as
    host integers."""
    pairs = tuple((int(a), int(b)) for a, b in limbs)
    if not pairs:
        raise ValueError("limb_scores: the limb table is empty")
    return pairs


@device_table
def limb_index(pairs: tuple, device: torch.device) -> torch.Tensor:
    """The [L, 2] int64 limb table on `device`, copied once: a copy from host
    memory inside the decode would make the host wait for the device."""
    return torch.tensor(pairs, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _limb_arrays(pairs: tuple):
    """The limb table as two host int arrays, the kernel's parameters."""
    n = len(pairs)
    return ((ctypes.c_int * n)(*(a for a, _ in pairs)),
            (ctypes.c_int * n)(*(b for _, b in pairs)))


def limb_scores_plain(
    paf: torch.Tensor, peak_xy: torch.Tensor, peak_valid: torch.Tensor, limbs,
    *, n_samples: int = 10, upsample: float = 4, paf_thresh: float = 0.05,
    crit1_thresh: int = 8, bf16: bool = True,
) -> torch.Tensor:
    """Line-integral score of every (peak_a, peak_b) pair of every limb.

    paf [B, H, W, 2L] float32 (limb l reads channels 2l (x) and 2l + 1 (y));
    peak_xy [B, P, K, 2] float32 (x, y); peak_valid [B, P, K] bool; limbs:
    [L, 2] part indices, on the host (a sequence of pairs, an array or a CPU
    tensor). Returns cand_score [B, L, K, K] float32, -1e30 where a pair
    fails: both peaks valid, a length above 1e-6, more than `crit1_thresh`
    samples with a dot product above `paf_thresh`, and a positive score
    (the mean dot product plus min(0, H / (2 upsample length) - 1))."""
    b, h, w, _ = paf.shape
    dev = paf.device
    idx = limb_index(limb_pairs(limbs), dev)
    l, s, k = idx.shape[0], n_samples, peak_xy.shape[2]
    pa = peak_xy[:, idx[:, 0]]                     # [B,L,K,2]
    pb = peak_xy[:, idx[:, 1]]
    va = peak_valid[:, idx[:, 0]]                  # [B,L,K]
    vb = peak_valid[:, idx[:, 1]]

    diff = pb[:, :, None, :, :] - pa[:, :, :, None, :]   # [B,L,K,K,2]
    dx, dy = diff[..., 0], diff[..., 1]
    norm = torch.sqrt(dx * dx + dy * dy)                 # [B,L,K,K]
    den = torch.clamp(norm, min=1e-12)
    ux, uy = dx / den, dy / den

    # Sample positions: round(pa + i/S * diff), i in [0, S)  (paf.cpp:77-91).
    fs = torch.full((), float(s), dtype=torch.float32, device=dev)
    ts = (torch.arange(s, dtype=torch.float32, device=dev) / fs).reshape(s, 1)
    loc = pa[:, :, :, None, None, :] + ts * diff[:, :, :, :, None, :]
    loc = torch.floor(loc + 0.5).to(torch.int32)   # C++ int(v + 0.5)
    lx = loc[..., 0].clamp(0, w - 1)
    ly = loc[..., 1].clamp(0, h - 1)
    # [B, L, 2, H, W] view of the NHWC field: channel 2l is x, 2l+1 is y.
    planes = paf.reshape(b, h, w, l, 2).permute(0, 3, 4, 1, 2)
    vals = line_gather_plain(planes, ly.reshape(b, l, -1), lx.reshape(b, l, -1), bf16)
    px = vals[:, :, 0].reshape(b, l, k, k, s)
    py = vals[:, :, 1].reshape(b, l, k, k, s)

    dot = ux[..., None] * px + uy[..., None] * py  # [B,L,K,K,S]
    total, crit1 = dot[..., 0], (dot[..., 0] > paf_thresh).to(torch.int32)
    for i in range(1, s):                          # left to right, as the kernel
        total = total + dot[..., i]
        crit1 = crit1 + (dot[..., i] > paf_thresh)
    mean_score = total / fs
    # Length penalty in virtual upsampled units (paf.cpp:129,352).
    half_h = torch.full((), 0.5 * h, dtype=torch.float32, device=dev)
    crit2 = mean_score + torch.clamp(
        half_h / torch.clamp(upsample * norm, min=1e-12) - 1.0, max=0.0
    )
    ok = (
        (crit1 > crit1_thresh)
        & (crit2 > 0)
        & (norm > 1e-6)
        & va[:, :, :, None]
        & vb[:, :, None, :]
    )
    return torch.where(ok, crit2, _NEG)


def limb_scores(
    paf: torch.Tensor, peak_xy: torch.Tensor, peak_valid: torch.Tensor, limbs,
    *, n_samples: int = 10, upsample: float = 4, paf_thresh: float = 0.05,
    crit1_thresh: int = 8, bf16: bool = True,
) -> torch.Tensor:
    """`limb_scores_plain`'s contract. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which raises if it cannot run. `paf` may
    be any strided view. Traced, the operator `hyperpose::limb_scores`
    (`library.py`)."""
    if tracing():
        return _limb_scores_op(paf, peak_xy, peak_valid,
                               [v for pair in limb_pairs(limbs) for v in pair],
                               n_samples, float(upsample), float(paf_thresh),
                               int(crit1_thresh), bool(bf16))
    return _limb_scores(paf, peak_xy, peak_valid, limbs, n_samples, upsample, paf_thresh,
                        crit1_thresh, bf16)


def _limb_scores(paf, peak_xy, peak_valid, limbs, n_samples, upsample, paf_thresh,
                 crit1_thresh, bf16) -> torch.Tensor:
    """The wrapper's body: the plain version or the launch."""
    kw = dict(n_samples=n_samples, upsample=upsample, paf_thresh=paf_thresh,
              crit1_thresh=crit1_thresh, bf16=bf16)
    if paf.device.type == "cpu":
        return limb_scores_plain(paf, peak_xy, peak_valid, limbs, **kw)
    if paf.device.type != "cuda":
        raise ValueError(f"limb_scores: unsupported device {paf.device}")
    pairs = limb_pairs(limbs)
    b, h, w, c = paf.shape
    _, p, k, _ = peak_xy.shape
    l = len(pairs)
    if (c != 2 * l or peak_xy.shape != (b, p, k, 2)
            or peak_valid.shape != (b, p, k)):
        raise ValueError(
            f"limb_scores: paf {tuple(paf.shape)}, peak_xy "
            f"{tuple(peak_xy.shape)}, peak_valid {tuple(peak_valid.shape)}, "
            f"{l} limbs")
    if l > MAX_LIMBS or not all(0 <= x < p for pair in pairs for x in pair):
        raise ValueError(f"limb_scores: {l} limbs (at most {MAX_LIMBS}) over {p} parts")
    if paf.dtype != torch.float32 or peak_xy.dtype != torch.float32:
        raise TypeError("limb_scores: paf and peak_xy must be float32")
    if peak_valid.dtype != torch.bool:
        raise TypeError("limb_scores: peak_valid must be bool")
    if not 1 <= n_samples <= MAX_SAMPLES:
        raise ValueError(f"limb_scores: n_samples={n_samples} outside [1, {MAX_SAMPLES}]")
    if peak_xy.device != paf.device or peak_valid.device != paf.device:
        raise ValueError("limb_scores: inputs on different devices")
    peak_xy = peak_xy.contiguous()
    if peak_xy.data_ptr() % 8:  # the kernel reads a peak as one 8-byte load
        peak_xy = peak_xy.clone()
    peak_valid = peak_valid.contiguous()
    out = torch.empty((b, l, k, k), dtype=torch.float32, device=paf.device)
    limb_a, limb_b = _limb_arrays(pairs)
    lib = build.load("line_gather")
    fn = lib.hp_limb_scores
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    with torch.cuda.device(paf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            paf.data_ptr(), b, h, w, l, *paf.stride(), peak_xy.data_ptr(),
            peak_valid.data_ptr(), p, k, ctypes.addressof(limb_a),
            ctypes.addressof(limb_b), n_samples,
            float(upsample), float(paf_thresh), int(crit1_thresh), int(bf16),
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"limb_scores kernel failed: CUDA error {rc}")
    limb_scores.launches += 1
    return out


limb_scores.launches = 0  # kernel launches since the count was last set to 0


def _limb_scores_impl(paf, peak_xy, peak_valid, limbs, n_samples, upsample, paf_thresh,
                      crit1_thresh, bf16):
    pairs = tuple(zip(limbs[0::2], limbs[1::2]))
    return _limb_scores(paf, peak_xy, peak_valid, pairs, n_samples, upsample, paf_thresh,
                        crit1_thresh, bf16).contiguous()


def _limb_scores_fake(paf, peak_xy, peak_valid, limbs, *args):
    k = peak_xy.shape[2]
    return paf.new_empty((paf.shape[0], len(limbs) // 2, k, k), dtype=torch.float32)


_limb_scores_op = define(
    "limb_scores", "(Tensor paf, Tensor peak_xy, Tensor peak_valid, int[] limbs, int n_samples, "
    "float upsample, float paf_thresh, int crit1_thresh, bool bf16) -> Tensor",
    _limb_scores_impl, _limb_scores_fake)
