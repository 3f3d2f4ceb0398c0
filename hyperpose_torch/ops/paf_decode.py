"""Fixed-shape Part-Affinity-Field decoder in PyTorch.

Counterpart of `hyperpose_tpu/ops/paf_decode.py` (reference:
src/paf.cpp:300-375 `paf::process`, src/post_process.hpp:134-205,
hyperpose/Model/openpose/processor.py:68-235). Every stage keeps the JAX
decoder's bounded shapes, so a batch decodes on the device with no host
round trip:

  1. peaks: smooth + 3x3 NMS + plateau tie-break + top-K + sub-pixel fit
     (`kernels/peak_topk.py`, a CUDA kernel on the card);
  2. line-integral score of every KxK peak pair per limb, S samples gathered
     from the PAF planes (`kernels/line_gather.py`, a CUDA kernel);
  3. greedy connection NMS per limb over the top-T sorted candidates;
  4. skeleton assembly as min-label propagation over the accepted edges;
  5. per-component part selection, scoring and filtering.

The JAX code vmaps stages 3-5 over the batch; here the batch dimension is
written out. Its two early-exit `lax.while_loop`s run a fixed count of
rounds instead (T for the greedy NMS, `label_prop_iters` for the labels):
their docstrings show that a fixed count reaches the same fixed point, and
a data-dependent exit would cost a host sync per round. Ranking uses a
stable descending sort, which breaks ties toward the lower index as
`lax.top_k` does (CUDA `torch.topk` promises no tie order).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.topology import COCO_TOPOLOGY, Topology
from .kernels.line_gather import line_gather, line_gather_plain
from .kernels.peak_topk import peak_topk, peak_topk_plain

_NEG = -1e30  # sentinel for "invalid" in score arrays (avoid inf arithmetic)


@dataclasses.dataclass(frozen=True)
class PafDecoderConfig:
    """Static decode parameters: the same fields and defaults as the JAX
    package's `PafDecoderConfig`.

    Backends: "auto" runs the CUDA kernel on a CUDA tensor and the plain
    PyTorch version on a CPU tensor; "xla" forces the plain version;
    "pallas" forces the kernel path (for peaks this is the kernel with zero
    borders, mirroring the Pallas kernel), which on a CPU tensor is that
    kernel's plain version."""

    n_parts: int = 18
    n_limbs: int = 19
    max_peaks: int = 16        # K: peaks kept per part channel
    max_candidates: int = 64   # T: sorted connection candidates tried per limb
    max_humans: int = 32
    upsample: int = 4          # virtual upsample for length-penalty parity
    n_samples: int = 10        # STEP_PAF, paf.cpp:60
    smooth_ksize: int = 5
    smooth_sigma: float = 0.75
    conf_thresh: float = 0.05
    paf_thresh: float = 0.05
    crit1_thresh: int = 8
    min_parts: int = 4
    min_human_score: float = 0.4
    label_prop_iters: int = 18
    use_pallas_peaks: bool = False  # legacy smooth+NMS kernel: not ported
    peaks_backend: str = "auto"
    gather_bf16: bool = True   # round the sampled PAF values to bf16
    gather_backend: str = "auto"

    def replace(self, **kw) -> "PafDecoderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class DecodedSkeletons:
    """Fixed-shape decode output (leading batch dim on every field)."""

    coords: torch.Tensor       # [B, MAX_H, P, 2] normalized (x, y) in [0, 1]
    part_scores: torch.Tensor  # [B, MAX_H, P]
    part_valid: torch.Tensor   # [B, MAX_H, P] bool
    scores: torch.Tensor       # [B, MAX_H]
    valid: torch.Tensor        # [B, MAX_H] bool


def _check_backend(name: str, value: str) -> None:
    if value not in ("auto", "xla", "pallas"):
        raise ValueError(f"{name} must be 'auto', 'xla' or 'pallas', got {value!r}")


def find_peaks(
    conf: torch.Tensor, cfg: PafDecoderConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K peak NMS with sub-pixel refinement over [B, H, W, P] maps.

    Returns (peak_xy [B,P,K,2] float32, peak_score [B,P,K], peak_valid
    [B,P,K]); the score is the unsmoothed map's value
    (reference: post_process.hpp:176-187)."""
    if cfg.use_pallas_peaks:
        raise NotImplementedError(
            "use_pallas_peaks (fused_peak_candidates) is not ported yet: "
            "ROADMAP Queue 2 #5"
        )
    _check_backend("peaks_backend", cfg.peaks_backend)
    b, h, w, p = conf.shape
    args = (min(cfg.max_peaks, h * w), cfg.smooth_ksize, cfg.smooth_sigma,
            cfg.conf_thresh)
    if cfg.peaks_backend == "xla":
        xy, raw, sval = peak_topk_plain(conf, *args, border="reflect")
    else:
        border = "zero" if cfg.peaks_backend == "pallas" else "reflect"
        xy, raw, sval = peak_topk(conf, *args, border=border)
    valid = sval > _NEG * 0.5
    return xy, torch.where(valid, raw, 0.0), valid


def _limb_pair_scores(
    paf: torch.Tensor,          # [B, H, W, 2L]
    peak_xy: torch.Tensor,      # [B, P, K, 2]
    peak_valid: torch.Tensor,   # [B, P, K]
    limbs: torch.Tensor,        # [L, 2] int64, on paf's device
    cfg: PafDecoderConfig,
) -> torch.Tensor:
    """Line-integral score of every (peak_a, peak_b) pair for every limb.

    Returns cand_score [B, L, K, K] with invalid pairs set to _NEG
    (reference: src/paf.cpp:66-137)."""
    _check_backend("gather_backend", cfg.gather_backend)
    b, h, w, _ = paf.shape
    l, s, k = limbs.shape[0], cfg.n_samples, peak_xy.shape[2]
    pa = peak_xy[:, limbs[:, 0]]                   # [B,L,K,2]
    pb = peak_xy[:, limbs[:, 1]]
    va = peak_valid[:, limbs[:, 0]]                # [B,L,K]
    vb = peak_valid[:, limbs[:, 1]]

    diff = pb[:, :, None, :, :] - pa[:, :, :, None, :]   # [B,L,K,K,2]
    norm = torch.sqrt(torch.sum(diff * diff, dim=-1))    # [B,L,K,K]
    unit = diff / torch.clamp(norm, min=1e-12)[..., None]

    # Sample positions: round(pa + i/S * diff), i in [0, S)  (paf.cpp:77-91).
    ts = (torch.arange(s, dtype=torch.float32, device=paf.device) / s
          ).reshape(1, 1, 1, 1, s, 1)
    loc = pa[:, :, :, None, None, :] + ts * diff[:, :, :, :, None, :]
    loc = torch.floor(loc + 0.5).to(torch.int32)   # C++ int(v + 0.5)
    lx = loc[..., 0].clamp(0, w - 1)
    ly = loc[..., 1].clamp(0, h - 1)
    m = k * k * s
    rows_y = ly.reshape(b, l, m)
    cols_x = lx.reshape(b, l, m)
    # [B, L, 2, H, W] view of the NHWC field: channel 2l is x, 2l+1 is y.
    paf_planes = paf.reshape(b, h, w, l, 2).permute(0, 3, 4, 1, 2)
    gather = line_gather_plain if cfg.gather_backend == "xla" else line_gather
    vals = gather(paf_planes, rows_y, cols_x, cfg.gather_bf16)   # [B,L,2,M]
    px = vals[:, :, 0].reshape(b, l, k, k, s)
    py = vals[:, :, 1].reshape(b, l, k, k, s)

    dot = unit[..., 0:1] * px + unit[..., 1:2] * py  # [B,L,K,K,S]
    crit1 = torch.sum(dot > cfg.paf_thresh, dim=-1)
    mean_score = torch.sum(dot, dim=-1) / s
    # Length penalty in virtual upsampled units (paf.cpp:129,352).
    norm_up = cfg.upsample * norm
    crit2 = mean_score + torch.clamp(
        0.5 * h / torch.clamp(norm_up, min=1e-12) - 1.0, max=0.0
    )
    ok = (
        (crit1 > cfg.crit1_thresh)
        & (crit2 > 0)
        & (norm > 1e-6)
        & va[:, :, :, None]
        & vb[:, :, None, :]
    )
    return torch.where(ok, crit2, _NEG)


def _top_sorted(x: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last dim: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def _greedy_connections(
    cand_score: torch.Tensor, cfg: PafDecoderConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy connection NMS per limb over sorted candidates
    (reference: src/paf.cpp:244-272).

    A candidate is accepted iff no earlier accepted candidate shares its
    source or destination peak. Iterating accepted <- valid & ~any(conflicts
    & accepted) from accepted = valid settles candidate i by round i, so T
    rounds reproduce the sequential greedy exactly.

    cand_score [B, L, K, K] -> (src, dst, score, accepted), each [B, L, T]."""
    b, l, k, _ = cand_score.shape
    t = min(cfg.max_candidates, k * k)
    top_vals, top_idx = _top_sorted(cand_score.reshape(b, l, k * k), t)
    src = top_idx // k
    dst = top_idx % k
    valid = top_vals > _NEG * 0.5

    ar = torch.arange(t, device=cand_score.device)
    earlier = ar[:, None] > ar[None, :]                  # [T(i), T(j<i)]
    conflicts = earlier & (
        (src[..., :, None] == src[..., None, :])
        | (dst[..., :, None] == dst[..., None, :])
    )                                                    # [B, L, T, T]
    conflicts = conflicts.to(torch.float32)
    accepted = valid
    for _ in range(t):
        # Counts of 0/1 products are exact in float32.
        hits = torch.matmul(conflicts, accepted.to(torch.float32)[..., None])
        accepted = valid & (hits[..., 0] == 0)
    return src, dst, top_vals, accepted


def _assemble(
    src: torch.Tensor, dst: torch.Tensor, conn_score: torch.Tensor,
    accepted: torch.Tensor, peak_xy: torch.Tensor, peak_score: torch.Tensor,
    limbs: torch.Tensor, hw: tuple[int, int], cfg: PafDecoderConfig,
):
    """Group accepted connections into skeletons via label propagation
    (replaces the reference's sequential merge, src/paf.cpp:146-232).

    Nodes are (part, peak-slot) pairs, accepted connections are edges, and
    each connected component is one human. All inputs carry a leading batch
    dim; src/dst/conn_score/accepted are [B, L, T]."""
    p, k = cfg.n_parts, cfg.max_peaks
    n = p * k
    b = src.shape[0]
    dev = src.device
    uf = (limbs[None, :, 0:1] * k + src).reshape(b, -1)   # [B, E = L*T]
    vf = (limbs[None, :, 1:2] * k + dst).reshape(b, -1)
    af = accepted.reshape(b, -1)
    sf = torch.where(af, conn_score.reshape(b, -1), 0.0)

    # Dense adjacency over the node space; counts of 0/1 are exact.
    adj = torch.zeros(b, n * n, dtype=torch.float32, device=dev)
    adj.scatter_add_(1, uf * n + vf, af.to(torch.float32))
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    adj = adj.reshape(b, n, n) > 0
    adj = adj | adj.transpose(1, 2) | eye

    labels0 = torch.arange(n, device=dev)
    labels = labels0.expand(b, n)
    big = torch.full((), n, device=dev)  # made on the device: no host copy
    for _ in range(cfg.label_prop_iters):
        labels = torch.where(adj, labels[:, None, :], big).amin(dim=2)

    in_edge = torch.any(adj & ~eye, dim=2)                      # [B, N]
    # Component membership [B, R(root), N(node)].
    comp_member = (labels[:, None, :] == labels0[None, :, None]) \
        & in_edge[:, None, :]
    cm = comp_member.to(torch.float32)
    # Connection score per component: each edge counts toward the
    # component of its source node.
    edge_root = torch.gather(
        cm.transpose(1, 2), 1, uf[..., None].expand(b, uf.shape[1], n)
    )                                                           # [B, E, R]
    conn_sum = torch.einsum("ber,be->br", edge_root, sf)
    presence = comp_member.reshape(b, n, p, k).any(dim=-1)      # [B, R, P]
    n_parts_comp = presence.sum(dim=-1)
    peak_sum = torch.einsum("brn,bn->br", cm, peak_score.reshape(b, n))
    comp_score = peak_sum + conn_sum

    is_root = (labels == labels0) & in_edge
    keep = (
        is_root
        & (n_parts_comp >= cfg.min_parts)
        & (comp_score / torch.clamp(n_parts_comp, min=1) >= cfg.min_human_score)
    )
    rank = torch.where(keep, comp_score, _NEG)
    top_scores, top_roots = _top_sorted(rank, cfg.max_humans)   # [B, MAX_H]
    human_valid = top_scores > _NEG * 0.5

    # Resolve each human's part slots: highest-scoring member peak per part.
    member = (labels[:, None, :] == top_roots[:, :, None]) & in_edge[:, None, :]
    member = member.reshape(b, cfg.max_humans, p, k)
    member_scores = torch.where(member, peak_score[:, None], _NEG)
    part_score, best_k = member_scores.max(dim=-1)     # ties: the lowest k
    part_valid = part_score > _NEG * 0.5
    part_score = torch.where(part_valid, part_score, 0.0)

    xy = torch.gather(
        peak_xy[:, None].expand(b, cfg.max_humans, p, k, 2), 3,
        best_k[..., None, None].expand(b, cfg.max_humans, p, 1, 2),
    )[:, :, :, 0]                                       # [B, MAX_H, P, 2]
    h, w = hw
    # Pixel-center convention: feature pixel i -> normalized (i + 0.5) / size.
    coords = torch.stack(
        [(xy[..., 0] + 0.5) / w, (xy[..., 1] + 0.5) / h], dim=-1
    )
    coords = torch.where(part_valid[..., None], coords, 0.0)

    scores = torch.where(human_valid, top_scores, 0.0)
    part_valid = part_valid & human_valid[..., None]
    return coords, part_score, part_valid, scores, human_valid


@functools.lru_cache(maxsize=None)
def _limb_table(topology: Topology, device: torch.device) -> torch.Tensor:
    """The [L, 2] limb table on `device`, copied once: a copy from host
    memory inside the decode would make the host wait for the device."""
    return torch.as_tensor(np.asarray(topology.limbs), dtype=torch.int64,
                           device=device)


def paf_decode_batch(
    conf: torch.Tensor,   # [B, H, W, P(+bg)]
    paf: torch.Tensor,    # [B, H, W, 2L]
    cfg: PafDecoderConfig = PafDecoderConfig(),
    feat_hw: tuple[int, int] | None = None,  # kept for API compat; unused
    topology: Topology = COCO_TOPOLOGY,
) -> DecodedSkeletons:
    """Full batched PAF decode: feature maps -> fixed-shape skeletons.

    conf may include a background channel (channel n_parts); only the first
    n_parts channels are searched for peaks (reference: post_process.hpp:179).
    Runs on the device of its inputs."""
    del feat_hw
    b, h, w, _ = conf.shape
    conf = conf.to(torch.float32)[..., : cfg.n_parts]
    paf = paf.to(torch.float32)
    peak_xy, peak_score, peak_valid = find_peaks(conf, cfg)
    limbs = _limb_table(topology, conf.device)
    cand = _limb_pair_scores(paf, peak_xy, peak_valid, limbs, cfg)
    src, dst, cscore, accepted = _greedy_connections(cand, cfg)
    return DecodedSkeletons(*_assemble(
        src, dst, cscore, accepted, peak_xy, peak_score, limbs, (h, w), cfg
    ))
