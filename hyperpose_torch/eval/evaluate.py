"""Evaluation / test pipelines: model -> COCO-format results -> metrics.

Counterpart of `hyperpose_tpu/eval/evaluate.py`, mirroring the reference's
evaluate/test flows (reference: hyperpose/Model/openpose/eval.py:14-218 —
infer_one_img, multiscale_search, COCO-format result writing,
official_eval/official_test) on a batched device step instead of
per-image TF sessions. The network, the map upsample and the decoder run on
the evaluator's device with one host sync per batch, when the skeletons come
back; reading the images and scoring stay on the host. The step runs with
TF32 off, so a float32 network computes in float32 as the reference does
(bfloat16 and int8 work is not affected by the flags).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..data.base import BasePoseDataset, EvalRecord
from ..ops.image import jax_resize_cubic, no_tf32
from ..ops.paf_decode import DecodedSkeletons, PafDecoderConfig, paf_decode_batch
from ..utils.human import Human, SkeletonBatch
from ..utils.topology import Topology

logger = logging.getLogger("hyperpose_torch.MODEL")

# Python-side eval decode thresholds (reference: openpose/processor.py:36-37:
# thresh_vec_cnt=6, thresh_human_score=0.3) at 2x-upsampled maps: the
# reference decodes its maps upsampled (INTER_CUBIC, processor.py:75-95 /
# paf.cpp:337-340 4x) because keypoints closer than one stride-8 cell merge
# under 3x3 peak NMS at feature resolution (eyes/ears of small figures).
# 2x recovers them at a quarter of 4x's decode area; smooth params are the
# reference's 4x values rescaled; upsample=2 keeps the length penalty at
# the reference's virtual-4x convention.
EVAL_UPSAMPLE = 2
EVAL_DECODER = PafDecoderConfig(
    crit1_thresh=6, min_human_score=0.3, upsample=4 // EVAL_UPSAMPLE,
    smooth_ksize=9, smooth_sigma=1.5, max_peaks=24,
)

MULTISCALE = (0.5, 1.0, 1.5, 2.0)  # reference: openpose/eval.py:16

_FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _pad_to(x: int, stride: int = 8) -> int:
    return int(np.ceil(x / stride) * stride)


def to_host(d: DecodedSkeletons) -> SkeletonBatch:
    """Device skeletons -> numpy `SkeletonBatch` in one device-to-host copy
    (the five fields packed into one float32 vector: coordinates and scores
    are float32 already, the flags come back as 0 / 1)."""
    fields = [getattr(d, f) for f in _FIELDS]
    flat = torch.cat([f.reshape(-1).to(torch.float32) for f in fields]).cpu().numpy()
    out, off = [], 0
    for f in fields:
        n = f.numel()
        a = flat[off:off + n].reshape(tuple(f.shape))
        out.append(a > 0.5 if f.dtype == torch.bool else a)
        off += n
    return SkeletonBatch(*out)


@dataclasses.dataclass
class EvalStats:
    """Host seconds of an evaluation by stage: reading and resizing the
    images, the device step (handing the batch over until the skeletons are
    back on the host) and the rest (COCO results, scoring)."""

    images: int = 0
    batches: int = 0
    read_s: float = 0.0
    device_s: float = 0.0
    score_s: float = 0.0


class Evaluator:
    """Batched COCO / MPII evaluation for the PAF family, and for the other
    families through their `fused_decode`."""

    def __init__(
        self, model, dataset: BasePoseDataset,
        input_hw: tuple[int, int], output_converter: Callable,
        topology: Topology, batch_size: int = 8,
        decoder: PafDecoderConfig = EVAL_DECODER, multiscale: bool = False,
        fused_decode: Callable | None = None,
        device: str | torch.device = "cuda",
    ):
        """model: an `nn.Module` with its weights loaded (NHWC images in
        [0, 1] -> {"conf_map", "paf_map"} NHWC), moved to `device`; None for
        an evaluator whose `infer_batch` is replaced.
        fused_decode(images_u8 [B, H, W, 3] on the device) ->
        DecodedSkeletons overrides the PAF-family path (PoseProposal /
        PifPaf, `models._fused_decode_for`); it closes over `model`.
        device: where the step runs; the CPU only when asked for. A CUDA
        device without a GPU raises."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Evaluator(device='cuda'), but torch finds no CUDA device; pass "
                "device='cpu' to evaluate on the CPU")
        if model is not None:
            model = model.to(self.device).eval()
            if self.device.type == "cuda":
                model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.dtype = getattr(model, "dtype", torch.float32)
        self.dataset = dataset
        self.input_hw = tuple(input_hw)
        self.output_converter = output_converter
        self.topology = topology
        self.batch_size = batch_size
        # EVAL_DECODER carries COCO part/limb counts; re-target them to the
        # active topology (MPII: 15 parts + Center, 14 limbs).
        if (decoder.n_parts != topology.n_parts
                or decoder.n_limbs != topology.n_limbs):
            decoder = dataclasses.replace(
                decoder, n_parts=topology.n_parts, n_limbs=topology.n_limbs,
            )
        self.decoder = decoder
        self.multiscale = multiscale
        self._fused_decode = fused_decode
        self.stats = EvalStats()

    def _forward_maps(self, images_u8: torch.Tensor):
        """The network on a uint8 batch on the device, returning (conf, paf)
        in float32 resized to the decode grid: the base feature grid of
        `input_hw` upsampled EVAL_UPSAMPLE times (reference: INTER_CUBIC map
        upsampling, openpose/processor.py:75-95). Maps already that size
        (MobileNet-Small's stride 4) stay as they are."""
        base_hw = (self.input_hw[0] // 8, self.input_hw[1] // 8)
        dec_hw = (base_hw[0] * EVAL_UPSAMPLE, base_hw[1] * EVAL_UPSAMPLE)
        out = self.model(images_u8.to(self.dtype) / 255.0)
        conf = out["conf_map"].to(torch.float32)
        paf = out["paf_map"].to(torch.float32)
        if tuple(conf.shape[1:3]) != dec_hw:
            conf = jax_resize_cubic(conf, dec_hw)
            paf = jax_resize_cubic(paf, dec_hw)
        return conf, paf

    def _decode(self, conf, paf) -> SkeletonBatch:
        return to_host(paf_decode_batch(conf, paf, self.decoder, None, self.topology))

    def maps(self, images_u8: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The decoder's input for a uint8 [B, hin, win, 3] batch: single
        scale, or the mean of the maps at every scale of MULTISCALE (each
        input `cv2.resize`d and padded up to a multiple of 8; reference:
        eval.py:14-53 multiscale_search averages restored maps)."""
        with torch.inference_mode(), no_tf32():
            if not self.multiscale:
                return self._forward_maps(self._to_device(images_u8))
            import cv2

            h, w = self.input_hw
            confs, pafs = [], []
            for s in MULTISCALE:
                sh, sw = _pad_to(int(h * s)), _pad_to(int(w * s))
                scaled = np.stack([cv2.resize(img, (sw, sh)) for img in images_u8])
                c, p = self._forward_maps(self._to_device(scaled))
                confs.append(c)
                pafs.append(p)
            return torch.stack(confs).mean(dim=0), torch.stack(pafs).mean(dim=0)

    def _to_device(self, images_u8) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(images_u8)).to(self.device)

    def infer_batch(self, images_u8: np.ndarray) -> SkeletonBatch:
        """Single- or multi-scale inference on a uint8 [B, hin, win, 3]
        batch; with a `fused_decode`, that step."""
        if self._fused_decode is not None:
            with torch.inference_mode(), no_tf32():
                return to_host(self._fused_decode(self._to_device(images_u8)))
        conf, paf = self.maps(images_u8)
        with torch.inference_mode():
            return self._decode(conf, paf)

    def humans_to_coco_ann(
        self, humans: Sequence[Human], image_id: int, orig_hw: tuple[int, int]
    ) -> list[dict]:
        anns = []
        oh, ow = orig_hw
        for human in humans:
            kpts_xy = np.full((len(self.topology.parts), 2), -1000.0)
            for idx, part in human.parts.items():
                kpts_xy[idx] = (part.x * ow, part.y * oh)
            anns.append({
                "image_id": int(image_id),
                "category_id": 1,
                "keypoints": self.output_converter(kpts_xy),
                "score": float(human.score),
            })
        return anns

    def _results(self, records: Sequence[EvalRecord], log: bool) -> list[dict]:
        """Every record through `infer_batch`, batch by batch (the last batch
        padded with zero images), as COCO-format results."""
        import cv2

        h, w = self.input_hw
        st = self.stats
        results: list[dict] = []
        for i in range(0, len(records), self.batch_size):
            t0 = time.perf_counter()
            chunk = records[i:i + self.batch_size]
            batch = np.zeros((self.batch_size, h, w, 3), np.uint8)
            sizes = []
            for j, rec in enumerate(chunk):
                img = cv2.cvtColor(cv2.imread(rec.image_path), cv2.COLOR_BGR2RGB)
                sizes.append(img.shape[:2])
                batch[j] = cv2.resize(img, (w, h))
            t1 = time.perf_counter()
            sk = self.infer_batch(batch)
            t2 = time.perf_counter()
            for j, rec in enumerate(chunk):
                results.extend(self.humans_to_coco_ann(
                    sk.to_humans(j), rec.image_id, sizes[j]
                ))
            st.read_s += t1 - t0
            st.device_s += t2 - t1
            st.score_s += time.perf_counter() - t2
            st.images += len(chunk)
            st.batches += 1
            if log and (i // self.batch_size) % 20 == 0:
                logger.info("eval %d/%d images", i + len(chunk), len(records))
        return results

    def evaluate(
        self, records: Sequence[EvalRecord] | None = None,
        limit: int | None = None, eval_dir: str = "./eval_dir",
    ) -> dict[str, float]:
        records = list(records if records is not None
                       else self.dataset.get_eval_records())
        if limit:
            records = records[:limit]
        results = self._results(records, log=True)
        t0 = time.perf_counter()
        os.makedirs(eval_dir, exist_ok=True)
        metrics = self.dataset.official_eval(results, eval_dir)
        self.stats.score_s += time.perf_counter() - t0
        self.results = results
        return metrics

    def test(self, records=None, limit=None, test_dir: str = "./test_dir"):
        """official_test: write server-upload json without local metrics
        (reference: eval.py:151-218, mscoco_dataset/dataset.py:188-195)."""
        records = list(records if records is not None
                       else self.dataset.get_test_records())
        if limit:
            records = records[:limit]
        results = self._results(records, log=False)
        os.makedirs(test_dir, exist_ok=True)
        out_path = os.path.join(test_dir, "pd_ann.json")
        with open(out_path, "w") as f:
            json.dump(results, f)
        logger.info("wrote %d detections to %s", len(results), out_path)
        return out_path
