"""Batched pose-inference engine in PyTorch.

Counterpart of `hyperpose_tpu/runtime/engine.py` (reference:
src/tensorrt.cpp:121-477 dnn::tensorrt): normalize, CNN forward and PAF
decode run on the device as one step over a fixed-shape uint8 batch; the
resize to the network's input stays on the host (numpy, no OpenCV).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.image import letterbox_resize, resize_bilinear, rgb_to_yuv420, yuv420_to_rgb
from ..ops.paf_decode import DecodedSkeletons, PafDecoderConfig, paf_decode_batch
from ..utils import tracing
from ..utils.human import Human, SkeletonBatch
from ..utils.topology import COCO_TOPOLOGY, Topology
from ..utils.weights import load_flax_weights


@dataclasses.dataclass
class EngineStats:
    """Rolling throughput counters (reference: examples/cli.cpp:231-301 FPS
    reporting)."""

    frames: int = 0
    seconds: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0


def default_max_batch_size(input_hw: tuple[int, int]) -> int:
    """The engine batch when the caller names none. The best batch on the
    GPU has not been measured yet, so this is the reference engine's default
    (include/hyperpose/operator/dnn/tensorrt.hpp:46)."""
    del input_hw
    return 8


class PoseEngine:
    """Batched, fixed-shape pose inference: images -> skeletons.

    `inference()` accepts a list of HWC uint8 RGB images, resizes and
    batches them, and returns per-image `Human` lists
    (reference: include/hyperpose/operator/dnn/tensorrt.hpp:44-123)."""

    def __init__(
        self,
        model: nn.Module,
        variables=None,
        input_hw: tuple[int, int] = (368, 432),
        max_batch_size: int | None = None,
        decoder: PafDecoderConfig | None = None,
        topology: Topology = COCO_TOPOLOGY,
        keep_ratio: bool = False,
        fused_decode=None,
        quant_scales: dict[str, float] | None = None,
        input_format: str = "rgb8",
        device: str | torch.device = "cuda",
    ):
        """model: a `LightWeightOpenPose` (NHWC in, NHWC maps out).
        variables: flax-layout weights (the JAX package's flat npz path, or a
        dict of arrays) loaded into `model`; None keeps the model's own.
        input_format: "rgb8" (uint8 [B,H,W,3]) or "yuv420" (planar I420
        uint8 [B,H*3/2,W]; the device reconstructs RGB).
        device: where the step runs; the CPU only when asked for."""
        if fused_decode is not None:
            raise NotImplementedError(
                "fused_decode (PoseProposal / PifPaf decoders) is not ported "
                "yet: ROADMAP Queue 1 #8-9"
            )
        if quant_scales is not None:
            raise NotImplementedError(
                "quant_scales (int8 serving) is not ported yet: ROADMAP "
                "Queue 1 #14"
            )
        if input_format not in ("rgb8", "yuv420"):
            raise ValueError(f"unknown input_format {input_format!r}")
        if input_format == "yuv420" and (input_hw[0] % 4 or input_hw[1] % 2):
            raise ValueError(
                f"yuv420 infeed needs H%4==0 and W%2==0; got {input_hw}"
            )
        self.device = torch.device(device)
        if variables is not None:
            load_flax_weights(model, variables)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.dtype = getattr(model, "dtype", torch.float32)
        self.input_hw = tuple(input_hw)
        if max_batch_size is None:
            max_batch_size = default_max_batch_size(input_hw)
        self.max_batch_size = int(max_batch_size)
        self.decoder = decoder or PafDecoderConfig()
        self.topology = topology
        self.keep_ratio = keep_ratio
        self.input_format = input_format
        self.stats = EngineStats()
        self._out_mh = 0
        self._out_p = 0

    def input_batch_shape(self, batch: int | None = None) -> tuple[int, ...]:
        """Device-input array shape for this engine's format."""
        b = self.max_batch_size if batch is None else batch
        h, w = self.input_hw
        if self.input_format == "yuv420":
            return (b, h * 3 // 2, w)
        return (b, h, w, 3)

    def encode_input(self, rgb_u8: np.ndarray) -> np.ndarray:
        """Host-side encode of one resized RGB frame into the engine's
        infeed format (identity for rgb8, planar I420 for yuv420)."""
        if self.input_format == "yuv420":
            return rgb_to_yuv420(rgb_u8)
        return rgb_u8

    # -- device path ---------------------------------------------------------

    @torch.inference_mode()
    def _step(self, images_u8: torch.Tensor) -> DecodedSkeletons:
        """uint8 batch on the device -> DecodedSkeletons on the device."""
        if self.input_format == "yuv420":
            x = (yuv420_to_rgb(images_u8) / 255.0).to(self.dtype)
        else:
            x = images_u8.to(self.dtype) / 255.0
        out = self.model(x)
        conf = out["conf_map"].to(torch.float32)
        paf = out["paf_map"].to(torch.float32)
        feat_hw = (conf.shape[1], conf.shape[2])
        return paf_decode_batch(conf, paf, self.decoder, feat_hw, self.topology)

    @torch.inference_mode()
    def _step_packed(self, images_u8: torch.Tensor) -> torch.Tensor:
        """The step as ONE flat float32 [B, F] tensor
        (coords|part_scores|part_valid|scores|valid), so a host pays a single
        device->host copy per batch."""
        d = self._step(images_u8)
        b = d.coords.shape[0]
        return torch.cat([
            d.coords.reshape(b, -1),
            d.part_scores.reshape(b, -1),
            d.part_valid.to(torch.float32).reshape(b, -1),
            d.scores.reshape(b, -1),
            d.valid.to(torch.float32).reshape(b, -1),
        ], dim=1)

    def unpack_skeletons(self, packed: np.ndarray) -> SkeletonBatch:
        b = packed.shape[0]
        mh = self._out_mh or self.decoder.max_humans
        p = self._out_p or self.decoder.n_parts
        sizes = [mh * p * 2, mh * p, mh * p, mh, mh]
        offs = np.cumsum([0] + sizes)
        return SkeletonBatch(
            coords=packed[:, offs[0]:offs[1]].reshape(b, mh, p, 2),
            part_scores=packed[:, offs[1]:offs[2]].reshape(b, mh, p),
            part_valid=packed[:, offs[2]:offs[3]].reshape(b, mh, p) > 0.5,
            scores=packed[:, offs[3]:offs[4]].reshape(b, mh),
            valid=packed[:, offs[4]:offs[5]].reshape(b, mh) > 0.5,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> float:
        """Run the step once on a zero batch (the kernels build on their
        first call); returns the seconds it took."""
        t0 = time.perf_counter()
        dummy = torch.zeros(self.input_batch_shape(), dtype=torch.uint8,
                            device=self.device)
        out = self._step(dummy)
        self._sync()
        self._out_mh = int(out.coords.shape[1])
        self._out_p = int(out.coords.shape[2])
        self._step_packed(dummy).cpu()
        return time.perf_counter() - t0

    def infer_batch_device(self, images_u8) -> DecodedSkeletons:
        """Raw device decode of an already-batched uint8 array (numpy or
        tensor; shape per `input_batch_shape()`). Returns without waiting
        for the device."""
        x = torch.as_tensor(images_u8)
        if x.dtype != torch.uint8:
            raise TypeError(f"images must be uint8, got {x.dtype}")
        return self._step(x.to(self.device, non_blocking=True))

    # -- host path -----------------------------------------------------------

    def inference(self, images: Sequence[np.ndarray]) -> list[list[Human]]:
        """Full operator-style API (reference: tensorrt.cpp:436-461
        inference(vector<cv::Mat>) + parser process)."""
        h, w = self.input_hw
        n = len(images)
        if n > self.max_batch_size:
            raise ValueError(
                f"batch {n} exceeds max_batch_size {self.max_batch_size}"
            )
        batch = np.zeros((self.max_batch_size, h, w, 3), np.uint8)
        ratios: list[tuple[float, float]] = []
        with tracing.scope("engine/preprocess"):
            for i, img in enumerate(images):
                if self.keep_ratio:
                    batch[i], rx, ry = letterbox_resize(img, (h, w))
                    ratios.append((rx, ry))
                else:
                    batch[i] = resize_bilinear(img, (h, w))
                    ratios.append((1.0, 1.0))
            if self.input_format == "yuv420":
                enc = np.zeros(self.input_batch_shape(), np.uint8)
                for i in range(n):
                    enc[i] = self.encode_input(batch[i])
                batch = enc
        t0 = time.perf_counter()
        with tracing.scope("engine/device_step"):
            decoded = self.infer_batch_device(batch)
            sk = SkeletonBatch(*(
                t.cpu().numpy() for t in (
                    decoded.coords, decoded.part_scores, decoded.part_valid,
                    decoded.scores, decoded.valid,
                )
            ))
        self.stats.frames += n
        self.stats.seconds += time.perf_counter() - t0
        results = []
        for i in range(n):
            humans = sk.to_humans(i)
            rx, ry = ratios[i]
            if self.keep_ratio and (rx != 1.0 or ry != 1.0):
                humans = [hm.unletterboxed(rx, ry) for hm in humans]
            results.append(humans)
        return results

    # -- persistence ---------------------------------------------------------

    def save(self, path_prefix: str) -> dict[str, str]:
        raise NotImplementedError(
            "saving the engine (weights + serialized step) is not ported yet: "
            "ROADMAP Queue 1 #14 (utils/export.py to torch.export)"
        )

    @staticmethod
    def load_executable(path: str):
        raise NotImplementedError(
            "loading a serialized step is not ported yet: ROADMAP Queue 1 #14 "
            "(utils/export.py to torch.export)"
        )

