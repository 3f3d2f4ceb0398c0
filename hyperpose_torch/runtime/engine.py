"""Batched pose-inference engine in PyTorch.

Counterpart of `hyperpose_tpu/runtime/engine.py` (reference:
src/tensorrt.cpp:121-477 dnn::tensorrt): normalize, CNN forward and decode
(the PAF decoder, or a model family's own step given as `fused_decode`) run
on the device as one step over a fixed-shape uint8 batch; the resize to the
network's input stays on the host (numpy, no OpenCV).
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
from ..quant import quantize_model
from ..utils import tracing
from ..utils.human import Human, SkeletonBatch
from ..utils.topology import COCO_TOPOLOGY, Topology
from ..utils.weights import load_flax_weights, read_flax_weights


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
        """model: a `LightWeightOpenPose` (NHWC images in, NHWC conf/PAF maps
        out, decoded by the PAF decoder), or, with `fused_decode`, any model
        that step runs (`models/pifpaf.py` `Pifpaf`).
        variables: flax-layout weights (the JAX package's flat npz path, or a
        dict of arrays) loaded into `model`; None keeps the model's own.
        fused_decode: images_u8 [B,H,W,3] on the device -> DecodedSkeletons,
        replacing the PAF step (e.g. `pifpaf_fused_decode(model)`, built on
        the same `model` object, which the engine moves to `device`). Its
        output sizes are learnt by `warmup()`, which the packed path needs.
        input_format: "rgb8" (uint8 [B,H,W,3]) or "yuv420" (planar I420
        uint8 [B,H*3/2,W]; the device reconstructs RGB).
        quant_scales: an activation scale table (`quant.calibrate_engine`,
        or the JAX package's): every calibrated conv of `model` is swapped for
        an `Int8Conv2d` (s8 x s8 -> s32 on the card's int8 GEMM kernel),
        quantized from the float32 `variables`, which the engine keeps as
        `self.variables`. `quant.quantize_engine` builds such an engine on a
        copy of another engine's model.
        device: where the step runs; the CPU only when asked for."""
        if input_format not in ("rgb8", "yuv420"):
            raise ValueError(f"unknown input_format {input_format!r}")
        if input_format == "yuv420" and (input_hw[0] % 4 or input_hw[1] % 2):
            raise ValueError(
                f"yuv420 infeed needs H%4==0 and W%2==0; got {input_hw}"
            )
        self.device = torch.device(device)
        self.variables = None if variables is None else read_flax_weights(variables)
        if self.variables is not None:
            load_flax_weights(model, self.variables)
        self.quant_scales = dict(quant_scales) if quant_scales else None
        if self.quant_scales is not None:
            quantize_model(model, self.quant_scales, weights=self.variables)
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
        self.fused_decode = fused_decode
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
        """uint8 batch on the device -> DecodedSkeletons on the device.
        Span `engine/step` (`utils/tracing.py`), holding `engine/network`
        and `engine/decode`; a `fused_decode`'s body runs in it alone."""
        with tracing.span("engine/step", device=self.device, frames=int(images_u8.shape[0])):
            return self._step_body(images_u8)

    def _step_body(self, images_u8: torch.Tensor) -> DecodedSkeletons:
        """The step outside inference mode, which `torch.export` traces
        (`save`); a `fused_decode` is entered through its `body` where it has
        one."""
        if self.fused_decode is not None:
            if self.input_format == "yuv420":
                images_u8 = (yuv420_to_rgb(images_u8) + 0.5).to(torch.uint8)
            return getattr(self.fused_decode, "body", self.fused_decode)(images_u8)
        with tracing.span("engine/network", device=self.device):
            if self.input_format == "yuv420":
                x = (yuv420_to_rgb(images_u8) / 255.0).to(self.dtype)
            else:
                x = images_u8.to(self.dtype) / 255.0
            out = self.model(x)
        return self.decode_outputs(out)

    def decode_outputs(self, out: dict) -> DecodedSkeletons:
        """The step's part after the network: its outputs `out`, of images
        of `input_hw`, decoded (the PAF decoder, or the `fused_decode`'s
        `decode`, which a row-sharded step needs: `parallel/stream_shard.py`).
        Span `engine/decode`."""
        with tracing.span("engine/decode", device=self.device):
            if self.fused_decode is not None:
                return self.fused_decode.decode(out, self.input_hw)
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
        if self.fused_decode is not None and not self._out_mh:
            raise RuntimeError(
                "call warmup() before the packed path on a custom-decoder "
                "engine (its output sizes are learnt from the step)"
            )
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
        with tracing.span("engine/preprocess"):
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
        with tracing.span("engine/device_step"):
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
        """Persist the weights (the JAX package's flat npz: the float32
        `variables` the engine was given, else the model's own) and the
        serialized step, traced by `torch.export` at this engine's batch
        shape on its device, with the kernels as `hyperpose::` operators
        (reference analog: dnn::tensorrt::save, src/tensorrt.cpp:463-471).
        Returns {"weights": prefix.npz, "executable": prefix.pt2}."""
        from ..utils.export import export_npz, export_serialized

        npz = export_npz(self.variables if self.variables is not None else self.model,
                         path_prefix + ".npz")
        example = torch.zeros(self.input_batch_shape(), dtype=torch.uint8, device=self.device)
        exe = export_serialized(_EngineStep(self), (example,), path_prefix + ".pt2")
        return {"weights": npz, "executable": exe}

    @staticmethod
    def load_executable(path: str):
        """Load a serialized step (`save`); returns fn(images_u8) -> tuple
        (coords, part_scores, part_valid, scores, valid) on the device it was
        saved from, for uint8 batches of the saved shape."""
        from ..utils.export import load_serialized

        return load_serialized(path)


class _EngineStep(nn.Module):
    """An engine's step as a module for `torch.export`: the model is a
    submodule (its weights become the program's), and the output is the
    `DecodedSkeletons` fields as a tuple."""

    def __init__(self, engine: PoseEngine):
        super().__init__()
        self.model = engine.model
        self.engine = engine

    def forward(self, images_u8: torch.Tensor):
        d = self.engine._step_body(images_u8)
        return d.coords, d.part_scores, d.part_valid, d.scores, d.valid

