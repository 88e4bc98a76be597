"""Batch captioning pipeline (the port's counterpart of
``openviic_tpu/serving.py``).

``CaptioningPipeline(config, checkpoint_dir=...)`` loads a trained
checkpoint of the port (``training/checkpoint.py``) and its ``vocab.bin``,
places the weights on the device once, and captions

 - per-image feature dicts (``caption_features``): each call is padded to
   the fixed batch size, feature rows to multiples of 8;
 - every ``<id>.npy`` of a directory (``caption_directory``), the next
   chunk's files loaded in a background thread while the current one
   decodes;
 - raw images (``caption_images``) through an extraction backbone
   (``data/extraction.py``).

It decodes beam-resident, with the head and the beam-select attention
kernels as ``TRAINING.DECODE_HEAD_KERNEL`` and ``DECODE_ATTN_KERNEL`` say,
as the JAX pipeline does.  ``from_state_dict`` builds one from weights in
memory (or drawn from a seed) instead of a checkpoint.  For RSTNet's
adaptive decoder it computes the language-signal table once, from the
weights as loaded (f32), and hands it to every decode."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from openviic_tpu_torch.builders import build_model
from openviic_tpu_torch.data.instance import Instance, InstanceList
from openviic_tpu_torch.data.vocab import load_vocab
from openviic_tpu_torch.decoding.beam_search import BeamSearcher
from openviic_tpu_torch.training import checkpoint as ckpt
from openviic_tpu_torch.utils import setup_logger

logger = setup_logger()


class CaptioningPipeline:
    def __init__(self, config, checkpoint_dir: Optional[str] = None,
                 beam_size: Optional[int] = None, batch_size: int = 32,
                 use_bf16: bool = True, checkpoint_name: Optional[str] = None,
                 head_kernel: Optional[Union[bool, int]] = None, mesh=None, device="cuda"):
        """Load the checkpoint ``checkpoint_name`` (default ``best_model.ckpt``)
        and ``vocab.bin`` from ``checkpoint_dir`` (default
        ``TRAINING.CHECKPOINT_PATH/MODEL.NAME``) through the backend
        ``TRAINING.CHECKPOINT_BACKEND``.  Raises ``FileNotFoundError`` when
        there is no checkpoint file and ``ValueError`` for a file that is
        not the port's checkpoint (a JAX package checkpoint among them).
        ``mesh`` (decode sharded over cards) is not ported."""
        if mesh is not None:
            raise NotImplementedError("CaptioningPipeline(mesh=...): decoding sharded over "
                                      "several cards is not ported (ROADMAP A.7)")
        checkpoint_dir = checkpoint_dir or os.path.join(config.TRAINING.CHECKPOINT_PATH,
                                                        config.MODEL.NAME)
        vocab = load_vocab(os.path.join(checkpoint_dir, "vocab.bin"))
        io = ckpt.get_backend(config.TRAINING.get("CHECKPOINT_BACKEND", "native"))
        path = os.path.join(checkpoint_dir, checkpoint_name or io.BEST_NAME)
        # (sets numpy's global RNG state, as the JAX module's load does)
        loaded = io.load_checkpoint(path)
        if loaded is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
        self._setup(config, vocab, loaded["model"], beam_size, batch_size, use_bf16,
                    head_kernel, device, seed=0)
        logger.info("Loaded %s (epoch %s)", path, loaded.get("epoch"))

    @classmethod
    def from_state_dict(cls, config, vocab, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                        beam_size: Optional[int] = None, batch_size: int = 32,
                        use_bf16: bool = True, head_kernel: Optional[Union[bool, int]] = None,
                        device="cuda", seed: int = 0) -> "CaptioningPipeline":
        """A pipeline over weights in memory: ``state_dict`` (for example
        ``compat.from_jax.state_dict_from_jax``), or the initialisation
        drawn from ``seed`` when it is None."""
        self = cls.__new__(cls)
        self._setup(config, vocab, state_dict, beam_size, batch_size, use_bf16, head_kernel,
                    device, seed)
        return self

    def _setup(self, config, vocab, state_dict, beam_size, batch_size, use_bf16, head_kernel,
               device, seed):
        """``config`` holds ``MODEL`` and ``TRAINING`` nodes, as the JAX
        pipeline's does.  ``head_kernel`` defaults to
        ``TRAINING.DECODE_HEAD_KERNEL`` and goes to ``BeamSearcher`` as is:
        ``True`` takes the fused head + lse + top-k kernel where the port's
        measured gate says it wins (every call is padded to ``batch_size``
        images), an int that is not a bool forces it (the JAX package's
        row-block size; the port's kernel picks its own tiling).
        ``TRAINING.DECODE_ATTN_KERNEL`` runs every decoder self-attention
        step through the beam-select attention kernel, as in the JAX
        pipeline."""
        self.config = config
        self.vocab = vocab
        self.device = torch.device(device)
        self.model = build_model(config.MODEL, vocab, device=self.device, seed=seed,
                                 init=state_dict is None)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        # RSTNet: the (vocab, d) signal table once per checkpoint, before the
        # cast (the JAX pipeline computes it from its f32 parameters)
        self.language_table = self.model.compute_language_table()
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.model.to(self.compute_dtype)
        self.beam_size = beam_size or config.TRAINING.EVALUATING_BEAM_SIZE
        self.batch_size = batch_size
        if head_kernel is None:
            head_kernel = config.TRAINING.get("DECODE_HEAD_KERNEL", False)
        attn_kernel = config.TRAINING.get("DECODE_ATTN_KERNEL", False) or False
        self.searcher = BeamSearcher(self.model, self.compute_dtype, beam_resident=True,
                                     head_kernel=head_kernel or False,
                                     attn_kernel=bool(attn_kernel))
        self._backbones = {}  # (spec, grid, dim) -> backbone

    def _batch(self, chunk: List[Dict]) -> Dict[str, torch.Tensor]:
        # pad the tail chunk to the fixed batch size with copies of its last
        # item, and feature rows to multiples of 8 (zero rows are masked)
        items = [Instance(**fd) for fd in chunk]
        items += [items[-1]] * (self.batch_size - len(chunk))
        pad_sizes = {}
        for key, v0 in items[0].items():
            if isinstance(v0, np.ndarray) and v0.ndim >= 2:
                longest = max(it[key].shape[0] for it in items)
                pad_sizes[key] = ((longest + 7) // 8) * 8
        arrays = InstanceList(items, pad_sizes=pad_sizes).arrays()
        return {
            key: torch.from_numpy(value).to(
                self.device,
                dtype=self.compute_dtype
                if key.endswith("_features") and value.dtype.kind == "f" else None,
            )
            for key, value in arrays.items()
        }

    def caption_features(self, feature_dicts: List[Dict], return_ids: bool = False):
        """Caption a list of per-image feature dicts (e.g. ``{"region_features":
        (n_regions, d_feature) array}``).  With ``return_ids`` also return
        the (n_images, max_len) int64 token ids."""
        captions: List[str] = []
        ids = []
        for start in range(0, len(feature_dicts), self.batch_size):
            chunk = feature_dicts[start : start + self.batch_size]
            outputs, _ = self.searcher(self._batch(chunk), self.beam_size,
                                       language_table=self.language_table)
            outputs = outputs[: len(chunk)].cpu().numpy()
            ids.append(outputs)
            captions.extend(self.vocab.decode_caption(outputs))
        if return_ids:
            return captions, np.concatenate(ids) if ids else np.zeros((0, 0), np.int64)
        return captions

    def _feature_dim(self) -> int:
        """The feature width an extraction backbone must give this model;
        a dual-stream config must have one width for both streams, since
        both come from the same grid feature map."""
        vis = self.config.MODEL.VISION_EMBEDDING
        dim = vis.get("D_FEATURE", None)
        if dim is None:
            d_region = vis.get("D_REGION_FEATURE", None)
            dim = vis.get("D_GRID_FEATURE", None) or d_region
            if d_region is not None and d_region != dim:
                raise ValueError(
                    "caption_images derives region features from the grid feature map (dim "
                    f"{dim}), which cannot feed a vision embedding expecting "
                    f"D_REGION_FEATURE={d_region}; extract real region features offline "
                    "instead (python -m openviic_tpu_torch.extract_features).")
        return dim

    def backbone(self, spec: str = "patch", grid: int = 7):
        """The extraction backbone ``spec`` at ``grid`` for this model's
        feature width, on the pipeline's device, made once."""
        from openviic_tpu_torch.data.extraction import make_backbone

        key = (spec, grid, self._feature_dim())
        if key not in self._backbones:
            self._backbones[key] = make_backbone(spec, grid, key[2], device=self.device)
        return self._backbones[key]

    def needs_regions(self) -> bool:
        """Whether the model reads region features (every model but the grid
        one): raw images then take their grid cells as regions."""
        return self.config.MODEL.ARCHITECTURE != "StandardTransformerUsingGrid"

    def caption_images(self, images: Iterable, backbone: str = "patch", grid: int = 7,
                       region_boxes: Optional[Dict] = None) -> Dict:
        """Caption raw images: extract features on the pipeline's device,
        then decode.  Each image is a file path (decoded with Pillow), a PIL
        image or an (H, W, 3) uint8 array; the result maps each path, or
        another image's position in ``images``, to its caption.  ``region_boxes`` optionally
        maps a path, its stem or an array's position to (r, 4) normalized
        boxes for ROI-pooled region features; a model that reads regions
        and has no boxes for an image takes its grid cells."""
        from openviic_tpu_torch.data.extraction import (
            extract_feature_dict, grid_boxes, open_image)

        bb = self.backbone(backbone, grid)
        gboxes = grid_boxes(grid)
        keys, feature_dicts = [], []
        for i, image in enumerate(images):
            is_path = isinstance(image, (str, os.PathLike))
            key = image if is_path else i
            boxes = None
            if region_boxes:
                stem = os.path.splitext(os.path.basename(key))[0] if is_path else key
                boxes = region_boxes.get(key, region_boxes.get(stem))
            if boxes is None and self.needs_regions():
                boxes = gboxes
            pixels = open_image(image) if is_path else image
            keys.append(key)
            feature_dicts.append(extract_feature_dict(pixels, bb, gboxes, boxes))
        return dict(zip(keys, self.caption_features(feature_dicts)))

    def caption_directory(self, features_dir: str, image_ids: Optional[Iterable] = None
                          ) -> Dict[str, str]:
        """Caption every ``<id>.npy`` in a directory -> {id: caption}.  The
        next chunk's files load in one background thread while the current
        chunk decodes."""
        if image_ids is None:
            image_ids = [os.path.splitext(f)[0] for f in sorted(os.listdir(features_dir))
                         if f.endswith(".npy")]
        image_ids = list(image_ids)
        if not image_ids:
            return {}

        def load_chunk(ids) -> List[Dict]:
            # the user's own feature files: pickled payload dicts, as the
            # datasets read them
            out = []
            for image_id in ids:
                payload = np.load(os.path.join(features_dir, f"{image_id}.npy"),
                                  allow_pickle=True)[()]
                out.append({k: np.asarray(v, np.float32) for k, v in payload.items()})
            return out

        B = self.batch_size
        chunks = [image_ids[i : i + B] for i in range(0, len(image_ids), B)]
        captions: List[str] = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(load_chunk, chunks[0])
            for n in range(len(chunks)):
                current = fut.result()
                if n + 1 < len(chunks):  # exactly one chunk prefetched
                    fut = ex.submit(load_chunk, chunks[n + 1])
                captions.extend(self.caption_features(current))
        return dict(zip([str(i) for i in image_ids], captions))
