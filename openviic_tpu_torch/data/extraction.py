"""Visual feature extraction: images -> grid and region features (the
port's counterpart of ``openviic_tpu/data/extraction.py``).

The features come in the schema of the ``<id>.npy`` files the datasets
read (``grid_features``, ``grid_boxes``, and ``region_features`` /
``region_boxes`` where boxes are given):

  - ``PatchBackbone``: the deterministic offline extractor, 8 x 8 RGB cell
    thumbnails through a fixed random projection; it runs on a device;
  - ``HFViTBackbone`` (``hf:<name>``): a ViT read from a local HuggingFace
    directory or the local hub cache (``data/vit.py``: nothing is
    downloaded), its patch outputs average-pooled to a g x g grid; it runs
    on a device, at f32;
  - ``roi_pool``: region features pooled from the grid feature map over
    boxes, vectorised over the boxes;
  - ``open_image``: a file or a file-like object decoded with Pillow, which
    is imported there and nowhere else: without Pillow, pass (H, W, 3)
    uint8 arrays."""

from __future__ import annotations

import math

import numpy as np
import torch

CELL = 8  # a grid cell's thumbnail is CELL x CELL pixels


def grid_boxes(g: int) -> np.ndarray:
    """Normalized (x1, y1, x2, y2) for a g x g grid, row-major."""
    edges = np.linspace(0.0, 1.0, g + 1, dtype=np.float32)
    boxes = np.empty((g * g, 4), np.float32)
    for row in range(g):
        for col in range(g):
            boxes[row * g + col] = (edges[col], edges[row], edges[col + 1], edges[row + 1])
    return boxes


def open_image(source) -> np.ndarray:
    """The image at ``source`` (a path or a file-like object) as an (H, W, 3)
    uint8 array, decoded with Pillow."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("decoding an image file needs Pillow (the PIL package), which is "
                          "not installed; pass (H, W, 3) uint8 arrays instead") from exc
    with Image.open(source) as image:
        return rgb_array(image)


def rgb_array(image) -> np.ndarray:
    """An (H, W, 3) uint8 array of ``image``: a PIL image (converted to RGB)
    or an array already of that form."""
    if hasattr(image, "convert"):
        return np.asarray(image.convert("RGB"))
    arr = np.asarray(image)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {arr.dtype} {arr.shape}")
    return arr


PRECISION_BITS = 22  # PIL's fixed-point weights for 8-bit images


def pil_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64: the integer weights with which PIL's
    bilinear resample maps a row of ``in_size`` pixels onto ``out_size``
    (``precompute_coeffs`` and ``normalize_coeffs_8bpc`` of its
    ``Resample.c``: the triangle filter widened by the downscale factor,
    each output's weights normalised to sum 1, then scaled by
    2^PRECISION_BITS and rounded half away from zero)."""
    scale = in_size / out_size
    filter_scale = max(scale, 1.0)
    support, inv = filter_scale, 1.0 / filter_scale  # the triangle filter's support is 1
    out = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [max(1.0 - abs((x + xmin - center + 0.5) * inv), 0.0)
             for x in range(xmax - xmin)]
        total = sum(w)
        for x, wx in enumerate(w):
            k = wx / total if total != 0.0 else wx
            out[xx, xmin + x] = int(k * (1 << PRECISION_BITS) + (0.5 if k >= 0 else -0.5))
    return out


def _fixed_point(sums: torch.Tensor) -> torch.Tensor:
    """PIL's rounding of a fixed-point sum to uint8 (``clip8``), as float64."""
    return torch.floor((sums + (1 << (PRECISION_BITS - 1))) / (1 << PRECISION_BITS)).clamp(0, 255)


class PilResize:
    """PIL's ``resize((width, height), BILINEAR)`` of an 8-bit RGB image on
    ``device``: a horizontal, then a vertical pass of PIL's antialiased
    triangle filter, each with its weights in fixed point (``pil_weights``,
    kept per size) and rounded to uint8.  The integer sums are exact in
    float64 products, so the result is PIL's bit for bit.  A side that
    already has its size is left alone."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._weight_cache = {}

    def _weights(self, in_size: int, out_size: int) -> torch.Tensor:
        key = (in_size, out_size)
        if key not in self._weight_cache:
            self._weight_cache[key] = torch.from_numpy(
                pil_weights(in_size, out_size)).to(self.device)
        return self._weight_cache[key]

    def __call__(self, image, height: int, width: int) -> torch.Tensor:
        """``image`` (PIL or an (H, W, 3) uint8 array) -> (3, height, width)
        float64 holding the resized image's integers 0-255."""
        x = torch.tensor(rgb_array(image), device=self.device)
        x = x.permute(2, 0, 1).double()  # (3, H, W)
        if x.shape[2] != width:
            x = _fixed_point(x @ self._weights(x.shape[2], width).T)
        if x.shape[1] != height:
            x = _fixed_point(self._weights(x.shape[1], height) @ x)
        return x


class PatchBackbone:
    """Deterministic offline extractor: 8 x 8 RGB thumbnails of the g x g
    cells through a fixed projection, drawn with numpy as the JAX module
    draws it (``self.proj`` is bit-equal to its)."""

    def __init__(self, grid: int, dim: int = 512, device="cuda"):
        self.grid = grid
        self.dim = dim
        self.device = torch.device(device)
        rng = np.random.default_rng(0)
        self.proj = rng.normal(size=(CELL * CELL * 3, dim)).astype(np.float32)
        self.proj /= np.sqrt(CELL * CELL * 3)
        self._proj = torch.from_numpy(self.proj).to(self.device)
        self._resize = PilResize(self.device)

    def resize(self, image) -> torch.Tensor:
        """The image as (8g, 8g, 3) uint8 on the device, as PIL's
        ``resize((8g, 8g), BILINEAR)`` makes it (``PilResize``)."""
        side = CELL * self.grid
        return self._resize(image, side, side).permute(1, 2, 0).to(torch.uint8)

    def embed(self, thumbnail: torch.Tensor) -> torch.Tensor:
        """(8g, 8g, 3) uint8 -> (g * g, dim) f32: each cell's pixels in
        [0, 1], row-major, times the projection."""
        g = self.grid
        arr = thumbnail.float() / 255.0
        cells = arr.reshape(g, CELL, g, CELL, 3).permute(0, 2, 1, 3, 4)
        return cells.reshape(g * g, CELL * CELL * 3) @ self._proj

    def __call__(self, image) -> torch.Tensor:
        return self.embed(self.resize(image))


def roi_pool(fmap, gboxes, boxes) -> torch.Tensor:
    """Region features: for each box, the mean of the grid cells weighted by
    their overlap with it; a box that overlaps no cell takes the cell whose
    centre lies nearest its own (the first on ties).  ``fmap`` (cells, d);
    ``gboxes`` (cells, 4) and ``boxes`` (r, 4) as (x1, y1, x2, y2); the
    result (r, d) f32 lies on ``fmap``'s device."""
    fmap = torch.as_tensor(fmap, dtype=torch.float32)
    gboxes = torch.as_tensor(gboxes, dtype=torch.float32, device=fmap.device)
    boxes = torch.as_tensor(np.asarray(boxes, np.float32), device=fmap.device)
    lo = torch.maximum(gboxes[None, :, :2], boxes[:, None, :2])
    hi = torch.minimum(gboxes[None, :, 2:], boxes[:, None, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)  # (r, cells)
    overlaps = inter.amax(1) > 0
    weights = inter / torch.where(overlaps, inter.sum(1), 1.0)[:, None]
    centres = (gboxes[:, :2] + gboxes[:, 2:]) / 2
    box_centres = (boxes[:, :2] + boxes[:, 2:]) / 2
    nearest = ((centres[None] - box_centres[:, None]) ** 2).sum(-1).argmin(1)
    return torch.where(overlaps[:, None], weights @ fmap, fmap[nearest])


def pool_matrix(p: int, g: int) -> np.ndarray:
    """(g * g, p * p) f32: each row averages the patches of one cell of a
    g x g grid over a p x p patch map, row-major, with the JAX backbone's
    edges (``linspace(0, p, g + 1)`` rounded; a cell holds at least one
    patch)."""
    edges = np.linspace(0, p, g + 1).round().astype(int)
    out = np.zeros((g, g, p, p), np.float32)
    for r in range(g):
        for c in range(g):
            rows = slice(edges[r], max(edges[r + 1], edges[r] + 1))
            cols = slice(edges[c], max(edges[c + 1], edges[c] + 1))
            out[r, c, rows, cols] = 1.0
    out = out.reshape(g * g, p * p)
    return out / out.sum(1, keepdims=True)


class HFViTBackbone:
    """A ViT from a local HuggingFace directory (``data/vit.py``): the
    image processor, then the ViT at f32 on ``device``; CLS dropped; the
    p x p patch outputs average-pooled to the g x g grid (``pool_matrix``;
    none when g == p).  Gives (g * g, hidden) f32 on the device.  ``dim``,
    where given, must be the ViT's ``hidden_size``."""

    def __init__(self, model_name: str, grid: int, dim=None, device="cuda"):
        from openviic_tpu_torch.data.vit import load_vit

        self.device = torch.device(device)
        self.processor, self.model = load_vit(model_name, device=self.device)
        self.dim = self.model.config["hidden_size"]
        if dim is not None and dim != self.dim:
            raise ValueError(f"HF backbone {model_name!r} gives {self.dim}-wide features; the "
                             f"model reads {dim}-wide ones")
        self.grid = grid
        self._pools = {}

    @torch.no_grad()
    def embed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) pixel values -> the (g * g, hidden) pooled features."""
        hidden = self.model(pixel_values)[0, 1:]  # drop CLS
        # the position table holds a square map's patches, (image / patch)^2
        p, g = math.isqrt(hidden.shape[0]), self.grid
        if g == p:
            return hidden
        if (p, g) not in self._pools:
            self._pools[(p, g)] = torch.from_numpy(pool_matrix(p, g)).to(self.device)
        return self._pools[(p, g)] @ hidden

    def __call__(self, image) -> torch.Tensor:
        return self.embed(self.processor(image))


def make_backbone(spec: str, grid: int, dim=None, device="cuda"):
    """Backbone from a spec string, on ``device`` (the card unless the
    caller asks for the CPU): "patch" (``dim`` wide, 512 by default) or
    "hf:<model>" (a directory or a hub name in the local cache; ``dim``,
    where given, must be its width)."""
    if spec == "patch":
        return PatchBackbone(grid, 512 if dim is None else dim, device=device)
    if spec.startswith("hf:"):
        return HFViTBackbone(spec[3:], grid, dim, device=device)
    raise ValueError(f"unknown backbone {spec!r}")


@torch.no_grad()
def extract_feature_dict(image, backbone, gboxes, boxes=None) -> dict:
    """One image (a PIL image or an (H, W, 3) uint8 array) -> the ``.npy``
    payload dict the datasets read, as f32 numpy arrays."""
    fmap = backbone(image).float()
    payload = {"grid_features": fmap.cpu().numpy(), "grid_boxes": np.asarray(gboxes, np.float32)}
    if boxes is not None and len(boxes):
        payload["region_features"] = roi_pool(fmap, gboxes, boxes).cpu().numpy()
        payload["region_boxes"] = np.asarray(boxes, np.float32)
    return payload
