"""Extract visual features from raw images into per-image ``.npy`` files
(the counterpart of the JAX package's ``scripts/extract_features.py``):

    python -m openviic_tpu_torch.extract_features --image-dir DIR --out DIR
        [--annotations ann.json] [--backbone patch|hf:<vit>] [--grid 7] [--dim 512]
        [--region-boxes boxes.json] [--pixel-boxes] [--grid-as-regions] [--cpu]

It walks an image directory (or a COCO-style annotations JSON's
``images``), decodes each image with Pillow, runs the backbone
(``data/extraction.py``) on the card (``--cpu``: on the CPU) and writes
``<image_id>.npy``: the pickled dict of ``grid_features``, ``grid_boxes``
and, where there are boxes, ``region_features`` and ``region_boxes``,
which the port's ``FeatureDataset`` and ``caption_directory`` read."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(args) -> list:
    """[(image_id, path)] from the annotations JSON or a directory scan."""
    if args.annotations:
        with open(args.annotations) as f:
            data = json.load(f)
        return [(img["id"], os.path.join(args.image_dir, img["file_name"]))
                for img in data["images"]]
    entries = []
    for name in sorted(os.listdir(args.image_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in IMAGE_EXTENSIONS:
            continue
        image_id = int(stem) if stem.isdigit() else stem
        entries.append((image_id, os.path.join(args.image_dir, name)))
    return entries


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Visual feature extraction, PyTorch port")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--annotations", help="COCO-style JSON with images[]")
    ap.add_argument("--backbone", default="patch",
                    help="'patch' or 'hf:<ViT directory or hub name in the local cache>'")
    ap.add_argument("--grid", type=int, default=7)
    ap.add_argument("--dim", type=int, default=None,
                    help="feature dim: the patch backbone's (default 512); for hf:, the width "
                         "the ViT must have (default: its own)")
    ap.add_argument("--region-boxes", help="JSON {image_id: [[x1,y1,x2,y2], ...]}")
    ap.add_argument("--pixel-boxes", action="store_true",
                    help="region boxes are in pixels (default: normalized)")
    ap.add_argument("--grid-as-regions", action="store_true",
                    help="no box source: use the grid cells as region boxes, so that "
                         "region-consuming models get a region stream (the fallback "
                         "caption_images applies)")
    ap.add_argument("--cpu", action="store_true", help="extract on the CPU, not the card")
    args = ap.parse_args(argv)

    from openviic_tpu_torch.data.extraction import (
        extract_feature_dict, grid_boxes, make_backbone, open_image)

    try:
        backbone = make_backbone(args.backbone, args.grid, args.dim,
                                 device="cpu" if args.cpu else "cuda")
    except (ValueError, RuntimeError, FileNotFoundError, KeyError) as e:
        ap.error(str(e))

    region_boxes = {}
    if args.region_boxes:
        with open(args.region_boxes) as f:
            region_boxes = {str(k): np.asarray(v, np.float32) for k, v in json.load(f).items()}

    os.makedirs(args.out, exist_ok=True)
    gboxes = grid_boxes(args.grid)
    entries = list_images(args)
    for image_id, path in entries:
        pixels = open_image(path)
        boxes = region_boxes.get(str(image_id))
        if boxes is not None and args.pixel_boxes:
            h, w = pixels.shape[:2]
            boxes = boxes / np.asarray([w, h, w, h], np.float32)
        if boxes is None and args.grid_as_regions:
            boxes = gboxes
        payload = extract_feature_dict(pixels, backbone, gboxes, boxes)
        np.save(os.path.join(args.out, f"{image_id}.npy"), payload, allow_pickle=True)
    print(f"wrote {len(entries)} feature files to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
