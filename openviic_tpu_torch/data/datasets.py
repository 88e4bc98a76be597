"""Caption datasets over pre-extracted features (the port's counterpart of
``openviic_tpu/data/datasets.py``).

 - ``FeatureDataset``: one sample per annotation, the teacher-forcing
   inputs and targets of ``caption_instance`` with the image's features;
 - ``DictionaryDataset``: one sample per image, its file name and every
   reference caption with its features (beam-search eval and SCST);
 - ``ImageDataset``: a ``DictionaryDataset`` whose samples also carry the
   raw image, read with OpenCV (``cv2``, imported where an image is read)
   as BGR uint8 and resized to 512 x 512 with ``INTER_AREA``, for
   visualisation; it runs on the host only.

Features are one ``<image_id>.npy`` per image under
``FEATURE_PATH.FEATURES``: a pickled dict of arrays, f64 and f16 read as
f32.  ``DATASET.CACHE_FEATURES: N`` keeps the last N images' dicts in an
LRU shared by every dataset over one directory."""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Dict, List

import numpy as np

from openviic_tpu_torch.data.instance import Instance
from openviic_tpu_torch.data.preprocess import preprocess_caption


def caption_instance(vocab, caption: List[str], **features) -> Instance:
    """One sample of a preprocessed caption: ``caption_tokens``, the encoded
    caption with its eos replaced by pad (the decoder input), and
    ``shifted_right_caption_tokens``, the encoded caption shifted one step
    left and padded (the target), with the image's ``features``."""
    encoded = vocab.encode_caption(caption)
    shifted = np.full_like(encoded, vocab.padding_idx)
    shifted[:-1] = encoded[1:]
    tokens = np.where(encoded == vocab.eos_idx, vocab.padding_idx, encoded)
    return Instance(caption_tokens=tokens.astype(np.int32),
                    shifted_right_caption_tokens=shifted.astype(np.int32), **features)


class _FeatureSource:
    """Reads one image's ``.npy`` feature dict as float32 arrays.

    ``cache_size`` > 0 keeps parsed dicts in an LRU keyed by the directory
    alone, so the six trainer datasets over one directory share hits; its
    bound is the largest size asked for.  Cached arrays are returned as
    they are: callers must not mutate them."""

    _shared: Dict[str, dict] = {}

    def __init__(self, features_path: str, cache_size: int = 0):
        self.features_path = features_path
        cache_size = int(cache_size or 0)
        self._cache = None
        if cache_size > 0:
            shared = _FeatureSource._shared.setdefault(
                os.path.abspath(features_path),
                {"cache": collections.OrderedDict(), "lock": threading.Lock(), "size": 0})
            shared["size"] = max(shared["size"], cache_size)
            self._shared_entry = shared
            self._cache = shared["cache"]
            self._lock = shared["lock"]

    def load(self, image_id: int) -> Dict[str, Any]:
        if self._cache is not None:
            with self._lock:
                hit = self._cache.get(image_id)
                if hit is not None:
                    self._cache.move_to_end(image_id)
                    return hit
        features = np.load(os.path.join(self.features_path, f"{image_id}.npy"),
                           allow_pickle=True)[()]
        out = {}
        for key, value in features.items():
            arr = np.asarray(value)
            if arr.dtype in (np.float64, np.float16):
                arr = arr.astype(np.float32)
            out[key] = arr
        if self._cache is not None:
            with self._lock:
                self._cache[image_id] = out
                while len(self._cache) > self._shared_entry["size"]:
                    self._cache.popitem(last=False)
        return out


class FeatureDataset:
    """One sample per annotation: teacher-forcing inputs and targets."""

    def __init__(self, json_path: str, vocab, config) -> None:
        with open(json_path, "r") as f:
            json_data = json.load(f)
        self.vocab = vocab
        self.annotations = self.load_json(json_data)
        self.features = _FeatureSource(config.FEATURE_PATH.FEATURES,
                                       config.get("CACHE_FEATURES", 0))

    def load_json(self, json_data: Dict) -> List[Dict]:
        id_to_filename = {img["id"]: img["file_name"] for img in json_data["images"]}
        return [{"caption": preprocess_caption(ann["caption"], self.vocab.tokenizer),
                 "image_id": ann["image_id"],
                 "filename": id_to_filename.get(ann["image_id"])}
                for ann in json_data["annotations"]]

    @property
    def captions(self) -> List[List[str]]:
        return [ann["caption"] for ann in self.annotations]

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        return caption_instance(self.vocab, item["caption"],
                                **self.features.load(item["image_id"]))

    def __len__(self) -> int:
        return len(self.annotations)


class DictionaryDataset:
    """One sample per image with all its reference captions (each
    preprocessed and joined by spaces)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        with open(json_path, "r") as f:
            json_data = json.load(f)
        self.vocab = vocab
        self.image_ids, self.filenames, self.captions_with_image = self.load_json(json_data)
        self.features = _FeatureSource(config.FEATURE_PATH.FEATURES,
                                       config.get("CACHE_FEATURES", 0))

    def load_json(self, json_data: Dict):
        examples: Dict[int, List[str]] = {}
        filenames: Dict[int, str] = {}
        for image in json_data["images"]:
            examples[image["id"]] = []
            filenames[image["id"]] = image["file_name"]
        for ann in json_data["annotations"]:
            caption = preprocess_caption(ann["caption"], self.vocab.tokenizer)
            examples[ann["image_id"]].append(" ".join(caption))
        image_ids = list(examples.keys())
        return image_ids, list(filenames.values()), [examples[i] for i in image_ids]

    def __getitem__(self, idx: int) -> Instance:
        image_id = self.image_ids[idx]
        return Instance(image_id=image_id, filename=self.filenames[idx],
                        captions=self.captions_with_image[idx], **self.features.load(image_id))

    def __len__(self) -> int:
        return len(self.image_ids)


class ImageDataset(DictionaryDataset):
    """``DictionaryDataset`` whose samples also carry ``image``: the file
    ``FEATURE_PATH.IMAGE/<file_name>`` read by ``cv2.imread`` (BGR uint8)
    and resized to 512 x 512 with ``INTER_AREA``."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self.image_path = config.FEATURE_PATH.IMAGE

    def __getitem__(self, idx: int) -> Instance:
        import cv2

        image_id, filename = self.image_ids[idx], self.filenames[idx]
        image_file = os.path.join(self.image_path, filename)
        image = cv2.imread(image_file)
        if image is None:
            raise FileNotFoundError(f"cv2 cannot read the image {image_file}")
        image = cv2.resize(image, (512, 512), interpolation=cv2.INTER_AREA)
        return Instance(image_id=image_id, filename=filename, image=image,
                        captions=self.captions_with_image[idx], **self.features.load(image_id))
