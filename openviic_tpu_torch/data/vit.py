"""The ViT of the ``hf:<name>`` feature backbone, read from a local
HuggingFace directory and written in plain PyTorch under transformers'
names (the model the JAX package's ``HFViTBackbone`` loads with
``FlaxViTModel`` and ``AutoImageProcessor``, ``local_files_only=True``).

Nothing is downloaded and no HuggingFace package is imported:

 - ``resolve``: ``name`` is a directory, or a hub name found in the local
   cache (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
   ``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``;
   there ``models--<org>--<name>/refs/main`` names the snapshot
   ``snapshots/<rev>/``).  Any other name raises the JAX package's
   ``RuntimeError``.
 - ``read_config``: ``config.json``'s ViT fields, transformers' ``ViTConfig``
   defaults for those it lacks.  ``hidden_act`` is the exact (erf) ``gelu``
   or one of transformers' tanh forms; any other is refused.
 - ``read_weights``: ``model.safetensors`` (its 8-byte header length, JSON
   header and raw F32, F16 or BF16 bytes, parsed here) in the layout its
   metadata ``format`` names: ``pt`` (``ViTModel``'s names, Linear weights
   (out, in), the patch projection (d, C, P, P)) or ``flax`` (kernels (in,
   out), the patch kernel (P, P, C, d), LayerNorm ``scale``); else
   ``pytorch_model.bin`` (``torch.load(weights_only=True)``).  A leading
   ``vit.`` (a ``ViTFor*`` head model's base) is stripped; the pooler and
   the head are ignored.  A directory holding only ``flax_model.msgpack``
   is refused: resave it with ``save_pretrained(dir,
   safe_serialization=True)``.
 - ``ViTImageProcessor``: transformers' ``ViTImageProcessor`` steps in its
   order on the device: RGB, PIL's bilinear resize of the uint8 image to
   ``size`` (bit for bit, ``extraction.PilResize``), rescale (in float64,
   then f32), normalise (f32), NCHW.
 - ``ViTModel``: the patch embedding, the CLS token and position
   embeddings, pre-LN encoder layers and the final ``layernorm``, whose
   output is ``last_hidden_state``.  It computes in f32 (the Flax model's
   default dtype) whatever dtype the caption model decodes at.  Every
   product is a matmul, the patch projection an unfold and a matmul rather
   than a convolution, so cuDNN's TF32 default never reaches it; its f32
   products follow ``torch.backends.cuda.matmul.allow_tf32``, off by
   default.

``load_vit(name, device)`` gives (processor, model) on ``device``.  Every
weight the model needs must be in the file, and every key of the file but
the pooler's and a head's must be used: either fault raises, naming the
keys."""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from openviic_tpu_torch.data.extraction import PilResize, rgb_array

CONFIG_NAME = "config.json"
PROCESSOR_NAME = "preprocessor_config.json"
SAFETENSORS_NAME = "model.safetensors"
TORCH_NAME = "pytorch_model.bin"
MSGPACK_NAME = "flax_model.msgpack"

# transformers' ViTConfig defaults, for a config.json that lacks a field
CONFIG_DEFAULTS = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                       intermediate_size=3072, hidden_act="gelu", layer_norm_eps=1e-12,
                       image_size=224, patch_size=16, num_channels=3, qkv_bias=True)
# transformers' activation names -> torch's ``gelu(approximate=)``: the exact
# form and the tanh forms
GELU_FORMS = {"gelu": "none", "gelu_new": "tanh", "gelu_pytorch_tanh": "tanh",
              "gelu_fast": "tanh", "gelu_accurate": "tanh", "gelu_python_tanh": "tanh"}
# ViTImageProcessor's defaults, for a preprocessor_config.json that lacks a field
PROCESSOR_DEFAULTS = dict(do_resize=True, size={"height": 224, "width": 224}, resample=2,
                          do_rescale=True, rescale_factor=1 / 255, do_normalize=True,
                          image_mean=[0.5, 0.5, 0.5], image_std=[0.5, 0.5, 0.5])
BILINEAR = 2  # PIL's Resampling.BILINEAR
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
IGNORED_PREFIXES = ("pooler.",)


def not_cached(name: str, reason: str) -> RuntimeError:
    """The JAX package's error for a backbone it cannot load offline."""
    return RuntimeError(
        f"HF backbone {name!r} is not in the local cache ({reason}).  Pre-seed the HF cache "
        "(offline environments have no network egress) or use the 'patch' backbone.")


def hub_cache() -> str:
    """The local HuggingFace hub cache directory, as ``huggingface_hub``
    finds it."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
        "huggingface")
    return os.path.join(home, "hub")


def resolve(name: str) -> str:
    """The directory of ``name``: the name itself when it is a directory,
    else its snapshot in the local hub cache (``refs/main``'s revision)."""
    if os.path.isdir(name):
        return name
    repo = os.path.join(hub_cache(), "models--" + name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if not os.path.isfile(ref):
        raise not_cached(name, f"no directory {name!r} and no {ref}")
    with open(ref) as f:
        snapshot = os.path.join(repo, "snapshots", f.read().strip())
    if not os.path.isdir(snapshot):
        raise not_cached(name, f"{ref} names the missing snapshot {snapshot}")
    return snapshot


def _read_json(directory: str, filename: str) -> dict:
    path = os.path.join(directory, filename)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"the ViT directory {directory} has no {filename}")
    with open(path) as f:
        return json.load(f)


def read_config(directory: str) -> dict:
    """``config.json``'s ViT fields (``CONFIG_DEFAULTS`` for the absent ones)."""
    raw = _read_json(directory, CONFIG_NAME)
    if raw.get("model_type", "vit") != "vit":
        raise ValueError(f"{os.path.join(directory, CONFIG_NAME)}: model_type "
                         f"{raw['model_type']!r}, expected 'vit'")
    config = {k: raw.get(k, v) for k, v in CONFIG_DEFAULTS.items()}
    if config["hidden_act"] not in GELU_FORMS:
        raise ValueError(f"{os.path.join(directory, CONFIG_NAME)}: hidden_act "
                         f"{config['hidden_act']!r} is not supported; the ViT takes "
                         f"{', '.join(sorted(GELU_FORMS))}")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError(f"hidden_size {config['hidden_size']} does not divide into "
                         f"{config['num_attention_heads']} heads")
    return config


# ------------------------------------------------------------------ weights
def read_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(tensors, metadata) of a safetensors file: an 8-byte little-endian
    header length, the JSON header (each tensor's dtype, shape and byte
    offsets into the data that follows), the raw bytes.  The tensors share
    one buffer read from the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if n <= 0 or 8 + n > size:
            raise ValueError(f"{path}: not a safetensors file (header length {n})")
        header = json.loads(f.read(n))
        data = bytearray(size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: the file ended before its data")
    metadata = header.pop("__metadata__", None) or {}
    out = {}
    for key, info in header.items():
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {key} is {info['dtype']}; the ViT reads "
                             f"{', '.join(SAFETENSORS_DTYPES)}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = math.prod(shape)
        if end - begin != numel * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {key}'s byte range {begin}:{end} does not hold "
                             f"{shape} {info['dtype']}")
        flat = (torch.frombuffer(data, dtype=dtype, count=numel, offset=begin) if numel
                else torch.empty(0, dtype=dtype))
        out[key] = flat.reshape(shape)
    return out, metadata


def _from_flax(key: str, value: torch.Tensor) -> Tuple[str, torch.Tensor]:
    """A Flax-layout key and tensor in ``ViTModel``'s layout."""
    if key.endswith(".kernel"):
        key = key[: -len("kernel")] + "weight"
        # Dense (in, out) -> (out, in); the patch Conv (P, P, C, d) -> (d, C, P, P)
        value = value.t() if value.ndim == 2 else value.permute(3, 2, 0, 1)
    elif key.endswith(".scale"):
        key = key[: -len("scale")] + "weight"
    return key, value.contiguous()


def read_weights(directory: str) -> Tuple[Dict[str, torch.Tensor], str]:
    """(the ViT's weights under ``ViTModel``'s names and layout, the file
    read): the base model's keys only (a ``vit.`` prefix stripped, a head
    model's other keys dropped)."""
    path = os.path.join(directory, SAFETENSORS_NAME)
    if os.path.isfile(path):
        tensors, metadata = read_safetensors(path)
        layout = metadata.get("format", "pt")
        if layout not in ("pt", "flax"):
            raise ValueError(f"{path}: format {layout!r}; the ViT reads 'pt' and 'flax'")
    elif os.path.isfile(os.path.join(directory, TORCH_NAME)):
        path = os.path.join(directory, TORCH_NAME)
        tensors = torch.load(path, map_location="cpu", weights_only=True)
        tensors = tensors.get("state_dict", tensors)
        layout = "pt"
    elif os.path.isfile(os.path.join(directory, MSGPACK_NAME)):
        raise ValueError(
            f"{os.path.join(directory, MSGPACK_NAME)}: Flax's msgpack weights are not read "
            f"here; resave them as {SAFETENSORS_NAME} with "
            "FlaxViTModel.from_pretrained(dir).save_pretrained(dir, safe_serialization=True)")
    else:
        raise FileNotFoundError(f"the ViT directory {directory} has no {SAFETENSORS_NAME} "
                                f"or {TORCH_NAME}")
    if any(k.startswith("vit.") for k in tensors):
        tensors = {k[len("vit."):]: v for k, v in tensors.items() if k.startswith("vit.")}
    out = {}
    for key, value in tensors.items():
        if key.startswith(IGNORED_PREFIXES):
            continue
        if layout == "flax":
            key, value = _from_flax(key, value)
        out[key] = value
    return out, path


# ------------------------------------------------------------ the processor
def _size(size) -> Tuple[int, int]:
    """``size`` as (height, width): an int is a square (transformers'
    ``get_size_dict``)."""
    if isinstance(size, int):
        return size, size
    if isinstance(size, dict) and {"height", "width"} <= set(size):
        return int(size["height"]), int(size["width"])
    raise ValueError(f"ViTImageProcessor size {size!r}: expected an int or height and width")


class ViTImageProcessor:
    """transformers' ``ViTImageProcessor`` on ``device``: an image (PIL or an
    (H, W, 3) uint8 array) -> (1, 3, height, width) f32 ``pixel_values``."""

    def __init__(self, config: dict, device="cuda"):
        kind = config.get("image_processor_type") or config.get("feature_extractor_type")
        if kind not in ("ViTImageProcessor", "ViTFeatureExtractor"):
            raise ValueError(f"image processor {kind!r}: the hf: backbone runs "
                             "ViTImageProcessor only")
        cfg = {k: v if config.get(k) is None else config[k]
               for k, v in PROCESSOR_DEFAULTS.items()}
        if cfg["do_resize"] and cfg["resample"] != BILINEAR:
            raise ValueError(f"ViTImageProcessor resample {cfg['resample']}: only {BILINEAR} "
                             "(bilinear) is computed here")
        self.do_resize, self.do_rescale = bool(cfg["do_resize"]), bool(cfg["do_rescale"])
        self.do_normalize = bool(cfg["do_normalize"])
        self.height, self.width = _size(cfg["size"])
        self.rescale_factor = float(cfg["rescale_factor"])
        self.device = torch.device(device)
        # a scalar is every channel's, as transformers' ``normalize`` takes it
        self.mean, self.std = (
            torch.tensor(np.broadcast_to(np.asarray(cfg[k], np.float32), (3,)).copy(),
                         device=self.device) for k in ("image_mean", "image_std"))
        self._resize = PilResize(self.device)

    def __call__(self, image) -> torch.Tensor:
        if self.do_resize:
            x = self._resize(image, self.height, self.width)
        else:
            x = torch.tensor(rgb_array(image), device=self.device).permute(2, 0, 1).double()
        x = (x * self.rescale_factor) if self.do_rescale else x
        x = x.float()
        if self.do_normalize:
            x = (x - self.mean[:, None, None]) / self.std[:, None, None]
        return x[None]


# ---------------------------------------------------------------- the model
class ViTPatchProjection(nn.Module):
    """The patch embedding's projection: a P x P convolution of stride P
    (no padding), computed as an unfold and a matmul."""

    def __init__(self, channels: int, hidden: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(hidden, channels, patch, patch))
        self.bias = nn.Parameter(torch.empty(hidden))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b, c, h, w = pixels.shape
        p = self.patch
        rows, cols = h // p, w // p
        x = pixels[:, :, : rows * p, : cols * p].reshape(b, c, rows, p, cols, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, rows * cols, c * p * p)
        return x @ self.weight.reshape(self.weight.shape[0], -1).t() + self.bias


class ViTPatchEmbeddings(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.projection = ViTPatchProjection(config["num_channels"], config["hidden_size"],
                                             config["patch_size"])

    def forward(self, pixels):
        return self.projection(pixels)


class ViTEmbeddings(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        d = config["hidden_size"]
        n = (config["image_size"] // config["patch_size"]) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.position_embeddings = nn.Parameter(torch.empty(1, n + 1, d))
        self.patch_embeddings = ViTPatchEmbeddings(config)

    def forward(self, pixels):
        x = self.patch_embeddings(pixels)
        if x.shape[1] + 1 != self.position_embeddings.shape[1]:
            raise ValueError(f"{tuple(pixels.shape[2:])} pixels make {x.shape[1]} patches; the "
                             f"position embeddings hold {self.position_embeddings.shape[1] - 1}")
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        return x + self.position_embeddings


class ViTSelfAttention(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        d = config["hidden_size"]
        self.heads = config["num_attention_heads"]
        self.query = nn.Linear(d, d, bias=config["qkv_bias"])
        self.key = nn.Linear(d, d, bias=config["qkv_bias"])
        self.value = nn.Linear(d, d, bias=config["qkv_bias"])

    def forward(self, x):
        b, n, d = x.shape
        h = self.heads
        split = lambda t: t.reshape(b, n, h, d // h).transpose(1, 2)  # noqa: E731
        # the query scaled before its product, as Flax's dot_product_attention_weights
        q = split(self.query(x)) / math.sqrt(d // h)
        att = torch.softmax(q @ split(self.key(x)).transpose(-1, -2), dim=-1)
        return (att @ split(self.value(x))).transpose(1, 2).reshape(b, n, d)


class ViTSelfOutput(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.dense = nn.Linear(config["hidden_size"], config["hidden_size"])

    def forward(self, x):
        return self.dense(x)


class ViTAttention(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.attention = ViTSelfAttention(config)
        self.output = ViTSelfOutput(config)

    def forward(self, x):
        return self.output(self.attention(x))


class ViTIntermediate(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.dense = nn.Linear(config["hidden_size"], config["intermediate_size"])
        self.approximate = GELU_FORMS[config["hidden_act"]]

    def forward(self, x):
        return nn.functional.gelu(self.dense(x), approximate=self.approximate)


class ViTOutput(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.dense = nn.Linear(config["intermediate_size"], config["hidden_size"])

    def forward(self, x, residual):
        return self.dense(x) + residual


class ViTLayer(nn.Module):
    """Pre-LN: ``x + attention(layernorm_before(x))``, then that plus the
    MLP of its ``layernorm_after``."""

    def __init__(self, config: dict):
        super().__init__()
        d, eps = config["hidden_size"], config["layer_norm_eps"]
        self.attention = ViTAttention(config)
        self.intermediate = ViTIntermediate(config)
        self.output = ViTOutput(config)
        self.layernorm_before = nn.LayerNorm(d, eps=eps)
        self.layernorm_after = nn.LayerNorm(d, eps=eps)

    def forward(self, x):
        x = self.attention(self.layernorm_before(x)) + x
        return self.output(self.intermediate(self.layernorm_after(x)), x)


class ViTEncoder(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(config) for _ in range(config["num_hidden_layers"]))

    def forward(self, x):
        for layer in self.layer:
            x = layer(x)
        return x


class ViTModel(nn.Module):
    """transformers' ``ViTModel`` without its pooler: (b, C, H, W) f32
    pixels -> (b, 1 + patches, hidden) ``last_hidden_state``."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = config
        self.embeddings = ViTEmbeddings(config)
        self.encoder = ViTEncoder(config)
        self.layernorm = nn.LayerNorm(config["hidden_size"], eps=config["layer_norm_eps"])

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.layernorm(self.encoder(self.embeddings(pixel_values)))


def build_vit(config: dict, weights: Dict[str, torch.Tensor], source: str = "the weights",
              device="cuda") -> ViTModel:
    """``ViTModel`` of ``config`` holding ``weights`` (f32) on ``device``,
    frozen, in eval mode.  Raises naming the keys the weights lack, the
    keys nothing uses and the shapes that differ."""
    with torch.device("meta"):
        model = ViTModel(config)
    want = {k: v.shape for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(weights))
    if missing:
        raise KeyError(f"{source} lacks {len(missing)} weight(s) the ViT needs: {missing[:8]}")
    unused = sorted(set(weights) - set(want))
    if unused:
        raise ValueError(f"{source} holds {len(unused)} key(s) the ViT does not use (only the "
                         f"pooler and a head are ignored): {unused[:8]}")
    wrong = [f"{k} {tuple(weights[k].shape)} != {tuple(s)}" for k, s in want.items()
             if weights[k].shape != s]
    if wrong:
        raise ValueError(f"{source}: shapes differ from config.json's: {wrong[:4]}")
    state = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
    model.load_state_dict(state, assign=True)
    return model.requires_grad_(False).eval()


def load_vit(name: str, device="cuda") -> Tuple[ViTImageProcessor, ViTModel]:
    """(processor, model) of the ViT ``name`` (a directory or a hub name in
    the local cache), both on ``device``."""
    directory = resolve(name)
    config = read_config(directory)
    processor = ViTImageProcessor(_read_json(directory, PROCESSOR_NAME), device=device)
    weights, source = read_weights(directory)
    return processor, build_vit(config, weights, source, device=device)
