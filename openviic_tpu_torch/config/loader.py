"""YAML -> ConfigNode loader (the port's copy of ``openviic_tpu/config/loader.py``).

PyYAML is imported inside ``get_config``, the one function that parses a
file: the rest of the port, and every entry point that builds its config in
code, runs where PyYAML is not installed."""

from __future__ import annotations

from typing import List, Optional

from openviic_tpu_torch.config.node import ConfigNode

# Keys that at least one shipped reference YAML omits, with safe defaults so
# all nine reference configs parse & build.
_DEFAULTS = {
    ("TRAINING", "SCORE"): "CIDEr",
    ("TRAINING", "GET_SCORES"): True,
    ("TRAINING", "TRAINING_BEAM_SIZE"): 5,
    ("TRAINING", "EVALUATING_BEAM_SIZE"): 3,
    ("TRAINING", "PATIENCE"): 5,
    ("DATASET", "WORKERS"): 0,
    ("DATASET", "LOADER"): "native",
}


def get_config(config_file: str, opts: Optional[List[str]] = None) -> ConfigNode:
    """Load a YAML config file into an attribute-access tree."""
    import yaml

    with open(config_file, "r") as f:
        raw = yaml.safe_load(f)
    config = ConfigNode(raw)

    for (section, key), default in _DEFAULTS.items():
        if section in config and key not in config[section]:
            config[section]._data[key] = default

    # The broken reference configs use BATCH_SIZE instead of
    # FEATURE_BATCH_SIZE/DICT_BATCH_SIZE; map it.
    if "DATASET" in config:
        ds = config["DATASET"]
        if "BATCH_SIZE" in ds and "FEATURE_BATCH_SIZE" not in ds:
            ds._data["FEATURE_BATCH_SIZE"] = ds["BATCH_SIZE"]
        if "BATCH_SIZE" in ds and "DICT_BATCH_SIZE" not in ds:
            ds._data["DICT_BATCH_SIZE"] = ds["BATCH_SIZE"]

    if opts:
        config.merge_from_list(list(opts))
    return config
