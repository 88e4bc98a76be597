"""Every shipped model config in the port: each yaml under ``configs/`` and
``configs/tpu/`` builds at its own widths with the JAX package's parameter
tree (every leaf carried through ``compat.from_jax`` at its shape; DLCT's
traced over its four streams; RSTNet's with its frozen language model, the
PhoBERT-architecture backbone at vocab 64 001 and hidden 768 that the JAX
package builds offline, its unused pooler included), or, for a family
still to port (none is left), raises ``NotImplementedError`` naming its
ROADMAP item.  The two configs that misspell their architecture
(``dlct-transformer.yaml``, ``rstnet.yaml``: ``StandardStranformerUsingRegion``)
build as the standard transformer in both packages, through the same
alias.  ``shard_model`` at {model 2} refuses none of them (every family
runs under tensor parallelism, as JAX's rules shard every family).  And
``chip_smoke.py``'s in-code trees of the four region families,
of DLCT and of RSTNet (the card's machine has no PyYAML) equal their
yamls' ``MODEL``."""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import get_config as jax_get_config
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat.from_jax import state_dict_from_jax
from openviic_tpu_torch.config import get_config
from tests.test_torch_port_support import make_vocab

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").glob("**/*.yaml"))
# the families still to port, by yaml name: their ROADMAP items (none left)
NOT_PORTED = {}


def _model(path):
    return get_config(str(ROOT / path)).MODEL


def _jax_shapes(path, vocab):
    """The JAX package's parameter shapes for the yaml's model, traced
    without computing, as a flat {"params/a/b": zeros} of those shapes."""
    config = jax_get_config(str(ROOT / path)).MODEL
    model = build_jax_model(config, vocab)
    vis = config.VISION_EMBEDDING
    batch = {"caption_tokens": np.zeros((1, vocab.max_caption_length), np.int32)}
    if config.ARCHITECTURE == "DLCTTransformer":  # regions and a 7 x 7 grid, with boxes
        batch.update(region_features=np.zeros((1, 8, vis.D_REGION_FEATURE), np.float32),
                     region_boxes=np.zeros((1, 8, 4), np.float32),
                     grid_features=np.zeros((1, 49, vis.D_GRID_FEATURE), np.float32),
                     grid_boxes=np.zeros((1, 49, 4), np.float32))
    else:
        key = "grid_features" if config.ARCHITECTURE == "StandardTransformerUsingGrid" \
            else "region_features"
        batch[key] = np.zeros((1, 8, vis.D_FEATURE), np.float32)
    if config.ARCHITECTURE == "ObjectRelationTransformer":
        batch["region_boxes"] = np.zeros((1, 8, 4), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)
    return {k: np.zeros(v.shape, np.float32)
            for k, v in traverse_util.flatten_dict(shapes, sep="/").items()}


def test_every_yaml_is_covered():
    assert len(YAMLS) == 21
    assert {Path(p).name for p in YAMLS} >= set(NOT_PORTED) | {"rstnet_fixed.yaml"}


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_in_the_port_at_its_widths(path):
    vocab = make_vocab(size=40)
    name = Path(path).name
    if name in NOT_PORTED:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {NOT_PORTED[name]}"):
            build_port_model(_model(path), vocab, device="cpu")
        return
    tuned_twin = Path(path).parent.name == "tpu"
    if tuned_twin:  # the same MODEL tree as its parity config but NAME
        parity = _model(str(Path("configs") / name)).to_dict()
        tuned = _model(path).to_dict()
        assert {k: v for k, v in tuned.items() if k != "NAME"} == \
            {k: v for k, v in parity.items() if k != "NAME"}
        return
    model = build_port_model(_model(path), vocab, device="cpu")
    # every JAX leaf carries onto a port parameter of its shape, and back
    state = state_dict_from_jax(_jax_shapes(path, vocab), model)
    assert set(state) == set(model.state_dict())


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_shards_at_model_2(path):
    """Each matched parameter keeps half of its sharded dim, the rest whole;
    every attention's projections are sharded."""
    from openviic_tpu_torch.parallel.mesh import Mesh
    from openviic_tpu_torch.parallel.tensor_parallel import shard_model

    model = build_port_model(_model(path), make_vocab(size=40), device="cpu", init=False)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = shard_model(model, Mesh({"model": 2}, [0, 1], 0, {}, {}))
    local = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for name, spec in specs.items():
        want = tuple(size // 2 if axis == "model" else size
                     for size, axis in zip(full[name], spec + (None,) * len(full[name])))
        assert local[name] == want, name
    assert any(n.endswith("fc_q.weight") and s for n, s in specs.items())
    assert all(s == ("model", None) for n, s in specs.items() if n.endswith("fc_q.weight"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_configs", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    before = sys.dont_write_bytecode
    spec.loader.exec_module(module)  # the script sets dont_write_bytecode for itself
    sys.dont_write_bytecode = before
    return module


@pytest.mark.parametrize("family", ["aoa", "augmented_memory", "meshed_memory", "camo", "dlct",
                                    "rstnet"])
def test_chip_smoke_trees_equal_the_yamls(family):
    chip_smoke = _chip_smoke()
    yaml = {**chip_smoke.FAMILIES, **chip_smoke.TWO_STREAM_FAMILIES,
            **chip_smoke.RSTNET_FAMILIES}[family]
    got = chip_smoke.family_model(family, chip_smoke.FLAGSHIP)
    assert got == _model(f"configs/{yaml}.yaml").to_dict()
    tuned = _model(f"configs/tpu/{yaml}.yaml").to_dict()  # its NAME ends in _tpu
    assert {k: v for k, v in got.items() if k != "NAME"} == \
        {k: v for k, v in tuned.items() if k != "NAME"}


LAYOUTS_FAMILIES = {"aoa": "attention_on_attention", "augmented_memory":
                    "augmented_memory_transformer", "meshed_memory": "meshed_memory_transformer",
                    "camo": "camo_transformer", "ort": "object_relation_transformer",
                    "dlct": "dlct_fixed", "rstnet": "rstnet_fixed"}


@pytest.mark.parametrize("family", list(LAYOUTS_FAMILIES))
def test_layouts_dryrun_trees_equal_the_yamls(family):
    """``parallel/layouts_dryrun.py``'s family trees at the flagship's widths
    are the yamls' ``MODEL`` but NAME and DEVICE, dropout 0."""
    from openviic_tpu_torch.parallel import layouts_dryrun

    opts = layouts_dryrun.parse(["--d-model", "512", "--heads", "8", "--layers", "3",
                                 "--d-ff", "2048", "--d-feature", "1024", "--lm-hidden", "768",
                                 "--lm-vocab", "64001"])

    def plain(node):
        if isinstance(node, dict):
            return {k: (0.0 if k == "DROPOUT" else plain(v)) for k, v in node.items()
                    if k not in ("NAME", "DEVICE")}
        return node
    got = layouts_dryrun.family_model(opts, family)
    assert plain(got) == plain(_model(f"configs/{LAYOUTS_FAMILIES[family]}.yaml").to_dict())
