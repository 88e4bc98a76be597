"""The kernels' build cache (``openviic_tpu_torch/utils/compile_cache.py``
over ``ops/cuda_build.py``) against the JAX package's compilation cache
(``openviic_tpu/utils/compile_cache.py``): JAX's four cases
(``tests/test_compile_cache.py``) on the port, each call's answer held to
JAX's, and the libraries' paths, builds and loads under the cache
directory.  No nvcc runs: a stand-in ``nvcc`` on ``CUDA_HOME`` writes the
library it is asked for and logs each start."""

import os
import stat

import jax
import pytest

import openviic_tpu.utils.compile_cache as jax_cc
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.ops import cuda_build
from openviic_tpu_torch.utils import maybe_enable_compilation_cache


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Both packages' caches off before and after each case."""
    monkeypatch.delenv("OPENVIIC_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(jax_cc, "_ENABLED_DIR", None)
    cuda_build.set_build_dir(None)
    yield
    cuda_build.set_build_dir(None)
    jax.config.update("jax_compilation_cache_dir", None)


def both(path_or_none, empty_config=False):
    """Each package's answer for a config naming ``path_or_none``."""
    training = {} if empty_config else {"COMPILATION_CACHE_DIR": path_or_none}
    return (maybe_enable_compilation_cache(ConfigNode({"TRAINING": training})),
            jax_cc.maybe_enable_compilation_cache(JaxConfigNode({"TRAINING": training})))


def test_disabled_by_default():
    assert both(None, empty_config=True) == (None, None)
    assert maybe_enable_compilation_cache() is None
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR


def test_enables_and_points_the_build_there(tmp_path):
    cache_dir = str(tmp_path / "cache")
    assert both(cache_dir) == (cache_dir, cache_dir)
    assert os.path.isdir(cache_dir)
    for name in cuda_build.sources():
        path = cuda_build.library_path(name)
        assert path.parent == tmp_path / "cache" and path.suffix == ".so"
        cuda_build.set_build_dir(None)  # the name (a hash of sources and flags) stays
        assert cuda_build.library_path(name).name == path.name
        cuda_build.set_build_dir(cache_dir)
    other = str(tmp_path / "other")  # a later call re-points it
    assert both(other) == (other, other)
    assert cuda_build.library_path("head_topk").parent == tmp_path / "other"


def test_env_var_wins(tmp_path, monkeypatch):
    env_dir = str(tmp_path / "env_cache")
    monkeypatch.setenv("OPENVIIC_COMPILE_CACHE", env_dir)
    assert both(str(tmp_path / "cfg_cache")) == (env_dir, env_dir)
    assert cuda_build.build_dir() == tmp_path / "env_cache"


def test_empty_string_force_disables(tmp_path, monkeypatch):
    cache_dir = str(tmp_path / "on_then_off")
    assert both(cache_dir) == (cache_dir, cache_dir)
    assert str(cuda_build.cache_dir()) == cache_dir
    monkeypatch.setenv("OPENVIIC_COMPILE_CACHE", "")
    assert both(cache_dir) == (None, None)
    assert cuda_build.cache_dir() is None and jax_cc._ENABLED_DIR is None
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR
    monkeypatch.delenv("OPENVIIC_COMPILE_CACHE")
    assert both(None, empty_config=True) == (None, None)


def fake_nvcc(root):
    """A ``CUDA_HOME`` whose ``bin/nvcc`` writes its ``-o`` file and appends
    the source it was given to ``root/starts.log``."""
    bin_dir = root / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    script = bin_dir / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'echo "$prev" >> "{root}/starts.log"\n'
        'printf library > "$out"\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(root / "cuda")


def test_a_second_process_finds_the_libraries_without_nvcc(tmp_path, monkeypatch):
    """The first build compiles every source into the cache (each library
    written to a temporary name, then renamed: none is left behind); a
    later one, the cache enabled again as a new process does, starts no
    nvcc and finds every library there.  ``build`` looks for nvcc only
    when it must compile, so a cache that holds everything needs none."""
    monkeypatch.setenv("CUDA_HOME", fake_nvcc(tmp_path))
    monkeypatch.setenv("OPENVIIC_COMPILE_CACHE", str(tmp_path / "cache"))
    assert maybe_enable_compilation_cache() == str(tmp_path / "cache")
    logs = cuda_build.build()
    assert set(logs) == set(cuda_build.sources())
    built = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert built == sorted(cuda_build.library_path(n).name for n in cuda_build.sources())
    assert len((tmp_path / "starts.log").read_text().split()) == len(logs)

    cuda_build.set_build_dir(None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    maybe_enable_compilation_cache()
    assert cuda_build.build() == {}
    assert len((tmp_path / "starts.log").read_text().split()) == len(logs)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["head_topk"], force=True)
