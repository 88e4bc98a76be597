"""The asynchronous, collective checkpoint backend (``TRAINING.CHECKPOINT_BACKEND:
orbax``): the port's counterpart of ``openviic_tpu/training/orbax_backend.py``,
written through ``torch.distributed.checkpoint`` (DCP), since the card's
machine has no Orbax.

It keeps the JAX module's contracts:

 - **slots**: the directories ``last_model.orbax`` and
   ``best_model.orbax``, as there.  The format inside is DCP's: a
   ``.metadata`` file and the ``__<rank>_<n>.distcp`` data files;
 - **asynchronous saves**: the call copies every tensor to the host
   (``_payload``: a copy of its own, whatever DCP's default stager does
   in a given torch version, so steps taken during the write cannot reach
   it) and ``dcp.async_save`` writes them to disk in a background thread,
   so training goes on while the checkpoint lands.  ``wait()`` finishes the
   write and re-raises any error from it (DCP's ``CheckpointException``,
   a ``BaseException``); a failed write leaves the previous checkpoint in
   place;
 - **the staging swap**: a save goes to ``<path>.staging``, which the next
   ``wait()`` swaps into ``path``, so the previous checkpoint survives the
   whole write.  ``load_checkpoint`` of a missing ``path`` adopts a
   finished staging directory (DCP writes ``.metadata`` last, so its
   presence is the test) and never an unfinished one;
 - **collective** (``MULTIHOST_COLLECTIVE``): under a process group every
   rank calls ``save_checkpoint``, ``load_checkpoint``, ``copy`` and
   ``wait`` in lockstep (the trainer calls every rank into such a
   backend).  DCP's own collectives run on a gloo group of their own, so
   a background write never interleaves with the training's collectives.
   Only rank 0 changes the filesystem outside DCP (the staging clean-up,
   the swap, the adoption, the best copy), each change fenced by a
   barrier whose name carries a counter (JAX's ``_sync``): ranks whose
   calls fall out of step fail there instead of pairing the wrong
   barriers.  The filesystem is assumed shared by the ranks.

Payload: what the native file holds (``training/checkpoint.py``): the
model's ``state_dict`` (``model/<name>``), the optimizer's tensors
(``optimizer/<index>/<key>``), the generator's state (``generator``) and,
in ``meta`` (the bytes of a ``torch.save``, read back with
``weights_only``), the format tag ``FORMAT``, the step, the optimizer's
parameter groups and other values, the schedule's state, numpy's global
RNG state (restored on load) and the extras.  A load restores nothing
before it has read ``meta`` and found ``FORMAT`` there: anything else (a
directory that the JAX package's Orbax backend wrote among them) raises
``ValueError``.  The restore reads every tensor's shape and dtype from the
checkpoint's own metadata, not from the live optimizer, so an SCST save
loads into an XE-phase trainer and the other way round.  ``frozen_mask``
is accepted and ignored, as in the JAX module: the whole model is saved."""

from __future__ import annotations

import io
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from openviic_tpu_torch.parallel import runtime

LAST_NAME = "last_model.orbax"
BEST_NAME = "best_model.orbax"
FORMAT = "openviic_tpu_torch.dcp/1"
META = "meta"


def _to_bytes(obj) -> torch.Tensor:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8)


def _from_bytes(tensor: torch.Tensor):
    return torch.load(io.BytesIO(tensor.numpy().tobytes()), weights_only=True)


def _dcp_call(fn, *args, group=None, **kwargs):
    """``fn`` (a DCP entry point) over ``group``; in one process with
    ``no_dist``, where this torch has it, and without DCP's warning that
    it assumes one process."""
    import inspect
    import warnings

    params = inspect.signature(fn).parameters
    if group is None and "no_dist" in params:
        kwargs["no_dist"] = True
    if "async_stager" in params:  # the payload is staged already
        kwargs["async_stager"] = _staged_stager()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        return fn(*args, process_group=group, **kwargs)


def _host_copy(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.detach().to("cpu", copy=True)


def _staged_stager():
    """DCP's ``AsyncStager`` for a payload that ``_payload`` has copied
    already: it hands the state dict on as it is."""
    from torch.distributed.checkpoint.staging import AsyncStager

    class Staged(AsyncStager):
        _synchronize_after_execute = False

        def stage(self, state_dict):
            return state_dict

        def close(self) -> None:
            pass

    return Staged()


def _payload(model, state: Dict[str, Any], extras: Dict[str, Any]) -> Dict[str, Any]:
    """The flat DCP state dict of a checkpoint (see the module's docstring),
    every tensor a host copy of its own."""
    flat: Dict[str, Any] = {f"model/{k}": _host_copy(v) for k, v in model.state_dict().items()}
    optimizer, scheduler = state.get("optimizer"), state.get("scheduler")
    opt_meta = None
    if optimizer is not None:
        sd = optimizer.state_dict()
        values = {}
        for index, entry in sd["state"].items():
            values[index] = {}
            for key, value in entry.items():
                if torch.is_tensor(value):
                    flat[f"optimizer/{index}/{key}"] = _host_copy(value)
                else:
                    values[index][key] = value
        opt_meta = {"param_groups": sd["param_groups"], "values": values}
    name, keys, pos, has_gauss, cached = np.random.get_state()
    flat["generator"] = state["generator"].get_state()
    flat["numpy_keys"] = torch.from_numpy(keys.astype(np.int64))
    flat[META] = _to_bytes({
        "format": FORMAT, "step": int(state["step"]), "optimizer": opt_meta,
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "numpy": {"name": name, "pos": int(pos), "has_gauss": int(has_gauss),
                  "cached_gaussian": float(cached)},
        "extras": dict(extras)})
    return flat


class OrbaxBackend:
    LAST_NAME = LAST_NAME
    BEST_NAME = BEST_NAME
    # every rank calls save / load / copy / wait in lockstep; the trainer
    # must not gate calls into a collective backend on rank 0
    MULTIHOST_COLLECTIVE = True

    def __init__(self):
        self._future = None  # the background write of the last save
        self._pending_swap = None  # (staging, final) once a save is under way
        self._group = None  # DCP's gloo group, made at the first collective call
        self._sync_n = 0

    # -- the process group ----------------------------------------------
    @staticmethod
    def _collective() -> bool:
        return runtime.process_count() > 1

    @staticmethod
    def _primary() -> bool:
        return runtime.process_index() == 0

    def _process_group(self):
        """DCP's group: a gloo group of every rank (None in one process)."""
        if not self._collective():
            return None
        if self._group is None:
            import torch.distributed as dist

            self._group = dist.new_group(backend="gloo")
        return self._group

    def _sync(self, tag: str) -> None:
        """A barrier fencing a rank-0-only filesystem change, named with a
        counter: every rank must reach the same one."""
        if not self._collective():
            return
        self._sync_n += 1
        name = f"ov_orbax_{tag}_{self._sync_n}"
        names = runtime.all_gather_object(name)
        if any(n != name for n in names):
            raise RuntimeError(f"checkpoint calls out of step across ranks: barriers {names}")

    # -- the backend ------------------------------------------------------
    def save_checkpoint(self, path: str, model, state: Dict[str, Any], extras: Dict[str, Any],
                        frozen_mask=None) -> None:
        """Start writing ``model`` and the step ``state`` (``optimizer``,
        ``scheduler``, ``step``, ``generator``) with ``extras`` to
        ``<path>.staging``; the next ``wait()`` swaps it into ``path``.
        ``frozen_mask`` is ignored (see the module's docstring)."""
        import torch.distributed.checkpoint as dcp

        self.wait()  # the previous save written and swapped
        payload = _payload(model, state, extras)
        final = os.path.abspath(path)
        staging = final + ".staging"
        if self._primary() and os.path.isdir(staging):
            shutil.rmtree(staging)
        self._sync("staging_clean")  # no rank writes into a directory being deleted
        result = _dcp_call(dcp.async_save, payload, checkpoint_id=staging,
                           group=self._process_group())
        self._future = getattr(result, "upload_completion", result)
        self._pending_swap = (staging, final)

    def wait(self) -> None:
        """Finish the background write (re-raising its error, and then
        keeping the previous checkpoint) and swap the staging directory
        into place."""
        future, self._future = self._future, None
        if future is not None:
            try:
                future.result()
            except BaseException:
                self._pending_swap = None
                raise
        if self._pending_swap is None:
            return
        staging, final = self._pending_swap
        self._pending_swap = None
        self._sync("write_done")  # every rank's part is on disk
        if self._primary() and os.path.isdir(staging):
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(staging, final)
        self._sync("swap_done")  # the renamed directory is visible to every rank

    def load_checkpoint(self, path: str) -> Optional[Dict[str, Any]]:
        """The checkpoint at ``path`` as the native backend returns it (its
        fields with the extras merged in, the tensors on the CPU), None when
        there is none; sets numpy's global RNG state.  ``ValueError`` for a
        directory that is not this backend's checkpoint."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint import FileSystemReader
        from torch.distributed.checkpoint.metadata import TensorStorageMetadata

        self.wait()
        if not os.path.isdir(path):
            # a finished staging directory whose swap never ran; never an
            # unfinished one.  Every rank checks before rank 0 renames
            staging = path + ".staging"
            adopt = os.path.isfile(os.path.join(staging, ".metadata"))
            self._sync("adopt_check")
            if adopt:
                if self._primary():
                    os.rename(staging, path)
                self._sync("adopt_staging")
            if not os.path.isdir(path):
                return None
        group = self._process_group()
        try:
            entries = FileSystemReader(path).read_metadata().state_dict_metadata
            if not isinstance(entries.get(META), TensorStorageMetadata):
                raise ValueError(f"no {META!r} entry")
            meta_bytes = torch.empty(entries[META].size, dtype=torch.uint8)
            _dcp_call(dcp.load, {META: meta_bytes}, storage_reader=FileSystemReader(path),
                      group=group)
            meta = _from_bytes(meta_bytes)
        except Exception as exc:
            raise ValueError(f"{path} is not a checkpoint of openviic_tpu_torch's DCP backend "
                             f"(a JAX package Orbax directory, or another one): {exc}") from exc
        if not isinstance(meta, dict) or meta.get("format") != FORMAT:
            raise ValueError(f"{path} is not a checkpoint of openviic_tpu_torch: no format "
                             f"{FORMAT!r}")
        tensors = {k: torch.empty(m.size, dtype=m.properties.dtype)
                   for k, m in entries.items() if k != META}
        _dcp_call(dcp.load, tensors, storage_reader=FileSystemReader(path), group=group)

        optimizer = None
        if meta["optimizer"] is not None:
            state = {int(i): dict(v) for i, v in meta["optimizer"]["values"].items()}
            for key, value in tensors.items():
                if key.startswith("optimizer/"):
                    _, index, leaf = key.split("/", 2)
                    state.setdefault(int(index), {})[leaf] = value
            optimizer = {"state": state, "param_groups": meta["optimizer"]["param_groups"]}
        numpy_state = meta["numpy"]
        np.random.set_state((numpy_state["name"], tensors["numpy_keys"].numpy().astype(np.uint32),
                             numpy_state["pos"], numpy_state["has_gauss"],
                             numpy_state["cached_gaussian"]))
        out = {"model": {k[len("model/"):]: v for k, v in tensors.items()
                         if k.startswith("model/")},
               "optimizer": optimizer, "scheduler": meta["scheduler"], "step": meta["step"],
               "generator": tensors["generator"], "numpy_rng_state": numpy_state}
        out.update(meta["extras"])
        return out

    def copy(self, src: str, dst: str) -> None:
        """``best_model`` <- ``last_model`` (after ``src``'s save is swapped in)."""
        self.wait()
        if self._primary():
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
        self._sync("copy_done")

    def exists(self, path: str) -> bool:
        return os.path.isdir(path) or os.path.isdir(path + ".staging")
