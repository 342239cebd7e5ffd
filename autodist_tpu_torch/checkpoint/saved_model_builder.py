"""The model export: ``apply_fn`` and its parameters, served without the
model's Python code.

Port of the JAX package's ``checkpoint/saved_model_builder.py``, whose
artifact is a StableHLO export.  Here it is a ``torch.export`` program:

* ``model.pt2`` — ``torch.export.save`` of a module whose ``forward(params,
  *inputs)`` calls ``apply_fn``.  The parameters are inputs of the
  program, as the JAX export passes them (a flat dict keyed by the
  ``/``-joined names; an int8 ``Quantized`` leaf as ``<name>/q`` and
  ``<name>/scale``), and the shapes are the example inputs', static.
* ``variables/`` — :func:`~autodist_tpu_torch.checkpoint.save_params` of the
  parameters: one ``.npy`` per leaf under ``params/`` and an
  ``index.json``, which numpy reads without this package.
* ``saved_model_meta.json`` — the JAX keys ``num_inputs`` and
  ``input_shapes``, and ``quantized`` (the names of the int8 leaves) and
  ``platforms``.

``platforms`` is the counterpart of the JAX export's ``("cpu", "tpu")``: a
model trained on the card is served on a CPU, and the other way round.
The loader moves the program to the device it serves on
(``torch.export.passes.move_to_device_pass``: the constants that tracing
baked in, such as a mask made on ``cuda``), and the port's kernels in the
program are registered operators that dispatch by device: the flash
forward K1 (``torch.ops.autodist_tpu_torch.flash_fwd``) and the int8
matmul K10 (``torch.ops.autodist_tpu_torch.int8_matmul``) launch their
kernels on CUDA tensors and run their plain versions on CPU tensors.

Loading needs ``import autodist_tpu_torch.ops``, which registers those
operators (this module imports it), and not the model's code: that is the
JAX artifact's need for its runtime's custom calls.  The paged decode
engine (K9) is not an ``apply_fn`` and is not exported.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

import autodist_tpu_torch.ops  # noqa: F401  (registers K1 and K10)
from autodist_tpu_torch.checkpoint.saver import read_item, save_params
from autodist_tpu_torch.graph_item import flatten, unflatten
from autodist_tpu_torch.ops.quant import Quantized

log = logging.getLogger(__name__)

PROGRAM_FILE = "model.pt2"
META_FILE = "saved_model_meta.json"


def _flat(params) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``({name: tensor}, quantized names)``: the program's parameter
    input, in the catalog order in which the loader rebuilds it from
    ``variables/``."""
    flat: Dict[str, torch.Tensor] = {}
    quantized: List[str] = []
    for name, leaf in flatten(params):
        if isinstance(leaf, Quantized):
            flat[f"{name}/q"], flat[f"{name}/scale"] = leaf.q, leaf.scale
            quantized.append(name)
        else:
            flat[name] = leaf
    return flat, quantized


def _nest(flat: Dict[str, torch.Tensor], quantized: Sequence[str]):
    """The parameter tree of :func:`_flat`'s output."""
    tree = unflatten(list(flat.items()))
    for name in quantized:
        *parents, last = name.split("/")
        node = tree
        for p in parents:
            node = node[p]
        node[last] = Quantized(q=node[last]["q"], scale=node[last]["scale"])
    return tree


class _Program(torch.nn.Module):
    """``forward(params, *inputs) = apply_fn(tree of params, *inputs)``."""

    def __init__(self, apply_fn: Callable, quantized: Sequence[str]):
        super().__init__()
        self.apply_fn = apply_fn
        self.quantized = tuple(quantized)

    def forward(self, params: Dict[str, torch.Tensor], *inputs):
        return self.apply_fn(_nest(params, self.quantized), *inputs)


def _as_input(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=device)


class SavedModelBuilder:
    """Export ``apply_fn(params, *inputs)`` and its parameters for
    serving.  ``platforms`` lists the device types the artifact may be
    served on (the default covers CPU serving of a model trained on the
    card)."""

    def __init__(self, export_dir: str,
                 platforms: Sequence[str] = ("cpu", "cuda")):
        unknown = sorted(set(platforms) - {"cpu", "cuda"})
        if unknown:
            raise ValueError(f"platforms {unknown}: the port serves on "
                             f"'cpu' and 'cuda'")
        self._dir = export_dir
        self._platforms = tuple(platforms)
        os.makedirs(export_dir, exist_ok=True)

    def add_graph_and_variables(self, apply_fn: Callable, params: Any,
                                example_inputs: Sequence[Any]) -> None:
        """Trace ``apply_fn`` on the example inputs (with the parameters'
        device) and write the program, the parameter values and the
        meta."""
        flat, quantized = _flat(params)
        device = next(iter(flat.values())).device
        inputs = tuple(_as_input(x, device) for x in example_inputs)
        with torch.no_grad():
            program = torch.export.export(_Program(apply_fn, quantized),
                                          (flat, *inputs), strict=False)
        program.example_inputs = None   # the parameters go to variables/
        torch.export.save(program, os.path.join(self._dir, PROGRAM_FILE))
        save_params(os.path.join(self._dir, "variables"), unflatten(
            list(flat.items())))
        with open(os.path.join(self._dir, META_FILE), "w",
                  encoding="utf-8") as f:
            json.dump({"num_inputs": len(inputs),
                       "input_shapes": [list(x.shape) for x in inputs],
                       "quantized": quantized,
                       "platforms": list(self._platforms)}, f)

    def save(self) -> str:
        log.info("saved model exported to %s", self._dir)
        return self._dir


def _serving_device(device) -> torch.device:
    """``device``, else the CUDA card (raising without one, as every entry
    point of the port does); on CUDA with TF32 off, as the models run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' explicitly to "
                "serve the export on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def load_saved_model(export_dir: str, device=None):
    """Load an export: returns ``fn(*inputs)`` with the parameters bound,
    serving on ``device`` (the CUDA card unless the caller asks for the
    CPU).  Inputs may be tensors or numpy arrays."""
    with open(os.path.join(export_dir, META_FILE), encoding="utf-8") as f:
        meta = json.load(f)
    dev = _serving_device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"the export at {export_dir} serves on "
                         f"{meta['platforms']}, not on {dev.type}")
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(
        torch.export.load(os.path.join(export_dir, PROGRAM_FILE)), dev)
    params = {name: t.to(dev) for name, t in flatten(
        read_item(os.path.join(export_dir, "variables"), "params"))}
    module = program.module()

    def fn(*inputs):
        if len(inputs) != meta["num_inputs"]:
            raise ValueError(f"the export takes {meta['num_inputs']} "
                             f"inputs, got {len(inputs)}")
        return module(params, *(_as_input(x, dev) for x in inputs))

    return fn
