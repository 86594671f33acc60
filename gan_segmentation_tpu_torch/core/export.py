"""Serving export: freeze an inference program into files that a process
with no model code loads and serves (the PyTorch counterpart of
``gan_segmentation_tpu/core/export.py``).

A program is traced by ``torch.export`` into ATen ops and the custom ops
of kernels 1 and 2 (``torch.ops.gst.*``, ``kernels/ops.py``), on the
device it will serve on: the traced graph asserts its inputs' device.
Two forms, as in the JAX package:

- an artifact: ONE ``.pt2`` file (``torch.export.save``) holding the
  program, its weights and its record (``meta.json`` inside);
- a bundle: a directory of ``program.pt2`` (the program, traced with its
  weights as an input, so it holds none of their bytes), ``weights.pt``
  (the flat state dict; rewriting it alone changes what is served) and
  ``meta.json``.

Serving, in a process that imports only this module::

    from gan_segmentation_tpu_torch.core.export import (draw_inputs,
                                                        load_bundle)
    serve = load_bundle("generate.bundle")
    gen = torch.Generator("cuda").manual_seed(seed * 2 ** 32 + i)
    images, masks = serve(*draw_inputs(serve.meta, gen))

which is batch ``i`` of ``FusedPipeline`` from ``seed``.  On a CUDA
artifact the callable replays one CUDA graph (``core/graphs.py``), the
counterpart of the JAX artifact running under jit.  An artifact serves on
the device type it was exported for; cross-device lowering is not ported.

Two surfaces are exported: the fused z -> (uint8 image, uint8 mask)
pipeline (``train/generator.py::FusedProgram``) and the DeepLab multi-scale
+ flip evaluator at one input shape
(``train/deeplab_trainer.py::MultiEvalModel.scores``).
"""

import contextlib
import functools
import json
import logging
import os
import warnings
import zipfile
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..kernels import _build, ops  # noqa: F401  (registers torch.ops.gst.*)
from .graphs import GraphedCall

log = logging.getLogger(__name__)

META, PROGRAM, WEIGHTS = "meta.json", "program.pt2", "weights.pt"


@contextlib.contextmanager
def _archive():
    """Around ``torch.export.save`` / ``load``: silences the archive's
    notes on weights that do not cover their whole storage (views) and on
    reading weights from its read-only buffer."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "No complete tensor found")
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        yield


def export_callable(module: nn.Module, example_args: Sequence):
    """``torch.export`` of ``module`` for the shapes, dtypes and device of
    ``example_args`` (tensors, or dicts of them), under ``no_grad``; the
    weights are the module's parameters and buffers.

    One eager call runs first: it fills the caches that the body keeps
    per device (the blur kernels, the mask's bit weights, the kernels'
    launch plans) with real tensors, which the trace then reads as
    constants.  Filled during the trace, they would hold fake tensors."""
    args = tuple(example_args)
    with torch.no_grad():
        module(*args)
        program = torch.export.export(module, args)
    program.example_inputs = None  # the files carry no example inputs
    return program


def _record(weights, device: torch.device, meta: Optional[dict]) -> dict:
    record = {"device": device.type, "torch": torch.__version__,
              "kernels": _build._source_tag(), "n_weights": len(weights)}
    record.update(meta or {})
    return record


def _device_of(example_args) -> torch.device:
    return pytree.tree_leaves(example_args)[0].device


def save_artifact(path: str, module: nn.Module, example_args: Sequence,
                  meta: Optional[dict] = None):
    """Export ``module`` and write the hermetic artifact to ``path`` (the
    weights and the record inside); returns the ``ExportedProgram``."""
    program = export_callable(module, example_args)
    record = _record(program.state_dict, _device_of(example_args), meta)
    with _archive():
        torch.export.save(program, path,
                          extra_files={META: json.dumps(record)})
    log.info("serialized %s (%d bytes, %s)", path, os.path.getsize(path),
             record)
    return program


class _WeightsAsInputs(nn.Module):
    """``forward(weights, *args)`` = ``module(*args)`` with ``module``'s
    state dict replaced by ``weights`` (``torch.func.functional_call``):
    traced, a program whose weights are inputs, not contents."""

    def __init__(self, module: nn.Module):
        super().__init__()
        # not a submodule: its weights must not become this module's
        object.__setattr__(self, "inner", module)

    def forward(self, weights, *args):
        return torch.func.functional_call(self.inner, weights, args)


def save_bundle(dir_path: str, module: nn.Module, example_args: Sequence,
                meta: Optional[dict] = None):
    """Export ``module`` as a bundle directory: ``program.pt2`` takes the
    weights as its first input (a dict) and holds none of their bytes,
    ``weights.pt`` is ``module``'s state dict, ``meta.json`` the record
    (with each weight's name, shape and dtype).  Returns the
    ``ExportedProgram``.  Load with :func:`load_bundle`."""
    weights = {k: v.detach() for k, v in module.state_dict().items()}
    program = export_callable(_WeightsAsInputs(module),
                              (weights, *example_args))
    record = _record(weights, _device_of(example_args), meta)
    record["weights"] = [[k, list(v.shape), str(v.dtype).replace(
        "torch.", "")] for k, v in weights.items()]
    os.makedirs(dir_path, exist_ok=True)
    torch.save(weights, os.path.join(dir_path, WEIGHTS))
    with _archive():
        torch.export.save(program, os.path.join(dir_path, PROGRAM))
    with open(os.path.join(dir_path, META), "w") as fh:
        json.dump(record, fh, indent=1)
    log.info("serialized bundle %s (%d weight tensors)", dir_path,
             len(weights))
    return program


def load_bundle_meta(dir_path: str) -> dict:
    """The record ``save_bundle`` wrote (empty when there is none)."""
    try:
        with open(os.path.join(dir_path, META)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _artifact_meta(path: str) -> dict:
    """The record inside an artifact, read without loading its program."""
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if os.path.basename(name) == META:
                return json.loads(zf.read(name))
    raise ValueError(f"{path} holds no {META}: not an artifact of "
                     f"core.export")


def _serving_device(meta: dict, device) -> torch.device:
    """The device to serve ``meta``'s program on: ``device`` or, when None,
    the one it was exported for.  Raises for another device type."""
    kind = meta.get("device")
    want = torch.device(device if device is not None else kind)
    if want.type != kind:
        raise ValueError(f"the program was exported for {kind} and serves "
                         f"only there, not on {want.type} (cross-device "
                         f"export is not ported)")
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the program was exported for cuda: no CUDA "
                               "device here")
        if want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
    return want


def _run(module, inputs):
    with torch.no_grad():
        return module(*inputs)


class Served:
    """The serving callable of an artifact or bundle: ``serve(*inputs)``
    -> the program's outputs; ``meta`` is its record.  Inputs are copied
    to the serving device.  On a CUDA device every call copies them into
    static tensors and runs one ``GraphedCall`` (the first call eagerly,
    the second captures, later calls replay), and returns copies of its
    outputs that the next call does not overwrite.  A bundle's program
    takes ``weights`` (resident on the device) before the inputs."""

    def __init__(self, program, meta: dict, device: torch.device,
                 weights: Optional[dict] = None):
        self.meta = meta
        self.device = device
        self.module = program.module()
        self.bound = () if weights is None else (weights,)
        self.call: Optional[GraphedCall] = None
        self._static = None

    def __call__(self, *inputs):
        inputs = pytree.tree_map(lambda t: torch.as_tensor(t).to(
            self.device), inputs)
        if self.device.type == "cpu":
            return _run(self.module, (*self.bound, *inputs))
        if self.call is None:
            self._static = pytree.tree_map(torch.empty_like, inputs)
            self.call = GraphedCall(functools.partial(
                _run, self.module, (*self.bound, *self._static)),
                self.device)
        for s, t in zip(pytree.tree_leaves(self._static),
                        pytree.tree_leaves(inputs)):
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"input {tuple(t.shape)} {t.dtype}: the "
                                 f"program takes {tuple(s.shape)} {s.dtype}")
            s.copy_(t)
        return pytree.tree_map(torch.clone, self.call())


def load_artifact(path: str, device=None) -> Served:
    """Load a :func:`save_artifact` file; returns its serving callable."""
    meta = _artifact_meta(path)
    dev = _serving_device(meta, device)
    with _archive():
        program = torch.export.load(path)
    return Served(program, meta, dev)


def read_bundle(dir_path: str, device=None):
    """-> (program, weights, meta, device) of a :func:`save_bundle`
    directory: ``weights`` (on the serving device, in the program's order)
    is checked against the record's names, shapes and dtypes."""
    meta = load_bundle_meta(dir_path)
    dev = _serving_device(meta, device)
    with _archive():
        program = torch.export.load(os.path.join(dir_path, PROGRAM))
    weights = torch.load(os.path.join(dir_path, WEIGHTS), map_location=dev,
                         weights_only=True)
    want = {k: (shape, dtype) for k, shape, dtype in meta["weights"]}
    if set(weights) != set(want):
        raise ValueError(f"{WEIGHTS} names {sorted(set(weights) ^ set(want))}"
                         f" that the program does not, or misses them")
    for k, v in weights.items():
        shape, dtype = want[k]
        if list(v.shape) != shape or str(v.dtype) != f"torch.{dtype}":
            raise ValueError(f"{WEIGHTS}: {k} is {tuple(v.shape)} {v.dtype},"
                             f" the program takes {tuple(shape)} {dtype}")
    return program, {k: weights[k] for k in want}, meta, dev


def load_bundle(dir_path: str, device=None) -> Served:
    """Load a :func:`save_bundle` directory; returns its serving callable
    with the weights of ``weights.pt`` bound (no model code needed)."""
    program, weights, meta, dev = read_bundle(dir_path, device)
    return Served(program, meta, dev, weights)


def draw_inputs(meta: dict, generator: torch.Generator):
    """(z, noise) of a generate program's batch, drawn from ``generator``
    on its device in ``ImageGenerator.draw_inputs``' order: z, then every
    noise input in ``StyleGanGenerator.draw_noise``'s order."""
    dev = generator.device
    z = torch.empty(meta["z"], device=dev).normal_(generator=generator)
    noise = {name: torch.empty(shape, device=dev).normal_(
        generator=generator) for name, shape in meta["noise"]}
    return z, noise


def _fused_inputs(pipeline, batch_size: Optional[int]):
    """(program, example inputs, record) of a ``FusedPipeline`` batch."""
    b = batch_size or pipeline.gen.batch_size
    gen = pipeline.gen
    z = torch.zeros((b, gen.cfg.latent_size), device=gen.device)
    shapes = gen.model.noise_shapes(b)
    noise = {k: torch.zeros(s, device=gen.device) for k, s in shapes.items()}
    meta = {"kind": "generate", "batch": b, "z": list(z.shape),
            "noise": [[k, list(s)] for k, s in shapes.items()],
            "decoder_dtype": str(pipeline.dec_dtype).replace("torch.", ""),
            "generator_dtype": str(gen.model.compute_dtype).replace(
                "torch.", ""),
            "masks_packed": pipeline._pack_masks,
            "quant": pipeline.quant,
            "resolution": 2 ** gen.cfg.max_res_log2}
    return pipeline.program(), (z, noise), meta


def export_fused_pipeline(pipeline, batch_size: Optional[int] = None,
                          path: Optional[str] = None):
    """Freeze a trained ``FusedPipeline`` (generator weights and the
    decoder's folded kernels inside).  Signature of the program:
    ``(z (B, latent) f32, noise {name: (B, H, W, 1) f32}) -> (images (B,
    H, W, 3) u8, masks u8)``, masks in the pipeline's wire format
    (bit-packed 8 px/byte along W when binary).  With ``path`` the
    artifact is written there.  Returns the ``ExportedProgram``."""
    program, args, meta = _fused_inputs(pipeline, batch_size)
    if path is None:
        return export_callable(program, args)
    return save_artifact(path, program, args, meta)


def export_fused_pipeline_bundle(pipeline, batch_size: Optional[int] = None,
                                 dir_path: str = "generate.bundle"):
    """Bundle form of :func:`export_fused_pipeline` (program + weights
    directory), the form for the full-size generator's ~10^8 bytes of
    weights."""
    program, args, meta = _fused_inputs(pipeline, batch_size)
    return save_bundle(dir_path, program, args, meta)


class _EvalProgram(nn.Module):
    """``MultiEvalModel.scores`` as a module over the evaluator's model."""

    def __init__(self, eval_model):
        super().__init__()
        self.model = eval_model.model
        self.evaluator = eval_model

    def forward(self, images):
        return self.evaluator.scores(images)


def export_eval_model(eval_model, batch: int, height: int, width: int,
                      channels: int, path: Optional[str] = None):
    """Freeze a ``MultiEvalModel`` for one input shape: ``images (B, H, W,
    C) f32 normalised -> scores (B, H, W, nclass) f32``, the whole
    multi-scale + flip sliding-window protocol with the DeepLab weights
    inside.  With ``path`` the artifact is written there.  Returns the
    ``ExportedProgram``."""
    images = torch.zeros((batch, height, width, channels),
                         device=eval_model.device)
    meta = {"kind": "deeplab_eval", "input": list(images.shape),
            "nclass": eval_model.nclass, "crop_size": eval_model.crop_size,
            "base_size": eval_model.base_size, "flip": eval_model.flip,
            "scales": list(eval_model.scales)}
    module = _EvalProgram(eval_model)
    if path is None:
        return export_callable(module, (images,))
    return save_artifact(path, module, (images,), meta)
