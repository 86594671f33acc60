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
counterpart of the JAX artifact running under jit.

Platforms (the JAX package's cross-platform lowering): a program is
traced on one device, and its record lists the device types it serves on,
by default that one.  ``platforms=("cpu", "cuda")`` lists both: the
program holds ATen ops and the custom ops of kernels 1 and 2, which have a
CPU implementation (the plain version) and a CUDA one (the kernel), so
the loader moves it to the serving device
(``torch.export.passes.move_to_device_pass``, its weights too) and it runs
there.  So an artifact for the card can be exported on a host with no
card.  A device type the record does not list is refused.

Grids: a ``FusedPipeline`` with a mesh (``--dp``, ``--spatial`` or both)
exports its ``GridProgram``, the whole grid's batch as one program whose
weights hold one copy a distinct device; the record names the grid
(``"grid": [D, N]``) and its devices.  ``load_bundle(dir, devices=[...])``
serves it on D x N devices in row order (the program's devices map to the
devices at their first positions in the grid), and refuses fewer.  On
cards a grid program is served as one CUDA graph over all its devices, as
the live grid runs (``GraphedCall(spans=...)``).

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
from typing import Optional, Sequence, Tuple

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


PLATFORMS = ("cpu", "cuda")


def platforms_of(device: torch.device,
                 platforms: Optional[Sequence[str]]) -> list:
    """The device types a program traced on ``device`` is recorded for:
    ``platforms`` (which must include ``device``'s type), or that type."""
    if not platforms:
        return [device.type]
    out = list(dict.fromkeys(p.strip() for p in platforms))
    bad = [p for p in out if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad}: the port serves on "
                         f"{list(PLATFORMS)}")
    if device.type not in out:
        raise ValueError(f"platforms {out} leave out {device.type}, where "
                         f"the program is traced")
    return out


def _record(weights, device: torch.device, meta: Optional[dict],
            platforms: Optional[Sequence[str]] = None) -> dict:
    record = {"device": device.type, "torch": torch.__version__,
              "kernels": _build._source_tag(), "n_weights": len(weights),
              "platforms": platforms_of(device, platforms),
              "devices": [str(device)]}
    record.update(meta or {})
    return record


def _device_of(example_args) -> torch.device:
    return pytree.tree_leaves(example_args)[0].device


def save_artifact(path: str, module: nn.Module, example_args: Sequence,
                  meta: Optional[dict] = None,
                  platforms: Optional[Sequence[str]] = None):
    """Export ``module`` and write the hermetic artifact to ``path`` (the
    weights and the record inside); returns the ``ExportedProgram``.
    ``platforms``: the device types it serves on (default: the one it is
    traced on)."""
    program = export_callable(module, example_args)
    record = _record(program.state_dict, _device_of(example_args), meta,
                     platforms)
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
                meta: Optional[dict] = None,
                platforms: Optional[Sequence[str]] = None):
    """Export ``module`` as a bundle directory: ``program.pt2`` takes the
    weights as its first input (a dict) and holds none of their bytes,
    ``weights.pt`` is ``module``'s state dict, ``meta.json`` the record
    (with each weight's name, shape and dtype).  Returns the
    ``ExportedProgram``.  Load with :func:`load_bundle`."""
    weights = {k: v.detach() for k, v in module.state_dict().items()}
    program = export_callable(_WeightsAsInputs(module),
                              (weights, *example_args))
    record = _record(weights, _device_of(example_args), meta, platforms)
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
    the one it was exported for.  Raises for a device type the record does
    not list."""
    kind = meta.get("device")
    listed = meta.get("platforms") or [kind]
    want = torch.device(device if device is not None else kind)
    if want.type not in listed:
        raise ValueError(f"the program was exported for "
                         f"{' and '.join(listed)} and serves only there, "
                         f"not on {want.type} (export it with --platforms "
                         f"naming {want.type})")
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the program was exported for cuda: no CUDA "
                               "device here")
        if want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
    return want


def _placement(meta: dict, device, devices) -> Tuple[torch.device, dict]:
    """(first serving device, {traced device: serving device}) of a
    program: a grid program's devices map to ``devices`` (row order, at
    least D x N of them, each checked as ``_serving_device``) at their
    first positions in the grid; any other program's one device to
    ``device``.  The map is empty where nothing moves."""
    grid = meta.get("grid")
    if grid is not None:
        need = grid[0] * grid[1]
        if devices is None:
            devices = ([device] * need if device is not None
                       else [torch.device(d) for d in meta["grid_devices"]])
        devices = [_serving_device(meta, d) for d in devices]
        if len(devices) < need:
            raise ValueError(f"the program runs on a {grid[0]} x {grid[1]} "
                             f"grid: it needs {need} devices, got "
                             f"{len(devices)}")
        flat = meta["grid_devices"]
        where = {}
        for pos, d in enumerate(flat):
            where.setdefault(d, devices[pos])
        moves = {k: str(v) for k, v in where.items() if k != str(v)}
        return devices[0], moves
    if devices is not None:
        raise ValueError("devices= is for a grid program; pass device=")
    dev = _serving_device(meta, device)
    traced = meta.get("devices")
    if traced is None or traced == [str(dev)]:
        return dev, {}
    return dev, {traced[0]: str(dev)}


def _spans(meta: dict, moves: dict) -> list:
    """The serving devices of a grid program (each distinct device of the
    record's, moved by ``moves``); none for any other program."""
    if meta.get("grid") is None:
        return []
    return [torch.device(moves.get(d, d)) for d in meta["devices"]]


def _moved(program, moves: dict):
    """``program`` with its devices moved by ``moves`` (``torch.export``'s
    own pass: the graph's device arguments and its weights)."""
    if not moves:
        return program
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(program, moves)


def _run(module, inputs):
    with torch.no_grad():
        return module(*inputs)


class Served:
    """The serving callable of an artifact or bundle: ``serve(*inputs)``
    -> the program's outputs; ``meta`` is its record.  Inputs are copied
    to the serving device.  Every call copies them into static tensors and
    runs one ``GraphedCall`` (on a CUDA device the first call eagerly, the
    second captures, later calls replay; on the CPU every call runs
    eagerly), and returns copies of its outputs that the next call does
    not overwrite.  A bundle's program
    takes ``weights`` (resident on the device) before the inputs.  A grid
    program's graph spans its other serving devices, ``spans``."""

    def __init__(self, program, meta: dict, device: torch.device,
                 weights: Optional[dict] = None, spans: Sequence = ()):
        self.meta = meta
        self.device = device
        self.spans = list(spans)
        self.module = program.module()
        self.bound = () if weights is None else (weights,)
        self.call: Optional[GraphedCall] = None
        self._static = None

    def __call__(self, *inputs):
        inputs = pytree.tree_map(lambda t: torch.as_tensor(t).to(
            self.device), inputs)
        if self.call is None:
            self._static = pytree.tree_map(torch.empty_like, inputs)
            self.call = GraphedCall(functools.partial(
                _run, self.module, (*self.bound, *self._static)),
                self.device, spans=self.spans)
        for s, t in zip(pytree.tree_leaves(self._static),
                        pytree.tree_leaves(inputs)):
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"input {tuple(t.shape)} {t.dtype}: the "
                                 f"program takes {tuple(s.shape)} {s.dtype}")
            s.copy_(t)
        return pytree.tree_map(torch.clone, self.call())


def load_artifact(path: str, device=None) -> Served:
    """Load a :func:`save_artifact` file; returns its serving callable on
    ``device`` (default: the device type it was exported for), any type
    its record lists."""
    meta = _artifact_meta(path)
    dev, moves = _placement(meta, device, None)
    with _archive():
        program = _moved(torch.export.load(path), moves)
    return Served(program, meta, dev, spans=_spans(meta, moves))


def read_bundle(dir_path: str, device=None, devices=None):
    """-> (program, weights, meta, device, spans) of a :func:`save_bundle`
    directory: ``weights`` (on the serving devices, in the program's
    order) is checked against the record's names, shapes and dtypes.
    ``devices``: a grid program's D x N serving devices in row order;
    ``spans`` its distinct serving devices (none for another program)."""
    meta = load_bundle_meta(dir_path)
    dev, moves = _placement(meta, device, devices)
    with _archive():
        program = _moved(torch.export.load(os.path.join(dir_path, PROGRAM)),
                         moves)
    if meta.get("grid") is None:
        where = dev  # one device (older records name no "devices")
    else:
        where = {d: moves.get(d, d) for d in meta["devices"]}
    weights = torch.load(os.path.join(dir_path, WEIGHTS), map_location=where,
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
    return (program, {k: weights[k] for k in want}, meta, dev,
            _spans(meta, moves))


def load_bundle(dir_path: str, device=None, devices=None) -> Served:
    """Load a :func:`save_bundle` directory; returns its serving callable
    with the weights of ``weights.pt`` bound (no model code needed).  A
    grid program serves on ``devices`` (D x N of them, row order), by
    default those it was exported on."""
    program, weights, meta, dev, spans = read_bundle(dir_path, device,
                                                     devices)
    return Served(program, meta, dev, weights, spans)


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
    """(program, example inputs, record) of a ``FusedPipeline`` batch: with
    a mesh, its ``GridProgram``."""
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
    if pipeline.mesh is None:
        return pipeline.program(), (z, noise), meta
    grid = pipeline.grid_program()
    meta.update(grid=list(grid.shape),
                grid_devices=[str(grid.devices[j]) for r in grid.rows
                              for j in r],
                devices=[str(d) for d in grid.devices])
    return grid, (z, noise), meta


def export_fused_pipeline(pipeline, batch_size: Optional[int] = None,
                          path: Optional[str] = None,
                          platforms: Optional[Sequence[str]] = None):
    """Freeze a trained ``FusedPipeline`` (generator weights and the
    decoder's folded kernels inside).  Signature of the program:
    ``(z (B, latent) f32, noise {name: (B, H, W, 1) f32}) -> (images (B,
    H, W, 3) u8, masks u8)``, masks in the pipeline's wire format
    (bit-packed 8 px/byte along W when binary).  With ``path`` the
    artifact is written there, for ``platforms``.  Returns the
    ``ExportedProgram``."""
    program, args, meta = _fused_inputs(pipeline, batch_size)
    if path is None:
        return export_callable(program, args)
    return save_artifact(path, program, args, meta, platforms)


def export_fused_pipeline_bundle(pipeline, batch_size: Optional[int] = None,
                                 dir_path: str = "generate.bundle",
                                 platforms: Optional[Sequence[str]] = None):
    """Bundle form of :func:`export_fused_pipeline` (program + weights
    directory), the form for the full-size generator's ~10^8 bytes of
    weights, and for a pipeline with a mesh the whole grid's program."""
    program, args, meta = _fused_inputs(pipeline, batch_size)
    return save_bundle(dir_path, program, args, meta, platforms)


class _EvalProgram(nn.Module):
    """``MultiEvalModel.scores`` as a module over the evaluator's model."""

    def __init__(self, eval_model):
        super().__init__()
        self.model = eval_model.model
        self.evaluator = eval_model

    def forward(self, images):
        return self.evaluator.scores(images)


def export_eval_model(eval_model, batch: int, height: int, width: int,
                      channels: int, path: Optional[str] = None,
                      platforms: Optional[Sequence[str]] = None):
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
    return save_artifact(path, module, (images,), meta, platforms)
