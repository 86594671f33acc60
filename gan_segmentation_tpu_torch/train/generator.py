"""ImageGenerator and the fused z -> (image, mask) pipeline (PyTorch
counterpart of ``gan_segmentation_tpu/train/generator.py``), on one device.

The z and noise of batch i are drawn from a ``torch.Generator`` seeded with
a pure function of ``(seed, i)``, so ``skip_batches(k)`` only moves a
counter and ``generate --resume`` reproduces an interrupted run byte for
byte (on the same device type; PyTorch's and JAX's random streams differ).

A batch is one program, as the JAX package's ``jax.jit`` makes it: on a
card ``ImageGenerator`` and ``FusedPipeline`` replay a CUDA graph per batch
size (``core/graphs.py``), captured after one eager batch.  z and every
noise input are drawn before the replay, in the order and shapes in which
the eager forward draws them (``StyleGanGenerator.draw_noise``), into the
graph's static inputs; so batch i is bit-identical to the eager path's
batch i.  On the CPU the same code runs eagerly.

``FusedPipeline(mesh=[dev0, dev1, ...])`` (``generate --dp D``, the JAX
package's data mesh) splits each batch over the devices: each holds a
replica of the batch's program and its own graph per part, and z and the
noise are drawn once on the first device in the eager order and scattered:
each part is what one device computes on it.  On a card that equals one
device's batch only up to rounding, as kernels 1 and 2 split their sums
by the part's size (as the JAX package's --dp promises: "up to bf16
rounding"); on the CPU it is the same.

``FusedPipeline(mesh=[[dev, ...], ...])`` (``generate --spatial N [--dp
D]``, the JAX package's ``(data, space)`` mesh) takes a grid of D rows of
N devices: each batch is split over the rows as with ``--dp``, and each
row splits every image's height into N bands, one a device
(``core/spatial.py``: the band rule, the halo exchange, the cross-band
instance-norm statistics; kernels 1 and 2 in their row-band form).  On a
card the whole grid's batch is one CUDA graph per batch size, the
counterpart of the JAX package's one jitted ``(data, space)`` program: the
capture on the first card takes every card's kernels and halo copies
(``GraphedCall(spans=...)``), after one eager batch, and replays from the
second; the same code runs a grid that repeats one card.  Its images and
masks equal one device's up to the rounding of the statistics' sums and of
the kernels' split-K over a band's shape, and the eager grid's bit for
bit.

``FusedPipeline(quant="int8" | "int8-full")`` (``generate --quant``) runs
the decoder (and with ``int8-full`` the generator's synthesis convs) in
s8, calibrated on a fixed stream of its own (``ops/quant.py``); not with a
spatial grid.
"""

import copy
import functools
import logging
from os.path import isfile, join
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import dtypes
from ..core import spatial
from ..core.config import GanConfig, gan_config
from ..core.graphs import GraphedCall
from ..core.mx_params import load_generator_params
from ..models.stylegan import StyleGanGenerator, init_generator
from ..ops import quant as q8

log = logging.getLogger(__name__)

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # MSB first == np.unpackbits


def _to_uint8(rgb, imrange=(-1.0, 1.0)):
    """(-1, 1) float NHWC -> uint8 on device; the cast truncates, as the JAX
    package's ``astype(uint8)`` (`image_generator.py:76-84`)."""
    lo, hi = imrange
    x = (rgb.float() - lo) / (hi - lo)
    x = torch.clamp(x, 0.0, 1.0) * 255.0
    return x.to(torch.uint8)


def class_mask(logits):
    """Class index per pixel as uint8: a strict ``>`` for two classes (ties
    go to class 0), the first maximum otherwise."""
    if logits.shape[-1] == 2:
        return (logits[..., 1] > logits[..., 0]).to(torch.uint8)
    return torch.argmax(logits, dim=-1).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _bit_weights(device: torch.device):
    """Built once per device: per call it is a copy from host memory, which
    a CUDA graph cannot capture."""
    with torch.inference_mode(False):
        return torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=device)


def pack_mask_bits(mask):
    """(N, H, W) {0,1} uint8 -> (N, H, W/8), 8 pixels per byte, MSB first."""
    n, h, w = mask.shape
    bits = mask.reshape(n, h, w // 8, 8).to(torch.int32)
    return (bits * _bit_weights(mask.device)).sum(dim=-1).to(torch.uint8)


def _generate(model, imrange, z, generator=None, noise=None):
    """(uint8 images, features) of one batch, eagerly."""
    with torch.inference_mode():
        rgb, feats = model(z, noise=noise, generator=generator)
        return _to_uint8(rgb, imrange), feats


class FusedProgram(nn.Module):
    """One batch z -> (uint8 images, uint8 masks) as a module: the
    generator, the decoder (eval, BN folded, ``dtype``), the class mask
    and, with ``pack``, the bit-packing of binary masks.  ``folded`` is the
    decoder's ``fold_bn`` dict; its tensors become this module's buffers
    (``fold.<conv>.w`` / ``.b``, "." in a conv's name as "__"; the same
    tensors, so a refold in place reaches them), so an export
    (``core/export.py``) carries them with the generator's and decoder's
    parameters.  ``forward(z, noise)`` takes the
    noise as inputs (``StyleGanGenerator.draw_noise``); without ``noise``
    it draws it from ``generator``.  ``FusedPipeline`` runs every batch
    through it, eagerly or as a CUDA graph, and the export traces it: the
    live and the exported programs are one body."""

    def __init__(self, model: StyleGanGenerator, decoder, folded,
                 dtype: torch.dtype, pack: bool, imrange, gen_quant=None,
                 dec_quant=None):
        super().__init__()
        self.model = model
        self.decoder = decoder
        self.dtype = dtype
        self.pack = pack
        self.imrange = imrange
        # int8 states (ops/quant.py::QuantState): the generator's under
        # int8-full, the decoder's under both int8 modes
        self.gen_quant = gen_quant
        self.dec_quant = dec_quant
        self.fold = nn.Module()
        self.fold_names = tuple(folded)
        for name, (w, b) in folded.items():
            conv = nn.Module()
            conv.register_buffer("w", w)
            conv.register_buffer("b", b)
            self.fold.add_module(name.replace(".", "__"), conv)

    def folded(self):
        """The folded (kernel, bias) pairs, read from the buffers at call
        time (a trace reads them as the program's weights)."""
        return {name: (conv.w, conv.b) for name, conv in
                zip(self.fold_names, self.fold.children())}

    def forward(self, z, noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        rgb, feats = self.model(z, noise=noise, generator=generator,
                                quant=self.gen_quant)
        if self.dec_quant is not None:
            logits = self.decoder.forward_int8(feats, self.dec_quant,
                                               self.dtype)
        else:
            logits = self.decoder(feats, self.folded(), self.dtype)
        mask = class_mask(logits)
        return (_to_uint8(rgb, self.imrange),
                pack_mask_bits(mask) if self.pack else mask)


class GridProgram(nn.Module):
    """One batch z -> (uint8 images, uint8 masks) over a grid of devices:
    ``rows`` lists each row's devices as indices into ``devices`` (distinct
    devices; ``programs[j]``, a ``FusedProgram``, lives on ``devices[j]``).
    The batch is split over the rows in contiguous parts (the sizes of
    ``torch.tensor_split``); a row of one device runs its ``FusedProgram``
    on its part, a row of N runs the banded body of ``core/spatial.py``
    under ``plan`` (a ``spatial.BandPlan``).  ``forward(z, noise)`` takes
    the batch's z and noise on the first device and returns the outputs
    there, in ``FusedProgram``'s wire format.  The live pipeline runs it
    for a spatial grid and the export traces it for any grid: one body."""

    def __init__(self, programs, devices, rows, plan=None):
        super().__init__()
        self.programs = nn.ModuleList(programs)
        self.devices = [torch.device(d) for d in devices]
        self.rows = [list(r) for r in rows]
        self.plan = plan

    @property
    def shape(self) -> Tuple[int, int]:
        """(D, N): rows, and devices a row."""
        return len(self.rows), len(self.rows[0])

    def forward(self, z, noise: Dict[str, torch.Tensor]):
        dev0 = z.device
        imgs, masks = [], []
        for row, (a, b) in zip(self.rows, spatial.band_rows(len(z),
                                                            len(self.rows))):
            if a == b:
                continue
            i, m = self.run_row(row, z[a:b],
                                {k: v[a:b] for k, v in noise.items()})
            imgs.append(i.to(dev0))
            masks.append(m.to(dev0))
        return torch.cat(imgs), torch.cat(masks)

    def floats(self, row, z, noise):
        """(rgb, logits) of a row of N > 1 devices on its part z / noise, as
        ``core/spatial.py`` bands (the f32 logits before the class mask)."""
        progs = [self.programs[j] for j in row]
        devs = [self.devices[j] for j in row]
        z = z.to(devs[0])
        noise = {k: v.to(devs[0]) for k, v in noise.items()}
        rgb, feats = spatial.synthesize([p.model for p in progs], devs, z,
                                        noise, self.plan)
        logits = spatial.decode([p.decoder for p in progs],
                                [p.folded() for p in progs], devs, feats,
                                progs[0].dtype, self.plan)
        return rgb, logits

    def run_row(self, row, z, noise):
        """(uint8 images, masks) of one row's part, on the row's first
        device."""
        p0, dev = self.programs[row[0]], self.devices[row[0]]
        if len(row) == 1:
            return p0(z.to(dev), noise={k: v.to(dev)
                                        for k, v in noise.items()})
        rgb, logits = self.floats(row, z, noise)
        masks = [class_mask(t) for t in logits.parts]
        if p0.pack:
            masks = [pack_mask_bits(m) for m in masks]
        return (spatial.gather(spatial.Bands(
                    [_to_uint8(t, p0.imrange) for t in rgb.parts],
                    rgb.bounds), dev),
                spatial.gather(spatial.Bands(masks, logits.bounds), dev))


def _infer(program, *args, **kwargs):
    """``program(*args, **kwargs)`` in inference mode (a batch's body)."""
    with torch.inference_mode():
        return program(*args, **kwargs)


def _mesh_rows(mesh):
    """-> (a ``--dp`` list of devices, 1) or (rows of N devices, N > 1)
    from a ``FusedPipeline`` mesh: a list of devices, or a list of equal
    rows (rows of one device are a ``--dp`` list)."""
    def devices(seq):
        if (not isinstance(seq, (list, tuple)) or not seq
                or not all(isinstance(d, (torch.device, str)) for d in seq)):
            raise TypeError(f"mesh: a list of devices or of rows of "
                            f"devices, got {mesh!r}")
        return [torch.device(d) for d in seq]

    if isinstance(mesh, (list, tuple)) and mesh and all(
            isinstance(r, (list, tuple)) for r in mesh):
        rows = [devices(r) for r in mesh]
        n = len(rows[0])
        if any(len(r) != n for r in rows):
            raise ValueError(f"mesh: rows of unequal length {mesh!r}")
        return ([r[0] for r in rows], 1) if n == 1 else (rows, n)
    return devices(mesh), 1


class ImageGenerator:
    """Seeded StyleGAN sampler on one device.  ``params`` is a generator
    ``state_dict``; without it the weights come from
    ``gan_dir/stylegan-<gan>.params`` (mxnet's format or the JAX package's
    msgpack tree), and where that file is missing the generator is randomly
    initialised from ``seed``, as the JAX package does."""

    def __init__(self, gan: str = "ffhq", gan_dir: str = "stylegan-models",
                 batch_size: int = 4, dtype: str = "bf16",
                 return_latents: bool = False, seed: int = 0,
                 params=None, max_res_log2: Optional[int] = None,
                 device: Optional[torch.device] = None):
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        if max_res_log2 is not None:
            self.cfg = GanConfig(max_res_log2=max_res_log2, dtype=dtype)
        else:
            self.cfg = gan_config(gan, dtype)
        self.gan = gan
        self.batch_size = batch_size
        self.return_latents = return_latents
        self.seed = seed
        self.device = device if device is not None else dtypes.cuda_device()
        cd = dtypes.default_policy(dtype).compute_dtype
        path = join(gan_dir, f"stylegan-{gan}.params")
        if params is None and isfile(path):
            log.info("loading generator weights: %s", path)
            params = load_generator_params(path, self.cfg)
        if params is not None:
            model = StyleGanGenerator(self.cfg, cd)
            model.load_state_dict(params)
        else:
            log.warning("generator checkpoint %s not found; using random "
                        "init (seed %d)", path, seed)
            model = init_generator(self.cfg, seed=seed, compute_dtype=cd)
        self.model = model.to(self.device).eval()
        self._batch_index = 0
        self._inputs = {}  # batch size -> static (z, noise)
        self._graphs = {}  # batch size -> GraphedCall of _forward

    def skip_batches(self, k: int):
        """Advance the z/noise stream past k batches without generating
        them (`generate --resume`)."""
        self._batch_index += k

    def _next_generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 2 ** 32 + self._batch_index)
        self._batch_index += 1
        return gen

    def next_inputs(self, batch_size: int):
        """(z, generator) of the next batch; the generator then draws the
        batch's noise."""
        gen = self._next_generator()
        z = torch.randn((batch_size, self.cfg.latent_size), generator=gen,
                        device=self.device, dtype=torch.float32)
        return z, gen

    def draw_inputs(self, batch_size: int):
        """(z, noise) of the next batch, drawn as ``next_inputs`` and the
        eager forward draw them, into this batch size's static buffers (the
        graphs' inputs; the next call overwrites them)."""
        if batch_size not in self._inputs:
            with torch.inference_mode(False):
                self._inputs[batch_size] = (
                    torch.empty((batch_size, self.cfg.latent_size),
                                device=self.device),
                    {k: torch.empty(s, device=self.device) for k, s in
                     self.model.noise_shapes(batch_size).items()})
        z, noise = self._inputs[batch_size]
        gen = self._next_generator()
        z.normal_(generator=gen)  # what torch.randn draws
        self.model.draw_noise(batch_size, gen, out=noise)
        return z, noise

    def _sample(self, batch_size: int):
        """(uint8 images, features, z) of the next batch; on a card the
        static tensors of this batch size's graph, which the next batch
        overwrites."""
        z, noise = self.draw_inputs(batch_size)
        call = self._graphs.get(batch_size)
        if call is None:  # reads the model, not self: no reference cycle
            call = self._graphs[batch_size] = GraphedCall(functools.partial(
                _generate, self.model, self.cfg.imrange, z, noise=noise),
                self.device)
        imgs, feats = call()
        return imgs, feats, z

    def sample_batch(self, batch_size: Optional[int] = None):
        """One device batch: (uint8 images NHWC, features list, z), copied
        out of the graph's static outputs."""
        imgs, feats, z = self._sample(batch_size or self.batch_size)
        with torch.inference_mode():
            return imgs.clone(), [f.clone() for f in feats], z.clone()

    def get_images(self, n: int
                   ) -> Iterator[Tuple[np.ndarray, List[np.ndarray]]]:
        """Reference-compatible sample iterator (`image_generator.py:86-123`):
        per sample ``(uint8 image HWC, [f32 features (H, W, C)])`` as numpy,
        and with ``return_latents`` also the z of the sample's whole trimmed
        batch.  Every batch is sampled at ``batch_size`` and trimmed; the
        features become f32 on the device (numpy has no bf16) and cross to
        the host once per batch."""
        produced = 0
        while produced < n:
            b = min(self.batch_size, n - produced)
            imgs, feats, z = self._sample(self.batch_size)  # copied to host
            imgs_np = imgs[:b].cpu().numpy()
            feats_np = [f[:b].float().cpu().numpy() for f in feats]
            z_np = np.array(z[:b].cpu())  # z is the next batch's buffer
            for i in range(b):
                sample_feats = [f[i] for f in feats_np]
                if self.return_latents:
                    yield imgs_np[i], sample_feats, z_np
                else:
                    yield imgs_np[i], sample_feats
            produced += b


class FusedPipeline:
    """z -> (image uint8, mask uint8) on one device: generator, decoder
    (eval, BN folded, ``inference_dtype``), class mask, and bit-packing of
    binary masks when the width divides by 8.  Only uint8 leaves the card.

    On a card a batch replays one CUDA graph per batch size (the JAX
    package's ``_fused``).  The graph reads the decoder's folded kernels
    where ``_prepared`` keeps them; when the solver's weights change,
    ``_prepared`` folds again into those same tensors before the next
    replay, so the graph never serves a stale decoder.

    ``mesh``: a list of devices, the first the generator's, over which
    each batch is split in contiguous parts (``torch.tensor_split``), one
    replica of the program and one graph per part and device; the replicas
    take the program's weights again whenever it refolds.  Or a grid, a
    list of rows of N devices each (``core/mesh.py::generate_devices``):
    with N > 1 each batch runs ``grid_program()``, every row's part split
    into N row bands, on a card as one graph per batch size over all the
    grid's cards; with N = 1 it is the list of the rows' devices.
    ``grid_program()`` is the whole grid's body as one module (the bundle's
    program), with one copy of the weights a distinct device, refreshed in
    place whenever the program refolds.

    ``quant="int8"``: the decoder runs in s8 (``ops/quant.py``); its input
    scales come from two fixed calibration batches of the generator
    (``calibration_batches``: disjoint from the emission stream, so
    ``generate --resume`` keeps its byte identity), computed once per
    pipeline; the decoder is requantized whenever the solver's weights
    change, into the tensors the graph reads.  ``quant="int8-full"``: the
    generator's synthesis convs too, calibrated on its float path; the
    decoder then calibrates on the quantized generator's pyramids.  The
    JAX package's space-to-depth decoder tail is a TPU layout and is
    refused.
    """

    def __init__(self, image_generator: ImageGenerator, solver,
                 inference_dtype: Optional[torch.dtype] = torch.bfloat16,
                 s2d: bool = False, mesh=None, quant: Optional[str] = None):
        self.spatial = 1
        if mesh is not None:
            mesh, self.spatial = _mesh_rows(mesh)
            first = mesh[0] if self.spatial == 1 else mesh[0][0]
            if first != image_generator.device:
                raise ValueError(f"the grid's first device ({first}) must "
                                 f"be the generator's device "
                                 f"({image_generator.device})")
        self.mesh = mesh
        if quant is not None and self.spatial > 1:
            raise ValueError("quant with a spatial grid: the int8 convs have "
                             "no row-band form (the JAX package's int8 path "
                             "rides the s2d decoder tail, which spatial "
                             "parallelism replaces); drop --quant or "
                             "--spatial")
        if s2d:
            raise NotImplementedError("the space-to-depth decoder tail is a "
                                      "TPU layout; the port does not use it")
        if quant not in (None, "int8", "int8-full"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.quant = quant
        self.gen = image_generator
        self.solver = solver
        self.dec_dtype = inference_dtype or solver.model.compute_dtype
        nclass = solver.model.features_cfg[-1]
        res = 2 ** image_generator.cfg.max_res_log2
        self._pack_masks = nclass == 2 and res % 8 == 0
        self._folded = None
        self._folded_at = None
        self._gen_quant = self._calib = None
        if quant is not None:
            self._calibrate_generator()
        self._program = None
        self._graphs = {}  # batch size -> GraphedCall of the program
        self._replicas = []  # mesh[1:]'s copies of the program
        self._replicas_at = None
        self._parts = {}  # (batch size, part) -> (GraphedCall, z, noise)
        self._grid = None  # grid_program()'s module
        self._grid_at = None
        self._plan = (spatial.BandPlan.of(image_generator.cfg, self.spatial)
                      if self.spatial > 1 else None)

    def _calibrate_generator(self):
        """int8: the calibration pyramids, once per pipeline (they depend
        on the generator alone), from the fixed stream; under int8-full the
        generator's int8 state first, and the pyramids from it."""
        model = self.gen.model
        with torch.inference_mode(False), torch.no_grad():
            zs, gens = q8.calibration_batches(self.gen.cfg.latent_size,
                                              self.gen.device)
            noises = [model.draw_noise(len(z), g) for z, g in zip(zs, gens)]
            if self.quant == "int8-full":
                self._gen_quant = q8.quantize_generator(model, zs, noises)
            self._calib = [model(z, noise=n, quant=self._gen_quant)[1]
                           for z, n in zip(zs, noises)]

    def _prepared(self):
        """The decoder's BN-folded kernels (int8: its ``QuantState``),
        folded again whenever the solver's weights changed, into the same
        tensors (a captured graph reads them).  PyTorch updates parameters
        in place, so their identity does not tell; the solver counts its
        changes (``SegSolver.weights_version``: ``fit``, ``load``,
        ``reinit``)."""
        at = self.solver.weights_version
        if self._folded is not None and at == self._folded_at:
            return self._folded
        # plain tensors (not inference tensors), so that any mode may
        # refold them in place
        with torch.inference_mode(False), torch.no_grad():
            if self.quant is not None:
                folded = q8.prepare_decoder_int8(self.solver.model,
                                                 self._calib, self.dec_dtype)
            else:
                folded = self.solver.model.fold_bn(self.dec_dtype)
            if self._folded is None:
                self._folded = folded
            elif self.quant is not None:
                self._folded.copy_(folded)
            else:
                for k, (w, b) in folded.items():
                    self._folded[k][0].copy_(w)
                    self._folded[k][1].copy_(b)
        self._folded_at = at
        return self._folded

    def program(self) -> FusedProgram:
        """The batch's body (``FusedProgram``), one per pipeline, over the
        folded kernels of ``_prepared`` (refolded first if the solver's
        weights moved)."""
        folded = self._prepared()
        if self._program is None:
            int8 = self.quant is not None
            self._program = FusedProgram(
                self.gen.model, self.solver.model, {} if int8 else folded,
                self.dec_dtype, self._pack_masks, self.gen.cfg.imrange,
                gen_quant=self._gen_quant,
                dec_quant=folded if int8 else None)
        return self._program

    def grid_program(self) -> GridProgram:
        """The whole grid's body (``GridProgram``) of a pipeline with a
        mesh: the program on the generator's device and a copy on every
        other distinct device of the grid, which takes the program's
        weights again whenever it refolds."""
        program = self.program()
        rows = [[d] for d in self.mesh] if self.spatial == 1 else self.mesh
        if self._grid is None:
            devices = list(dict.fromkeys(d for r in rows for d in r))
            with torch.inference_mode(False):
                copies = [copy.deepcopy(program).to(d) for d in devices[1:]]
            self._grid = GridProgram(
                [program, *copies], devices,
                [[devices.index(d) for d in r] for r in rows], self._plan)
            self._grid_at = self._folded_at
        elif self._grid_at != self._folded_at:
            state = program.state_dict()
            for r in self._grid.programs[1:]:
                r.load_state_dict(state)
            self._grid_at = self._folded_at
        return self._grid

    def _fused(self, z, generator: Optional[torch.Generator] = None,
               noise=None):
        """One batch, eagerly: the noise from ``noise`` or drawn from
        ``generator``."""
        return _infer(self.program(), z, noise=noise, generator=generator)

    def _batch(self, batch_size: int):
        """[(uint8 images, uint8 masks)] of the next batch, one pair per
        part (one without a mesh); on a card the static outputs of the
        part's graph, which the next batch overwrites."""
        z, noise = self.gen.draw_inputs(batch_size)
        program = self.program()  # refolds first, if the weights moved
        if self.spatial == 1 and self.mesh is not None:
            return self._mesh_batch(program, z, noise)
        if self.spatial > 1:  # the whole grid's batch; its copies refold
            program = self.grid_program()
        call = self._graphs.get(batch_size)
        if call is None:  # reads the program, not self: no reference cycle
            call = self._graphs[batch_size] = GraphedCall(
                functools.partial(_infer, program, z, noise),
                self.gen.device,
                spans=program.devices if self.spatial > 1 else ())
        return [call()]

    def _mesh_batch(self, program, z, noise):
        """The parts of one batch, each on its device's replica: z and the
        noise split along the batch and copied to the part's static
        inputs."""
        if not self._replicas:
            self._replicas = [copy.deepcopy(program).to(d)
                              for d in self.mesh[1:]]
            self._replicas_at = self._folded_at
        elif self._replicas_at != self._folded_at:
            state = program.state_dict()
            for r in self._replicas:
                r.load_state_dict(state)
            self._replicas_at = self._folded_at
        b = len(z)
        bounds = [len(t) for t in torch.tensor_split(torch.arange(b),
                                                     len(self.mesh))]
        outs, start = [], 0
        for k, (dev, n) in enumerate(zip(self.mesh, bounds)):
            if n == 0:
                continue
            sl = slice(start, start + n)
            start += n
            part = self._parts.get((b, k))
            if part is None:
                with torch.inference_mode(False):
                    zs = torch.empty((n, *z.shape[1:]), device=dev)
                    ns = {key: torch.empty((n, *v.shape[1:]), device=dev)
                          for key, v in noise.items()}
                body = program if k == 0 else self._replicas[k - 1]
                part = self._parts[(b, k)] = (GraphedCall(functools.partial(
                    _infer, body, zs, noise=ns), dev), zs, ns)
            call, zs, ns = part
            zs.copy_(z[sl], non_blocking=True)
            for key, v in noise.items():
                ns[key].copy_(v[sl], non_blocking=True)
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(call())
            else:
                outs.append(call())
        return outs

    def sample_batch(self, batch_size: Optional[int] = None):
        """Device batch: (uint8 images NHWC, uint8 masks), masks bit-packed
        along W when ``self._pack_masks``; copied out of the graphs' static
        outputs (to the first device)."""
        parts = self._batch(batch_size or self.gen.batch_size)
        dev = self.gen.device
        with torch.inference_mode():
            return tuple(torch.cat([p[i].to(dev) for p in parts])
                         for i in (0, 1))

    def _enqueue(self, batch_size: int):
        """Enqueue one batch and its copy to host.  On a card the copy goes
        into pinned buffers with ``non_blocking`` and an event per part
        marks its end, so waiting for batch i does not wait for batch i+1
        enqueued after it on the same stream.  The copy reads the graph's
        static outputs before the next replay, which is enqueued after
        it."""
        parts = self._batch(batch_size)
        if parts[0][0].device.type != "cuda":
            return (*(torch.cat([p[i] for p in parts]) for i in (0, 1)),
                    [])
        host = [torch.empty((batch_size, *t.shape[1:]), dtype=t.dtype,
                            pin_memory=True) for t in parts[0]]
        done, start = [], 0
        for imgs, masks in parts:
            n = len(imgs)
            for h, t in zip(host, (imgs, masks)):
                h[start:start + n].copy_(t, non_blocking=True)
            with torch.cuda.device(imgs.device):
                done.append(torch.cuda.Event())
                done[-1].record()
            start += n
        return host[0], host[1], done

    def generate_batches(self, n: int
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray, bool]]:
        """Yield host batches ``(uint8 imgs (B,H,W,3), uint8 masks, packed)``
        covering n samples (the last batch trimmed).  The device computes
        batch i+1 while the caller consumes batch i."""
        if n <= 0:
            return
        b = self.gen.batch_size
        pending = self._enqueue(b)
        produced = 0
        while produced < n:
            imgs, masks, done = pending
            take = min(b, n - produced)
            if produced + take < n:
                pending = self._enqueue(b)
            for event in done:
                event.synchronize()
            yield (imgs.numpy()[:take], masks.numpy()[:take],
                   self._pack_masks)
            produced += take

    def generate_pairs(self, n: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield n (uint8 image HWC, uint8 mask HW) pairs (unpacked masks)."""
        for imgs, masks, packed in self.generate_batches(n):
            if packed:
                masks = np.unpackbits(masks, axis=-1)
            for i in range(imgs.shape[0]):
                yield imgs[i], masks[i]
