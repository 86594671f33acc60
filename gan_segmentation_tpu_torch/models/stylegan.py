"""StyleGAN (v1) generator emitting the per-resolution feature pyramid
(PyTorch counterpart of ``gan_segmentation_tpu/models/stylegan.py``).

z -> 8-layer mapping MLP (PixelNorm front, lr_mult 0.01) -> per-layer
truncation ``lerp(latent_avg, w, psi_i)`` -> one synthesis block per
resolution 4^2 .. 2^max_res_log2 -> ``to_rgb`` 1x1 conv.  Each block:

    [nearest-2x conv3x3 | deconv k4s2p1 (res >= 128)] -> blur -> noise ->
    bias -> lrelu -> AdaIN -> conv3x3 -> noise -> bias -> lrelu -> AdaIN

The second half (conv_2 .. lrelu plus the AdaIN statistics) is ONE launch
of kernel 1 (`kernels/conv_in_stats.py`); AdaIN then applies those
statistics.  The first half's noise .. lrelu and its statistics are one
pass after the blur (`kernels/adain_fused.py`, pass A), and each AdaIN
apply is one pass (pass B).  Layout is NHWC.

Int8 (``generate --quant int8-full``, ``ops/quant.py``): ``forward(...,
quant=state)`` runs every synthesis conv in s8 (conv_2 through kernel 1's
s8 body, conv_1 / deconv_1 in sub-pixel form through kernel 2's, to_rgb
as an integer product); ``absmax={}`` records each of their inputs'
absmax (calibration).  The mapping network and the styles stay float.
"""

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.config import GanConfig
from ..kernels.adain_fused import noise_bias_lrelu_stats
from ..kernels.conv_in_stats import conv3x3_noise_bias_lrelu_instats
from ..ops.norm import pixel_norm
from ..ops.quant import qconv3x3_in_stats, record_absmax
from .layers import (AdaIN, AddNoise, Bias, Blur, Conv2DTransposeW, Conv2DW,
                     DenseW, leaky_relu)


class MappingNetwork(nn.Module):
    """z -> w: PixelNorm + 8 x (DenseW lrelu 0.2), gain sqrt(2), lr_mult .01."""

    def __init__(self, cfg: GanConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        for i in range(8):
            self.add_module(f"dense_{i}", DenseW(
                cfg.latent_size, cfg.latent_size, use_wscale=cfg.use_wscale,
                lr_mult=cfg.mapping_lr_mult, compute_dtype=compute_dtype))

    def forward(self, z):
        x = pixel_norm(z.to(self.compute_dtype))
        for i in range(8):
            x = leaky_relu(getattr(self, f"dense_{i}")(x))
        return x


class StyleBlock(nn.Module):
    """One synthesis block at ``res_log2`` (`networks_stylegan.py:6-73`)."""

    def __init__(self, cfg: GanConfig, res_log2: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg.num_features(res_log2)
        ws, cd = cfg.use_wscale, compute_dtype
        self.first = res_log2 == 2
        if not self.first:
            c_in = cfg.num_features(res_log2 - 1)
            if res_log2 >= 7:  # fused upscale, `networks_stylegan.py:154`
                self.deconv_1 = Conv2DTransposeW(c_in, c, use_wscale=ws,
                                                 compute_dtype=cd)
            else:
                self.conv_1 = Conv2DW(c_in, c, 3, use_bias=False,
                                      use_wscale=ws, up2x=True,
                                      compute_dtype=cd)
            self.blur_1 = Blur()
        self.noise_1 = AddNoise(c)
        self.bias_1 = Bias(c)
        self.adain_1 = AdaIN(c, cfg.latent_size, ws, cd)
        self.conv_2 = Conv2DW(c, c, 3, use_bias=False, use_wscale=ws,
                              compute_dtype=cd)
        self.noise_2 = AddNoise(c)
        self.bias_2 = Bias(c)
        self.adain_2 = AdaIN(c, cfg.latent_size, ws, cd)

    @property
    def up_name(self) -> str:
        """The up-sampling conv's name: ``deconv_1`` from 128^2, else
        ``conv_1``."""
        return "deconv_1" if hasattr(self, "deconv_1") else "conv_1"

    def forward(self, x, w1, w2, noise=(None, None),
                generator: Optional[torch.Generator] = None, quant=None,
                absmax=None, name: str = ""):
        """``noise``: explicit (N, H, W, 1) f32 noise for noise_1 and noise_2,
        or None to draw it from ``generator``.  ``quant`` (the generator's
        int8 state) and ``absmax`` (calibration) by site, this block's
        sites named ``{name}.conv_2`` etc.; a site the state lacks runs
        float, as a JAX module without its ``quant`` entry."""
        cd = self.conv_2.compute_dtype
        y = x
        if not self.first:
            site = f"{name}.{self.up_name}"
            record_absmax(absmax, site, y.to(cd))
            y = self.blur_1(getattr(self, self.up_name)(
                y, None if quant is None else quant.get(site)))
        n1 = noise[0] if noise[0] is not None else AddNoise.draw(y, generator)
        y, s1, s2 = noise_bias_lrelu_stats(
            y.contiguous(), n1[..., 0].contiguous(),
            self.noise_1.scale_factors, self.bias_1.bias, leaky=0.2)
        y = self.adain_1.apply_stats(y, s1, s2, w1,
                                     count=y.shape[1] * y.shape[2])

        n2 = noise[1] if noise[1] is not None else AddNoise.draw(y, generator)
        args = (n2[..., 0].contiguous(), self.noise_2.scale_factors,
                self.bias_2.bias)
        record_absmax(absmax, f"{name}.conv_2", y)
        q2 = None if quant is None else quant.get(f"{name}.conv_2")
        if q2 is not None:
            y, mean, var = qconv3x3_in_stats(y, q2, *args, out_dtype=cd)
        else:
            y, mean, var = conv3x3_noise_bias_lrelu_instats(
                y.contiguous(), self.conv_2.effective_weight().contiguous(),
                *args, leaky=0.2)
        return self.adain_2.apply_stats(y, mean, var, w2)


class StyleGanGenerator(nn.Module):
    """``forward(z) -> (rgb, [features per resolution])``, NHWC."""

    def __init__(self, cfg: GanConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.fold_blur:
            raise NotImplementedError("fold_blur is not ported (it is off by "
                                      "default in the JAX package too)")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        c0 = cfg.num_features(2)
        self.constant_tensor = nn.Parameter(
            torch.empty(1, cfg.base_scale_y, cfg.base_scale_x, c0))
        self.latent_avg = nn.Parameter(torch.zeros(cfg.latent_size))
        self.truncation_psi = nn.Parameter(torch.ones(cfg.num_style_layers))
        self.mapping = MappingNetwork(cfg, compute_dtype)
        for res in range(2, cfg.max_res_log2 + 1):
            self.add_module(f"block_{res}", StyleBlock(cfg, res, compute_dtype))
        self.add_module(f"to_rgb_{cfg.max_res_log2}", Conv2DW(
            cfg.num_features(cfg.max_res_log2), cfg.channels, 1, padding=0,
            use_bias=True, gain=1.0, use_wscale=cfg.use_wscale,
            compute_dtype=compute_dtype))

    def reset_parameters(self, gen: torch.Generator):
        """The JAX init: constant N(0, 1), latent_avg 0, psi 1, and each
        layer's own init, in module order."""
        with torch.no_grad():
            self.constant_tensor.normal_(0.0, 1.0, generator=gen)
            self.latent_avg.zero_()
            self.truncation_psi.fill_(1.0)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def noise_shapes(self, batch: int) -> Dict[str, Tuple[int, ...]]:
        """``"block_{res}.noise_{1|2}"`` -> (N, H, W, 1), in the order in
        which ``forward`` draws them."""
        cfg = self.cfg
        out = {}
        for res in range(2, cfg.max_res_log2 + 1):
            s = 2 ** (res - 2)
            shape = (batch, cfg.base_scale_y * s, cfg.base_scale_x * s, 1)
            out[f"block_{res}.noise_1"] = out[f"block_{res}.noise_2"] = shape
        return out

    def draw_noise(self, batch: int, generator: torch.Generator,
                   out: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """Every noise input of a batch, drawn from ``generator`` up front in
        the order and shapes in which ``forward`` would draw them, so that
        ``forward(z, noise=draw_noise(n, g))`` equals ``forward(z,
        generator=g)`` bit for bit.  Drawn into ``out``'s tensors when given
        (a CUDA graph's static inputs)."""
        shapes = self.noise_shapes(batch)
        if out is None:
            out = {k: torch.empty(s, device=generator.device)
                   for k, s in shapes.items()}
        for k in shapes:
            out[k].normal_(generator=generator)  # what torch.randn draws
        return out

    @staticmethod
    def lerp(psi, latent_avg, w):
        # latent_avg*(1-psi) + w*psi (`networks_stylegan.py:158-163`)
        return latent_avg[None, :] * (1.0 - psi) + w * psi

    def forward(self, z, noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None, quant=None,
                absmax: Optional[dict] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``noise`` maps ``"block_{res}.noise_{1|2}"`` to (N, H, W, 1) f32
        noise; any noise not given is drawn from ``generator``.  ``quant``:
        the int8 state (``ops/quant.py::quantize_generator``) or None for
        the float path; ``absmax``: a dict that records every synthesis
        conv input's absmax (calibration, float path)."""
        cfg, cd = self.cfg, self.compute_dtype
        noise = noise or {}
        w = self.mapping(z).float()
        y = self.constant_tensor.expand(
            z.shape[0], *self.constant_tensor.shape[1:]).to(cd)
        psi, avg = self.truncation_psi, self.latent_avg
        features = []
        for res in range(2, cfg.max_res_log2 + 1):
            i = 2 * (res - 2)
            w1 = self.lerp(psi[i], avg, w).to(cd)
            w2 = self.lerp(psi[i + 1], avg, w).to(cd)
            y = getattr(self, f"block_{res}")(
                y, w1, w2,
                (noise.get(f"block_{res}.noise_1"),
                 noise.get(f"block_{res}.noise_2")), generator, quant=quant,
                absmax=absmax, name=f"block_{res}")
            features.append(y)
        site = f"to_rgb_{cfg.max_res_log2}"
        record_absmax(absmax, site, y.to(cd))
        rgb = getattr(self, site)(y, None if quant is None
                                  else quant.get(site))
        return rgb, features


def init_generator(cfg: GanConfig, seed: int = 0,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> StyleGanGenerator:
    """A generator with seeded random init, on the CPU (the same weights
    whatever device it moves to)."""
    model = StyleGanGenerator(cfg, compute_dtype)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model
