"""Configuration dataclasses, field for field the JAX package's.

A copy of ``gan_segmentation_tpu/core/config.py``: that module cannot be
imported without jax (``gan_segmentation_tpu/core/__init__.py`` imports the
mesh helpers), and the port runs where jax is absent.  ``tests/
test_torch_app.py`` pins every field and default of the two copies to each
other.  ``yaml`` is imported only by ``load_config_file``.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# max_res_log2 per GAN domain (`main.py:55`, `image_generator.py:11-12`)
MAX_RES_LOG2 = {"ffhq": 10, "cars": 9, "bedrooms": 8}


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """StyleGAN generator config (reference `image_generator.py:46-74`)."""

    max_res_log2: int = 10
    fmap_base: int = 8192
    fmap_decay: float = 1.0
    fmap_max: int = 512
    base_scale_x: int = 4
    base_scale_y: int = 4
    use_wscale: bool = True
    fix_noise: bool = False
    latent_size: int = 512
    channels: int = 3
    imrange: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "bf16"
    # mapping-net dense layers run with lr_mult 0.01 folded into the forward
    # weight scale (`image_generator.py:42`, `networks_stylegan.py:134-136`)
    mapping_lr_mult: float = 0.01
    # the JAX package's int8 XLA form-policy sizing; the port's int8 runs
    # its s8 kernels, which need no such policy (kept field for field)
    quant_batch_shards: int = 1
    # blur folded into the fused-upscale deconv in the JAX package (default
    # off there); the port refuses it
    fold_blur: bool = False

    def num_features(self, res_log2: int) -> int:
        # `networks_stylegan.py:114-116`
        fmaps = int(self.fmap_base / (2.0 ** ((res_log2 - 1) * self.fmap_decay)))
        return min(fmaps, self.fmap_max)

    @property
    def resolutions(self) -> List[int]:
        return [2 ** r for r in range(2, self.max_res_log2 + 1)]

    @property
    def feature_channels(self) -> List[int]:
        """ffhq (max_res_log2=10): [512,512,512,512,256,128,64,32,16]."""
        return [self.num_features(r) for r in range(2, self.max_res_log2 + 1)]

    @property
    def num_style_layers(self) -> int:
        # two AdaIN styles per block (`networks_stylegan.py:99`)
        return (self.max_res_log2 - 1) * 2


def gan_config(gan: str = "ffhq", dtype: str = "bf16") -> GanConfig:
    return GanConfig(max_res_log2=MAX_RES_LOG2[gan], dtype=dtype)


@dataclasses.dataclass
class SolverConfig:
    """Decoder solver config (reference `seg_solver.py:83-132`)."""

    max_res_log2: int = 10
    seed: int = 1
    kvstore: str = "nccl"
    cache_max_size: int = 4  # GB (`seg_solver.py:88`)
    device_cache: bool = True
    device_cache_gb: float = 8.0
    scan_epochs: Optional[bool] = None
    num_classes: int = 2
    not_ignore_classes: Optional[Sequence[int]] = None
    cls_type: str = "hair"
    train_epochs: int = 24
    base_lr: float = 1e-4
    factor_d: float = 0.1
    wd: float = 0.0
    optimizer: str = "adam"
    momentum: Optional[float] = None
    scheduler: Optional[str] = None
    preprocess_mask: bool = True
    train_display_iters: int = 4
    train_batch_size: int = 1
    val_batch_size: int = 1
    use_bn: bool = True
    use_sync_bn: bool = False
    use_dropout: bool = True
    start_res: int = 0
    dtype: str = "fp32"

    # decoder per-scale widths; truncated like `seg_solver.py:124-128`
    features: List[int] = dataclasses.field(default_factory=list)
    in_channels: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        base_features = [32, 32, 32, 32, 32, 32, 32, 32, 16]
        base_in_channels = [512, 512, 512, 512, 256, 128, 64, 32, 16]
        if not self.features:
            self.features = (
                base_features[: self.max_res_log2 - 1] + [self.num_classes]
            )
        if not self.in_channels:
            self.in_channels = base_in_channels[: self.max_res_log2 - 1]


@dataclasses.dataclass
class AppConfig:
    """Top-level ``config.yml`` (`config.yml.example`, read at `main.py:33-43`)."""

    BASE_DIR: str = "experiments/ffhq-hair"
    GAN: str = "ffhq"
    GAN_DIR: str = "stylegan-models"
    GAN_GPU_IDS: Sequence[int] = dataclasses.field(default_factory=lambda: [0])
    GAN_BATCH_SIZE_PER_GPU: int = 8
    SOLVER_GPU_IDS: Sequence[int] = dataclasses.field(default_factory=lambda: [0])
    ANNOTATION: str = "segmentation"
    GENERATE_NUM: int = 10000
    NO_GAN: bool = False
    IMGS_DIR: Optional[str] = None
    # override of the per-domain resolution table; None -> MAX_RES_LOG2[GAN]
    MAX_RES_LOG2: Optional[int] = None
    NUM_CLASSES: Optional[int] = None
    CLS_TYPE: Optional[str] = None
    NOT_IGNORE_CLASSES: Optional[Sequence[int]] = None
    PREPROCESS_MASK: Optional[bool] = None

    @property
    def max_res_log2(self) -> int:
        return self.MAX_RES_LOG2 or MAX_RES_LOG2[self.GAN]

    def solver_config(self) -> "SolverConfig":
        """The SolverConfig this app config implies."""
        num_classes = self.NUM_CLASSES or 2
        preprocess = (self.PREPROCESS_MASK if self.PREPROCESS_MASK is not None
                      else num_classes == 2)
        cfg = SolverConfig(
            max_res_log2=self.max_res_log2,
            num_classes=num_classes,
            preprocess_mask=preprocess,
            not_ignore_classes=(list(self.NOT_IGNORE_CLASSES)
                                if self.NOT_IGNORE_CLASSES else None),
        )
        if self.CLS_TYPE:
            cfg.cls_type = self.CLS_TYPE
        return cfg


def load_config_file(path: str) -> AppConfig:
    """yaml loader (`utils.py:112-115`); unknown keys are ignored."""
    import yaml

    with open(path, "r") as f:
        raw: Dict = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(AppConfig)}
    return AppConfig(**{k: v for k, v in raw.items() if k in fields})
