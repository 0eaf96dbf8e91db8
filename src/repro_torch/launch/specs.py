"""Allocation-free stand-ins for every (arch x shape) cell — port of
``repro.launch.specs``.

Where the reference traces ``jax.ShapeDtypeStruct``s with
``jax.eval_shape``, the port builds the model on the ``meta`` device:
parameters, optimizer state and caches are tensors with shapes and dtypes
and no storage, so a full configuration (deepseek-v3-671b's 671e9
parameters) costs nothing to describe. The sharding rules run on them at
full size, and the dry run will lower its cells from them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.optim import adamw

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str             # train | prefill | decode


def cell(arch: str, shape: str) -> Cell:
    seq, batch, kind = registry.SHAPES[shape]
    return Cell(arch, shape, seq, batch, kind)


def all_cells() -> list[Cell]:
    out = []
    for arch in registry.ARCH_IDS:
        for shape in registry.shapes_for(arch):
            out.append(cell(arch, shape))
    return out


def _empty(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def model_inputs(cfg: ModelConfig, c: Cell) -> dict:
    """Batch stand-ins for train/prefill. Decode uses cache_specs."""
    b = {"tokens": _empty((c.global_batch, c.seq_len), torch.int32)}
    if cfg.cross_attn_every:
        b["vision"] = _empty((c.global_batch, cfg.n_vision_tokens,
                              cfg.d_model), torch.float32)
    if cfg.enc_dec:
        b["frames"] = _empty((c.global_batch, cfg.n_audio_frames,
                              cfg.d_model), torch.float32)
    return b


def build(cfg: ModelConfig) -> LM:
    """The LM of ``cfg`` on the meta device (no storage, no weights)."""
    return LM(cfg, device=META, seed=None)


def params_specs(model: LM) -> dict[str, torch.Tensor]:
    """``{name: meta tensor}`` of the model's parameters."""
    return {n: p.detach() for n, p in model.named_parameters()}


def opt_state_specs(opt_cfg: adamw.AdamWConfig, pspecs: dict
                    ) -> adamw.OptState:
    """``adamw.init``'s state of ``pspecs``, as meta tensors."""
    def zero_like(p):
        if not opt_cfg.quantized_state:
            return _empty(tuple(p.shape), torch.float32)
        q, s = adamw.qtensor_shapes(tuple(p.shape))
        return adamw.QTensor(_empty(q, torch.int8), _empty(s, torch.float32),
                             tuple(p.shape))
    return adamw.OptState(0, {k: zero_like(p) for k, p in pspecs.items()},
                          {k: zero_like(p) for k, p in pspecs.items()})


def cache_specs(model: LM, batch_size: int, max_len: int) -> dict:
    return model.init_cache(batch_size, max_len)


def decode_token_specs(c: Cell) -> torch.Tensor:
    return _empty((c.global_batch,), torch.int32)
